"""The JAX package's figures for ``chip_smoke.py`` phase ``imports``, on the
CPU: the synthetic colored scene seen through a distorted OPENCV camera and
written as an ETH3D training scene (``synthetic.write_eth3d_files``: 5
JPEGs of 1280x960 at quality 95, the COLMAP text calibration in
``dslr_calibration_jpg/``, ground truth in ``scan_clean/scan.ply``), then
the JAX package's own CLI on it, each command through
``openmvs_tpu.__main__.main`` in this process:

    import-colmap eth3d/dslr_calibration_jpg -i eth3d -o scene.mvs   (undistorts)
    densify scene.mvs
    eval --dataset eth3d --scene eth3d --run
    eval --dataset eth3d --scene eth3d --est scene_dense.ply
    transform --matrix, then --align-file back; --max-resolution 640;
        --mesh-file height_field.ply --compute-volume
    densify scene_dense.mvs --split-max-points 100000

(the last four through ``chip_smoke._host_steps``, which phase ``imports``
runs with the port's CLI). It prints the sha256 of every image written and
undistorted, and one JSON line: the seconds of each step, the dense points,
the cloud's height error (``chip_smoke._mesh_height_quality``), the F-scores
of both evals, the align round trip's error, the rescaled images' sha256,
the volume, and each chunk's points and views.

    JAX_PLATFORMS=cpu python tests/_torch_import_quality.py [--folder DIR]
"""

import argparse
import json
import os
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--folder", default="", help="where to write the files "
                    "(default: a temporary directory)")
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    a = ap.parse_args()

    from openmvs_tpu.__main__ import main as jax_main
    from openmvs_tpu.io import ply as jply
    from openmvs_tpu_torch.synthetic import write_eth3d_files

    from chip_smoke import _fscores, _host_steps, _mesh_height_quality, _quiet, _sha256

    folder = a.folder or tempfile.mkdtemp()
    scene_dir = os.path.join(folder, "eth3d")
    work = os.path.join(folder, "work")
    os.makedirs(work, exist_ok=True)
    secs = {}
    t0 = time.perf_counter()
    digests, _ = write_eth3d_files(scene_dir, a.views, a.width, a.height)
    secs["build"] = time.perf_counter() - t0
    for name, digest in sorted(digests.items()):
        print(f"sha256 {name} {digest}", flush=True)

    calib = os.path.join(scene_dir, "dslr_calibration_jpg")
    mvs = os.path.join(work, "scene.mvs")
    secs["import"], _ = _quiet(jax_main, ["import-colmap", calib, "-i", scene_dir, "-o", mvs])
    und_dir = os.path.join(calib, "undistorted")
    undistorted = {n: _sha256(os.path.join(und_dir, n)) for n in sorted(os.listdir(und_dir))}
    for name, digest in undistorted.items():
        print(f"sha256 undistorted/{name} {digest}", flush=True)
    secs["densify"], _ = _quiet(jax_main, ["densify", mvs])
    dense_mvs = os.path.join(work, "scene_dense.mvs")
    cloud = jply.load(dense_mvs.replace(".mvs", ".ply")).vertices
    q_cloud = _mesh_height_quality(cloud)
    secs["eval_run"], _ = _quiet(jax_main, ["eval", "--dataset", "eth3d", "--scene", scene_dir,
                                            "--run", "-o", os.path.join(work, "eval_run.json")])
    run_f, run_res = _fscores(os.path.join(work, "eval_run.json"))
    host, host_s = _host_steps(jax_main, scene_dir, dense_mvs, work)
    secs.update(host_s)
    print(json.dumps({"views": a.views, "width": a.width, "height": a.height,
                      "jpeg_sha256": digests, "undistorted_sha256": undistorted,
                      "points": len(cloud), "cloud_height_error": q_cloud[0],
                      "cloud_within": q_cloud[1], "cloud_domain_points": q_cloud[2],
                      "run_fscores": run_f, "run_points": run_res["n_est_points"],
                      "gt_points": run_res["n_gt_points"], **host,
                      "seconds": secs, "folder": folder}))


if __name__ == "__main__":
    main()
