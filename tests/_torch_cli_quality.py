"""The JAX package's CLI figures for ``chip_smoke.py`` phase ``files``, on
the CPU: the synthetic colored scene written as files
(``synthetic.write_scene_files``: 5 JPEGs of 1280x960 at quality 95 and
``scene.mvs``), then the JAX package's own CLI on them,

    python -m openmvs_tpu densify scene.mvs
    python -m openmvs_tpu mesh scene_dense.mvs --decimate 0.5 -o mesh.ply
    python -m openmvs_tpu refine scene_dense.mvs -m mesh.ply --scales 2 --iters 16 -o refined.ply
    python -m openmvs_tpu texture scene_dense.mvs -m refined.ply -o textured.obj

each through ``openmvs_tpu.__main__.main`` in this process. It prints the
sha256 of every JPEG (phase ``files`` prints the same for the card host's
encoder, so a difference between the two hosts' PIL shows) and one JSON
line: the seconds of each command, the dense points, the cloud's height
error (``chip_smoke._mesh_height_quality`` of the points), the raw faces
(the meshing log's "surface:" line), the clean faces, the clean and the
refined meshes' height error, and the textured mesh's color fidelity
(``chip_smoke._file_color_fidelity`` against the decoded JPEGs).

    JAX_PLATFORMS=cpu python tests/_torch_cli_quality.py [--folder DIR]
"""

import argparse
import json
import logging
import os
import re
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


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
    from openmvs_tpu.io.obj import load_mesh_obj
    from openmvs_tpu_torch.scene import Mesh, Scene
    from openmvs_tpu_torch.synthetic import write_scene_files

    from chip_smoke import FIDELITY_BOUND, _file_color_fidelity, _mesh_height_quality

    folder = a.folder or tempfile.mkdtemp()
    t0 = time.perf_counter()
    mvs, digests, _, _ = write_scene_files(folder, a.views, a.width, a.height)
    build_s = time.perf_counter() - t0
    for name, digest in sorted(digests.items()):
        print(f"sha256 {name} {digest}", flush=True)

    def path(name):
        return os.path.join(folder, name)

    msgs = _Messages()
    logging.getLogger("omvs.reconstruct").addHandler(msgs)
    commands = {
        "densify": ["densify", mvs],
        "mesh": ["mesh", path("scene_dense.mvs"), "--decimate", "0.5", "-o", path("mesh.ply")],
        "refine": ["refine", path("scene_dense.mvs"), "-m", path("mesh.ply"), "--scales", "2",
                   "--iters", "16", "-o", path("refined.ply")],
        "texture": ["texture", path("scene_dense.mvs"), "-m", path("refined.ply"),
                    "-o", path("textured.obj")],
    }
    secs = {}
    for name, argv in commands.items():
        t0 = time.perf_counter()
        jax_main(argv)
        secs[name] = time.perf_counter() - t0
    raw = [re.match(r"surface: (\d+) vertices, (\d+) faces", m) for m in msgs.messages]
    raw_faces = int([m for m in raw if m][-1].group(2))

    cloud = jply.load(path("scene_dense.ply")).vertices
    clean = jply.load(path("mesh.ply"))
    refined = jply.load(path("refined.ply"))
    v, f, tc, tex = load_mesh_obj(path("textured.obj"))
    textured = Mesh(vertices=v, faces=f, face_tex_coords=tc, texture=tex)
    scene = Scene.load(path("scene_dense.mvs"))
    for img in scene.images:
        img.load()
    fidelity, within = _file_color_fidelity(textured, scene.images)
    q_cloud = _mesh_height_quality(cloud)
    q_clean = _mesh_height_quality(clean.vertices)
    q_refined = _mesh_height_quality(refined.vertices)
    print(json.dumps({"views": a.views, "width": a.width, "height": a.height,
                      "jpeg_sha256": digests, "points": len(cloud),
                      "cloud_height_error": q_cloud[0], "cloud_within": q_cloud[1],
                      "cloud_domain_points": q_cloud[2],
                      "raw_faces": raw_faces, "clean_faces": len(clean.faces),
                      "clean_height_error": q_clean[0], "clean_within": q_clean[1],
                      "refined_height_error": q_refined[0],
                      "refined_within": q_refined[1],
                      "color_fidelity": fidelity,
                      f"faces_within_{FIDELITY_BOUND}": within,
                      "build_s": build_s, "seconds": secs, "folder": folder}))


if __name__ == "__main__":
    main()
