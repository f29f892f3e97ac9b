"""Depth accuracy and completeness that the JAX package's SGM estimator
reaches on the port's synthetic scene (``openmvs_tpu_torch.synthetic``),
through its serial ``dense_reconstruction`` with
``DenseOptions(estimator="sgm")`` on the CPU.

``chip_smoke.py`` (phase ``sgm``) holds the port to at least 95% of these
numbers. With ``--port`` the port's CPU run on the same scene is printed
beside them.

    JAX_PLATFORMS=cpu python tests/_torch_sgm_quality.py --height 480 --width 640
"""

import argparse
import json
import os
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


def _maps_quality(folder, gts):
    from openmvs_tpu_torch.io import dmap as dmapio
    from openmvs_tpu_torch.synthetic import depth_quality

    q = [depth_quality(dmapio.load(os.path.join(folder, f"depth{i:04d}.dmap")).depth, gt)
         for i, gt in enumerate(gts)]
    return [a for a, _ in q], [c for _, c in q]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU on the same scene")
    a = ap.parse_args()

    from openmvs_tpu.config import DenseOptions
    from openmvs_tpu.densify import dense_reconstruction
    from openmvs_tpu_torch.synthetic import build_gt_scene

    from _torch_helpers import jax_scene

    _, gts, arrays = build_gt_scene(n_views=a.views, W=a.width, H=a.height)
    out = {"height": a.height, "width": a.width, "views": a.views}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pc = dense_reconstruction(jax_scene(arrays), DenseOptions(estimator="sgm"),
                                  save_dmaps_to=tmp)
        out["points"] = len(pc)
        out["accuracy"], out["completeness"] = _maps_quality(tmp, gts)
    out["seconds"] = time.perf_counter() - t0
    if a.port:
        import torch

        from openmvs_tpu_torch import densify
        from openmvs_tpu_torch.config import DenseOptions as PortOptions
        from openmvs_tpu_torch.convert import scene_from_arrays

        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            pc = densify.dense_reconstruction(
                scene_from_arrays(**arrays), PortOptions(estimator="sgm"),
                save_dmaps_to=tmp, device="cpu")
            acc, comp = _maps_quality(tmp, gts)
        out["port"] = {"points": len(pc), "accuracy": acc, "completeness": comp,
                       "seconds": time.perf_counter() - t0}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
