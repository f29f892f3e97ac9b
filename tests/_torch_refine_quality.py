"""Mean height error that the JAX package's ``refine_mesh`` reaches on the
port's refine workload (``chip_smoke.py`` phase ``refine``), on the CPU:
the synthetic 5-view scene, the height field's 150-grid (44,402 faces)
with z-noise N(0, 0.05) from ``default_rng(11)``, ``RefineOptions()``.

``chip_smoke.py`` holds the port to at most 1.05x the error printed here.

    JAX_PLATFORMS=cpu python tests/_torch_refine_quality.py --height 480 --width 640
"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--grid", type=int, default=150)
    a = ap.parse_args()

    from openmvs_tpu.config import RefineOptions
    from openmvs_tpu.refine import refine_mesh
    from openmvs_tpu.scene import Mesh
    from openmvs_tpu_torch.synthetic import build_gt_scene

    from _torch_helpers import jax_scene
    from chip_smoke import _height_error as height_error, _noisy_grid as noisy_grid

    _, _, arrays = build_gt_scene(n_views=a.views, W=a.width, H=a.height)
    scene = jax_scene(arrays)
    gt, v0 = noisy_grid(a.grid, 11)
    t0 = time.perf_counter()
    out = refine_mesh(scene, Mesh(vertices=v0, faces=gt.faces.copy()), RefineOptions())
    print(json.dumps({"height": a.height, "width": a.width, "views": a.views,
                      "grid": a.grid, "faces": len(gt.faces),
                      "refined_faces": len(out.faces),
                      "height_error_before": height_error(v0),
                      "height_error_after": height_error(out.vertices),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
