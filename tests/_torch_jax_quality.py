"""Depth accuracy and completeness that the JAX package reaches on the
port's synthetic scene (``openmvs_tpu_torch.synthetic``), through its
serial ``dense_reconstruction`` with default options on the CPU.

``chip_smoke.py`` holds the port to at least 95% of these numbers.

    JAX_PLATFORMS=cpu python tests/_torch_jax_quality.py --height 480 --width 640
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--views", type=int, default=5)
    a = ap.parse_args()

    from openmvs_tpu.config import DenseOptions
    from openmvs_tpu.densify import dense_reconstruction
    from openmvs_tpu.io import dmap as dmapio
    from openmvs_tpu_torch.synthetic import build_gt_scene, depth_quality

    from _torch_helpers import jax_scene

    _, gts, arrays = build_gt_scene(n_views=a.views, W=a.width, H=a.height)
    scene = jax_scene(arrays)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pc = dense_reconstruction(scene, DenseOptions(), save_dmaps_to=tmp)
        acc, comp = [], []
        for i in range(a.views):
            d = dmapio.load(os.path.join(tmp, f"depth{i:04d}.dmap")).depth
            q = depth_quality(d, gts[i])
            acc.append(q[0])
            comp.append(q[1])
    print(json.dumps({"height": a.height, "width": a.width, "views": a.views,
                      "points": len(pc), "accuracy": acc,
                      "completeness": comp,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
