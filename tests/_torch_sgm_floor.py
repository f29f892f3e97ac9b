"""How closely the JAX package's SGM agrees with itself, and the port with
it, on the SGM slice test's scene (``tests/test_torch_sgm.py``).

The DP carries a cost that one rounding moved by 1 along eight scanlines,
and the sub-pixel fits turn cost ulps into disparity ulps, so two runs of
the same algorithm agree only as far as their rounding does. This script
runs the JAX package's ``estimate_depth_map_sgm`` for every view of the
synthetic scene (each pair's disparities cached as ``.dimap``), again on
the same scene with 10% of the pixels of every image moved by one ulp,
and the port on the CPU, and prints per pair the share of pixels whose
disparity agrees (both invalid, or both valid within 1e-3 px), as one
JSON line.

    JAX_PLATFORMS=cpu python tests/_torch_sgm_floor.py
"""

import json
import os
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


def main():
    import torch

    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.view_selection import select_views_for_scene
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.view_selection import select_views_for_scene as port_select

    from _torch_helpers import (SGM_VIEWS, disparity_agreement, jax_scene,
                                pair_disparities)

    torch.set_num_threads(2)
    _, _, arrays = build_gt_scene(n_views=SGM_VIEWS, W=160, H=120)
    rs = np.random.default_rng(0)
    nudged = dict(arrays, grays=[
        np.where(rs.random(g.shape) < 0.1, np.nextafter(g, np.float32(2)), g)
        .astype(np.float32) for g in arrays["grays"]])

    def run_jax(arr, folder):
        scene = jax_scene(arr)
        opts = JaxOptions(estimator="sgm")
        select_views_for_scene(scene, opts)
        for i in range(len(scene.images)):
            jd.estimate_depth_map_sgm(scene, i, opts, dimap_dir=folder)
        return pair_disparities(folder)

    def run_port(arr, folder):
        scene = scene_from_arrays(**arr)
        opts = DenseOptions(estimator="sgm")
        port_select(scene, opts)
        for i in range(len(scene.images)):
            pdens.estimate_depth_map_sgm(scene, i, opts, dimap_dir=folder, device="cpu")
        return pair_disparities(folder)

    with tempfile.TemporaryDirectory() as d0, tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref, ulp, port = run_jax(arrays, d0), run_jax(nudged, d1), run_port(arrays, d2)
    out = {"pairs": sorted(ref)}
    for label, other in (("jax_vs_jax_ulp", ulp), ("port_vs_jax", port)):
        out[label] = [disparity_agreement(other[k], ref[k]) for k in sorted(ref)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
