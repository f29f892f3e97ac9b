"""How closely the JAX package agrees with itself, and the port with it, on
the slice test's scene (``tests/test_torch_estimate.py``,
``tests/test_torch_densify.py``).

PatchMatch turns a last-ulp difference into an argmin flip that spreads,
so two runs of the same algorithm agree only as far as their rounding
does. This script runs the JAX package's ``estimate_depth_map`` (one
photometric pass per view) and ``dense_reconstruction`` (final maps) on the
synthetic scene, again on the same scene with 10% of the pixels of every
image moved by one ulp, and the port on the CPU, and prints per view the
valid-mask agreement and the share of pixels valid in both whose depths
agree to 1e-3 relative, as one JSON line.

    JAX_PLATFORMS=cpu python tests/_torch_parity_floor.py
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
    from openmvs_tpu.io import dmap as jdmap
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.io import dmap as pdmap
    from openmvs_tpu_torch.synthetic import build_gt_scene

    from _torch_helpers import (SLICE_OPTS, SLICE_VIEWS, depth_agreement,
                                jax_scene)

    torch.set_num_threads(2)
    _, _, arrays = build_gt_scene(n_views=SLICE_VIEWS, W=160, H=120)
    rs = np.random.default_rng(0)
    nudged = dict(arrays, grays=[
        np.where(rs.random(g.shape) < 0.1, np.nextafter(g, np.float32(2)), g)
        .astype(np.float32) for g in arrays["grays"]])
    name = "depth{:04d}.dmap"

    def run_jax(arr):
        scene = jax_scene(arr)
        with tempfile.TemporaryDirectory() as d:
            pc = jd.dense_reconstruction(scene, JaxOptions(**SLICE_OPTS), save_dmaps_to=d)
            final = [jdmap.load(os.path.join(d, name.format(i))).depth
                     for i in range(SLICE_VIEWS)]
        one = [jd.estimate_depth_map(scene, i, JaxOptions(**SLICE_OPTS)).depth
               for i in range(SLICE_VIEWS)]
        return len(pc), one, final

    def run_port(arr):
        from openmvs_tpu_torch.convert import scene_from_arrays

        scene = scene_from_arrays(**arr)
        with tempfile.TemporaryDirectory() as d:
            pc = pdens.dense_reconstruction(scene, DenseOptions(**SLICE_OPTS),
                                            save_dmaps_to=d, device="cpu")
            final = [pdmap.load(os.path.join(d, name.format(i))).depth
                     for i in range(SLICE_VIEWS)]
        one = [pdens.estimate_depth_map(scene, i, DenseOptions(**SLICE_OPTS),
                                        device="cpu").depth
               for i in range(SLICE_VIEWS)]
        return len(pc), one, final

    ref, ulp, port = run_jax(arrays), run_jax(nudged), run_port(arrays)
    out = {"points": {"jax": ref[0], "jax_ulp": ulp[0], "port": port[0]}}
    for label, other in (("jax_vs_jax_ulp", ulp), ("port_vs_jax", port)):
        for k, stage in ((1, "one_pass"), (2, "final")):
            masks, pooled, per_view = depth_agreement(other[k], ref[k])
            out[f"{label}_{stage}"] = {"mask": masks, "depth_pooled": pooled,
                                       "depth_per_view": per_view}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
