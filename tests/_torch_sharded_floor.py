"""How far the dense point count of ``dense_reconstruction(mesh=...)`` on
test_sharded_mixed.py's 3-view scene moves under a last-ulp change, in
the JAX package and in the port, at two sets of options.

The scene fuses about a thousand points, so a few argmin flips of
PatchMatch that survive the cross-view filter move the count by a few
percent. This script runs both packages sharded on (2, 2) CPU shards, on
the scene and again with 10% of the pixels of every image moved by one ulp
(``DRAWS`` draws), at the estimation test's options (``OPTS`` of
tests/test_torch_sharded.py) and at those of
tests/test_torch_sharded_misc.py::test_dense_reconstruction_on_a_mesh_matches_jax,
and prints the point counts, each count's relative distance from the JAX
package's on the unchanged scene, and each package's spread (the largest
count over the smallest, less one), as one JSON line.

    env -u PYTHONPATH JAX_PLATFORMS=cpu python tests/_torch_sharded_floor.py
"""

import copy
import json
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

DRAWS = 6
SETTINGS = {
    "OPTS": dict(sub_resolution_levels=1, estimation_iters=2, estimation_geometric_iters=1),
    "mesh_test": dict(sub_resolution_levels=0, estimation_iters=3,
                      estimation_geometric_iters=1),
}


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    os.environ["OMVS_NO_PALLAS"] = "1"
    import torch

    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.parallel import sharded as jsh
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.parallel import sharded

    from _torch_helpers import port_scene_from_jax
    from test_sharded_mixed import _mixed_scene

    torch.set_num_threads(2)

    def nudged(seed):
        scene = _mixed_scene()
        rs = np.random.default_rng(seed)
        for im in scene.images:
            g = im.gray
            im.gray = np.where(rs.random(g.shape) < 0.1, np.nextafter(g, np.float32(2)),
                               g).astype(np.float32)
        return scene

    scenes = {"base": _mixed_scene(),
              **{f"ulp{k}": nudged(k) for k in range(1, DRAWS + 1)}}
    out = {}
    for name, o in SETTINGS.items():
        counts = {}
        for label, jscene in scenes.items():
            counts[f"jax_{label}"] = len(jd.dense_reconstruction(
                copy.deepcopy(jscene), JaxOptions(**o), mesh=jsh.make_mesh(4)))
            counts[f"port_{label}"] = len(pdens.dense_reconstruction(
                port_scene_from_jax(jscene), DenseOptions(**o), device="cpu",
                mesh=sharded.make_mesh(4, devices=["cpu"] * 4)))
        ref = counts["jax_base"]
        spread = {pkg: max(v for k, v in counts.items() if k.startswith(pkg))
                  / min(v for k, v in counts.items() if k.startswith(pkg)) - 1
                  for pkg in ("jax", "port")}
        out[name] = {"points": counts, "spread": spread,
                     "rel_to_jax_base": {k: abs(v - ref) / ref for k, v in counts.items()}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
