"""How closely the sharded cross-view filter meets the host filter on
small estimated maps, in the port and in the JAX package.

The sharded filter (``parallel/sharded_filter.py`` in both packages)
projects in float32: with the synthetic scene's axis-aligned cameras an
integer source row lands just below the row about half the time, where
the host filter's float64 lands on it, so a neighbouring source pixel
wins the z-buffer. At 120x160 neighbouring depths differ enough for that
to move the averaged depth by more than 1e-3 on a few percent of pixels.
This script estimates the synthetic scene's 5 views at 120x160 with the
port on the CPU, filters the maps with the port's and the JAX package's
sharded filters on (2, 2) CPU shards and with the host filter, and prints
per view the valid-mask agreement with the host filter, the share of
depths within 1e-3 relative of it, and the share of pixels where the two
sharded filters agree bit for bit, as one JSON line.

    env -u PYTHONPATH JAX_PLATFORMS=cpu python tests/_torch_filter_floor.py
"""

import json
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    import jax
    from jax.sharding import Mesh

    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.densify import DepthMapResult as JaxResult
    from openmvs_tpu.geometry.camera import Camera as JaxCamera
    from openmvs_tpu.parallel.sharded_filter import filter_views_sharded as jax_filter
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.parallel import sharded
    from openmvs_tpu_torch.parallel.sharded_filter import filter_views_sharded
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    _, _, arrays = build_gt_scene(n_views=5, W=160, H=120)
    scene = scene_from_arrays(**arrays)
    opts = DenseOptions(sub_resolution_levels=1, estimation_iters=3)
    select_views_for_scene(scene, opts)
    maps = {scene.images[i].meta.id: densify.estimate_depth_map(scene, i, opts, device="cpu")
            for i in range(len(scene.images))}
    fopts = DenseOptions()
    host = densify._filter_views(maps, set(), fopts)
    port = filter_views_sharded(maps, fopts, sharded.make_mesh(4, devices=["cpu"] * 4))
    jmaps = {k: JaxResult(image_idx=r.image_idx, depth=r.depth, normal=r.normal, conf=r.conf,
                          d_min=r.d_min, d_max=r.d_max, neighbor_ids=r.neighbor_ids,
                          camera=JaxCamera(r.camera.K, r.camera.R, r.camera.C))
             for k, r in maps.items()}
    jmesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("views", "tile"))
    jax_out = jax_filter(jmaps, JaxOptions(), jmesh)

    def vs_host(out):
        masks, depths = [], []
        for k, h in host.items():
            a, b = out[k].depth, h.depth
            both = (a > 0) & (b > 0)
            masks.append(float(((a > 0) == (b > 0)).mean()))
            depths.append(float((np.abs(a - b)[both] < 1e-3 * b[both]).mean()))
        return masks, depths

    pm, pd = vs_host(port)
    jm, jd = vs_host(jax_out)
    print(json.dumps({"views": len(maps), "H": 120, "W": 160,
                      "port_mask": pm, "port_depth_1e-3": pd,
                      "jax_mask": jm, "jax_depth_1e-3": jd,
                      "port_equal_jax": [float((port[k].depth == jax_out[k].depth).mean())
                                         for k in maps]}))


if __name__ == "__main__":
    main()
