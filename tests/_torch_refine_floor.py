"""How far refinement's result moves under changes of rounding alone, on
the slice case of tests/test_torch_refine.py (3 views at 160x120, the
22-grid with z-noise N(0, 0.05), RefineOptions(scales=2, iters=8,
max_face_area=64)): the largest per-vertex difference between

* the JAX package unbucketed and bucketed (its own reduction-order
  change, the check of test_refine_e2e.py),
* the JAX package on images moved by one ulp, and on vertices moved by
  one ulp,
* the port on the CPU on vertices moved by one ulp,
* the port and the JAX package (the slice test's comparison).

    JAX_PLATFORMS=cpu python tests/_torch_refine_floor.py
"""

import json
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

OPTS = dict(scales=2, iters=8, max_face_area=64)


def main():
    import openmvs_tpu.refine as jr
    from openmvs_tpu.config import RefineOptions as JaxOptions
    from openmvs_tpu.scene import Mesh as JaxMesh
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.refine import refine_mesh
    from openmvs_tpu_torch.synthetic import build_gt_scene, height_field_mesh

    from _torch_helpers import jax_scene

    scene, _, arrays = build_gt_scene(n_views=3, W=160, H=120)
    gt = height_field_mesh(22)
    v0 = gt.vertices.copy()
    v0[:, 2] += np.random.default_rng(7).normal(0, 0.05, len(v0)).astype(np.float32)
    up = np.float32(10)

    def jax_run(v, bucket=False, ulp_images=False):
        a = dict(arrays)
        if ulp_images:
            a["grays"] = [np.nextafter(g, np.float32(2)) for g in arrays["grays"]]
        if bucket:
            os.environ.pop("OMVS_REFINE_NO_BUCKET", None)
        else:
            os.environ["OMVS_REFINE_NO_BUCKET"] = "1"
        m = jr.refine_mesh(jax_scene(a), JaxMesh(vertices=v.copy(), faces=gt.faces.copy()),
                           JaxOptions(**OPTS))
        return np.asarray(m.vertices)

    def port_run(v):
        return refine_mesh(scene, mesh_from_numpy(v, gt.faces), RefineOptions(**OPTS),
                           device="cpu").vertices

    def worst(a, b):
        return float(np.abs(a - b).max())

    base = jax_run(v0)
    port = port_run(v0)
    print(json.dumps({
        "jax_bucketed_vs_unbucketed": worst(jax_run(v0, bucket=True), base),
        "jax_images_one_ulp": worst(jax_run(v0, ulp_images=True), base),
        "jax_vertices_one_ulp": worst(jax_run(np.nextafter(v0, up)), base),
        "port_vertices_one_ulp": worst(port_run(np.nextafter(v0, up)), port),
        "port_vs_jax": worst(port, base)}))


if __name__ == "__main__":
    main()
