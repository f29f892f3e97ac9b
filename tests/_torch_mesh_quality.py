"""The JAX package's figures for the port's whole chain (``chip_smoke.py``
phase ``pipeline``), on the CPU: the synthetic 5-view scene through
``dense_reconstruction(DenseOptions())``, ``reconstruct_mesh(MeshOptions())``,
``clean_mesh(decimate=0.5)``, ``refine_mesh(RefineOptions(scales=2,
iters=16))`` and ``texture_mesh(TextureOptions())`` on the scene with its
colors.

The figures are ``chip_smoke``'s own functions: the raw and the clean face
counts, ``_mesh_height_quality`` of the clean and the refined mesh (the
mean height error and the share of vertices within ``HEIGHT_TOL`` over the
height field's domain), and ``_color_fidelity`` of the textured mesh.
``chip_smoke.py`` holds the port's face counts within 5% of these, its
height error to at most 1.05x and its share to at least 0.98x, and its
color fidelity as phase ``texture`` does.

    JAX_PLATFORMS=cpu python tests/_torch_mesh_quality.py --height 480 --width 640
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
    a = ap.parse_args()

    import numpy as np

    from openmvs_tpu import mesh_ops
    from openmvs_tpu import texture as jt
    from openmvs_tpu.config import DenseOptions, MeshOptions, RefineOptions, TextureOptions
    from openmvs_tpu.densify import dense_reconstruction
    from openmvs_tpu.reconstruct import reconstruct_mesh
    from openmvs_tpu.refine import refine_mesh
    from openmvs_tpu_torch.synthetic import build_gt_scene

    from _torch_helpers import jax_scene
    from chip_smoke import FIDELITY_BOUND, _color_fidelity, _mesh_height_quality

    _, _, arrays = build_gt_scene(n_views=a.views, W=a.width, H=a.height, color=True)
    scene = jax_scene(dict(arrays, colors=None))
    colored = jax_scene(arrays)
    secs = {}
    t0 = time.perf_counter()
    pc = dense_reconstruction(scene, DenseOptions())
    secs["densify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = reconstruct_mesh(scene, MeshOptions(), pc=pc)
    secs["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clean = mesh_ops.clean_mesh(raw, decimate=0.5)
    secs["clean"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refined = refine_mesh(scene, clean, RefineOptions(scales=2, iters=16))
    secs["refine"] = time.perf_counter() - t0
    # texture_mesh returns no labels: keep the ones it hands generate_texture
    seen = {}
    generate = jt.generate_texture

    def keep_labels(scene, mesh, labels, *args, **kw):
        seen["labels"] = np.array(labels)
        return generate(scene, mesh, labels, *args, **kw)

    jt.generate_texture = keep_labels
    t0 = time.perf_counter()
    try:
        textured = jt.texture_mesh(colored, refined, TextureOptions())
    finally:
        jt.generate_texture = generate
    secs["texture"] = time.perf_counter() - t0
    fidelity, within = _color_fidelity(textured, seen["labels"], colored.images)
    q_clean = _mesh_height_quality(clean.vertices)
    q_refined = _mesh_height_quality(refined.vertices)
    print(json.dumps({"height": a.height, "width": a.width, "views": a.views,
                      "points": len(pc), "raw_faces": len(raw.faces),
                      "raw_vertices": len(raw.vertices),
                      "clean_faces": len(clean.faces),
                      "clean_height_error": q_clean[0], "clean_within": q_clean[1],
                      "clean_domain_vertices": q_clean[2],
                      "refined_height_error": q_refined[0],
                      "refined_within": q_refined[1],
                      "color_fidelity": fidelity,
                      f"faces_within_{FIDELITY_BOUND}": within,
                      "unseen_share": float((seen["labels"] < 0).mean()),
                      "seconds": secs}))


if __name__ == "__main__":
    main()
