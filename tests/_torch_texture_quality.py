"""Color fidelity that the JAX package's ``texture_mesh`` reaches on the
port's texture workload (``chip_smoke.py`` phase ``texture``), on the CPU:
the synthetic 5-view scene with colors, the height field's 320-grid
(203,522 faces), ``TextureOptions()``.

The figures are ``chip_smoke._color_fidelity``'s: per labelled face the
mean |atlas color - source color| at the face's centroid in its labelled
view, of which the median and the share of faces within
``chip_smoke.FIDELITY_BOUND``. ``chip_smoke.py`` holds the port's median to
at most 1.02x the JAX package's, and its share to at least 0.98x.
The port's ``texture_mesh`` then runs on the same scene on the CPU, and
the script prints its seconds per stage and its agreement with the JAX
package: equal labels, the largest texcoord difference, the share of equal
atlas texels and the largest texel difference.

    JAX_PLATFORMS=cpu python tests/_torch_texture_quality.py --height 480 --width 640
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
    ap.add_argument("--grid", type=int, default=320)
    a = ap.parse_args()

    import numpy as np

    from openmvs_tpu import texture as jt
    from openmvs_tpu.config import TextureOptions
    from openmvs_tpu.scene import Mesh
    from openmvs_tpu_torch import texture as pt
    from openmvs_tpu_torch.config import TextureOptions as PortOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene, height_field_mesh

    from _torch_helpers import jax_scene
    from chip_smoke import FIDELITY_BOUND, _color_fidelity

    port_scene, _, arrays = build_gt_scene(n_views=a.views, W=a.width, H=a.height,
                                           color=True)
    scene = jax_scene(arrays)
    gm = height_field_mesh(a.grid)
    # texture_mesh returns no labels: keep the ones it hands generate_texture
    seen = {}
    generate = jt.generate_texture

    def keep_labels(scene, mesh, labels, *args, **kw):
        seen["labels"] = np.array(labels)
        return generate(scene, mesh, labels, *args, **kw)

    jt.generate_texture = keep_labels
    t0 = time.perf_counter()
    try:
        out = jt.texture_mesh(scene, Mesh(vertices=gm.vertices.copy(),
                                          faces=gm.faces.copy()), TextureOptions())
    finally:
        jt.generate_texture = generate
    secs = time.perf_counter() - t0
    labels = seen["labels"]
    pages = out.textures if out.textures is not None else [out.texture]

    stats = {}
    t0 = time.perf_counter()
    port = pt.texture_mesh(port_scene, gm, PortOptions(), device="cpu", stats=stats)
    port_secs = time.perf_counter() - t0
    port_pages = port.textures if port.textures is not None else [port.texture]
    same_shapes = [p.shape for p in port_pages] == [p.shape for p in pages]
    diffs = [np.abs(p.astype(np.int16) - q.astype(np.int16))
             for p, q in zip(port_pages, pages)] if same_shapes else []
    fidelity, within = _color_fidelity(out, labels, scene.images)
    port_fidelity, port_within = _color_fidelity(port, stats["labels"], port_scene.images)
    print(json.dumps({"height": a.height, "width": a.width, "views": a.views,
                      "grid": a.grid, "faces": len(gm.faces),
                      "unseen_share": float((labels < 0).mean()),
                      "pages": len(pages), "atlas": list(pages[0].shape),
                      "color_fidelity": fidelity,
                      f"faces_within_{FIDELITY_BOUND}": within,
                      "seconds": secs,
                      "port_cpu": {
                          "seconds": port_secs, "stages_s": stats["stages_s"],
                          "patches": stats["patches"],
                          "color_fidelity": port_fidelity,
                          f"faces_within_{FIDELITY_BOUND}": port_within,
                          "labels_equal": bool(np.array_equal(stats["labels"], labels)),
                          "texcoord_max_abs_diff": float(np.abs(
                              port.face_tex_coords - out.face_tex_coords).max()),
                          "atlas_shapes_equal": same_shapes,
                          "texel_equal_share": (float(np.mean([(d == 0).mean() for d in diffs]))
                                                if diffs else None),
                          "texel_max_abs_diff": (int(max(d.max() for d in diffs))
                                                 if diffs else None)}}))


if __name__ == "__main__":
    main()
