"""How closely the JAX package agrees with itself, and the port with it, on
the import slice test's scene (``tests/test_torch_import_slice.py``): the
synthetic colored scene through a distorted OPENCV camera, written as an
ETH3D scene (3 JPEGs of 160x120, ``synthetic.write_eth3d_files``) and
loaded with ``datasets.load_eth3d_scene``, which undistorts the images.

The script densifies it with the slice tests' reduced schedule in the JAX
package, again with 10% of the pixels of every gray image moved by one ulp
(two draws of those pixels), and in the port on the CPU, and prints the
valid-mask agreement and the share of pixels valid in both whose depths
agree to 1e-3 relative (``_torch_helpers.depth_agreement``), per view and
pooled, as one JSON line.

    JAX_PLATFORMS=cpu python tests/_torch_import_floor.py
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

    from openmvs_tpu import datasets as jdatasets
    from openmvs_tpu import densify as jdensify
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu_torch import datasets, densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.io import dmap
    from openmvs_tpu_torch.synthetic import write_eth3d_files

    from _torch_helpers import SLICE_OPTS, depth_agreement

    torch.set_num_threads(2)
    folder = tempfile.mkdtemp()
    write_eth3d_files(folder, 3, 160, 120)

    def maps(load, dense, opts, nudge_seed=None, **kw):
        scene, _ = load(folder)
        for im in scene.images:
            im.load()
        if nudge_seed is not None:
            rs = np.random.default_rng(nudge_seed)
            for im in scene.images:
                g = im.gray
                im.gray = np.where(rs.random(g.shape) < 0.1, np.nextafter(g, np.float32(2)),
                                   g).astype(np.float32)
        with tempfile.TemporaryDirectory() as d:
            dense(scene, opts, save_dmaps_to=d, **kw)
            return [dmap.load(os.path.join(d, f"depth{i:04d}.dmap")).depth for i in range(3)]

    jax_opts = JaxOptions(**SLICE_OPTS)
    ref = maps(jdatasets.load_eth3d_scene, jdensify.dense_reconstruction, jax_opts)
    runs = {f"jax_vs_jax_ulp{s}": maps(jdatasets.load_eth3d_scene,
                                       jdensify.dense_reconstruction, jax_opts, s)
            for s in (0, 1)}
    runs["port_vs_jax"] = maps(datasets.load_eth3d_scene, densify.dense_reconstruction,
                               DenseOptions(**SLICE_OPTS), device="cpu")
    out = {}
    for label, other in runs.items():
        masks, pooled, per_view = depth_agreement(other, ref)
        out[label] = {"mask": masks, "depth_pooled": pooled, "depth_per_view": per_view}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
