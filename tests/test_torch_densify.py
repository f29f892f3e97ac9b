"""The slice as a whole: the port's ``dense_reconstruction`` (view
selection, photometric pass, geometric pass, speckle and gap filters,
cross-view filter, fusion) against the JAX package's on the synthetic scene
of ``openmvs_tpu_torch.synthetic`` (120x160, 3 views, one sub-resolution
level, 4 iterations, one geometric pass), fed to both from the same arrays.

Tolerance (``__graft_entry__.py:127-133``): valid masks agree on more than
99% of pixels and the dense point counts within 2%. Depths agree to 1e-3
relative on more than 98.5% of the pixels valid in both, pooled over the
views, where the JAX package's sharded-vs-serial check asks 99%: the JAX
package agrees with itself on only 0.990-0.993 of pixels per view in these
final maps when the images change by one ulp
(``tests/_torch_parity_floor.py``), as PatchMatch spreads last-ulp
differences through argmin flips over two passes and a cross-view filter,
and the port's transcendentals and rsqrt round differently from XLA's in
the last ulp (``utils/fmath.py``).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import (SLICE_OPTS, SLICE_VIEWS, depth_agreement,  # noqa: E402
                            slice_scenes)

from openmvs_tpu import densify as jd  # noqa: E402
from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.io import dmap as jdmap  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.io import dmap as pdmap  # noqa: E402

torch.set_num_threads(1)


def test_dense_reconstruction_matches_jax(tmp_path):
    scene, jscene = slice_scenes()
    pc = pdens.dense_reconstruction(scene, DenseOptions(**SLICE_OPTS),
                                    save_dmaps_to=str(tmp_path / "port"),
                                    device="cpu")
    jpc = jd.dense_reconstruction(jscene, JaxOptions(**SLICE_OPTS),
                                  save_dmaps_to=str(tmp_path / "jax"))
    name = "depth{:04d}.dmap"
    port = [pdmap.load(os.path.join(tmp_path / "port", name.format(i))).depth
            for i in range(SLICE_VIEWS)]
    ref = [jdmap.load(os.path.join(tmp_path / "jax", name.format(i))).depth
           for i in range(SLICE_VIEWS)]
    masks, pooled, per_view = depth_agreement(port, ref)
    msg = (f"points {len(pc)} vs {len(jpc)}, mask agreement {masks}, depth "
           f"agreement {pooled} (per view {per_view})")
    assert abs(len(pc) - len(jpc)) <= 0.02 * len(jpc), msg
    assert min(masks) > 0.99, msg
    assert pooled > 0.985, msg
    assert np.isfinite(pc.points).all() and len(pc) > 5000, msg
