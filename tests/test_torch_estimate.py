"""The port's ``estimate_depth_map`` (one photometric pass: sparse seeds, a
two-level pyramid of checkerboard PatchMatch sweeps, finalize) against the
JAX package's on the synthetic scene of ``openmvs_tpu_torch.synthetic``
(120x160, 3 views), fed to both from the same arrays.

Tolerance (``__graft_entry__.py:127-133``): valid masks agree on more than
99% of pixels, and depths to 1e-3 relative on more than 99% of the pixels
valid in both, pooled over the views. The port repeats the JAX package's
float32 rounding where XLA's is known (``utils/fmath.py``); its
transcendentals and rsqrt are correctly rounded where XLA's are within an
ulp, and PatchMatch spreads such differences through argmin flips. The JAX
package agrees with itself on 0.991-0.997 of pixels per view when the
images change by one ulp (``tests/_torch_parity_floor.py``).
"""

import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import (SLICE_OPTS, SLICE_VIEWS, depth_agreement,  # noqa: E402
                            slice_scenes)

from openmvs_tpu import densify as jd  # noqa: E402
from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.view_selection import select_views_for_scene as jax_select  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.view_selection import select_views_for_scene  # noqa: E402

torch.set_num_threads(1)


def test_estimate_depth_map_matches_jax():
    scene, jscene = slice_scenes()
    opts, jopts = DenseOptions(**SLICE_OPTS), JaxOptions(**SLICE_OPTS)
    select_views_for_scene(scene, opts)
    jax_select(jscene, jopts)
    assert ([[v.id for v in im.meta.view_scores] for im in scene.images]
            == [[v.id for v in im.meta.view_scores] for im in jscene.images])
    port = [pdens.estimate_depth_map(scene, i, opts, device="cpu").depth
            for i in range(SLICE_VIEWS)]
    ref = [jd.estimate_depth_map(jscene, i, jopts).depth for i in range(SLICE_VIEWS)]
    masks, pooled, per_view = depth_agreement(port, ref)
    msg = f"mask agreement {masks}, depth agreement {pooled} (per view {per_view})"
    assert min(masks) > 0.99, msg
    assert pooled > 0.99, msg
