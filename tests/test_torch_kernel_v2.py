"""The port's K1-v2 (``pm_kernel.score_view_v2``) on CPU tensors, where it
runs K1's plain version, against the JAX package: the XLA scorer
``_score_one_view_scan`` (jitted as the sweep jits it) on the example of
``tests/test_torch_scorer.py``, and the dev script's Pallas
``score_view_v2`` (``scripts/dev_kernel_variants.py:282``) in interpret
mode on the script's own inputs, which the port copies
(``ops/kernel_variants.make_inputs``).

Tolerance: K1's, at least 99.9% of pixels within 1e-3 and none off by 1e-2
(test_pm_kernel.py:57-60). Against the Pallas variant only the pixels its
window keeps are compared: it invalidates a texel that leaves its window,
a TPU layout artefact the port's K1-v2 does not have.
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import example, inv_nd, port_data, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import kernel_variants  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel as tk  # noqa: E402

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "dev_kernel_variants.py"


def _load_script():
    """A fresh import of the dev script (so its jitted functions start with
    empty caches)."""
    spec = importlib.util.spec_from_file_location("dev_kernel_variants", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_k1(out, ref, valid):
    d = np.abs(out - ref)[valid]
    within = (d < 1e-3).mean()
    assert within >= 0.999 and d.max() < 1e-2, (within, d.max())


def test_make_inputs_is_the_scripts():
    mine = kernel_variants.make_inputs(C=2, H=32, W=256)
    theirs = _load_script().make_inputs(C=2, H=32, W=256)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("mode", ["exact", "nn"])
def test_v2_plain_matches_xla_scan(mode):
    data, opts, cd, cn = example()
    ind = inv_nd(cn, data.X0, cd)
    v = data.views
    ref = np.asarray(jax.jit(lambda *a: jpm._score_one_view_scan(
        data, opts, *a, exact=mode == "exact")[0])(
            cd, cn, ind, v.image[0], v.size[0], v.Hl[0], v.Hm[0]))
    pd = port_data(data)
    pv = pd.views
    out = tk.score_view_v2(pv.image[0], pv.size[0], pv.Hl[0], pv.Hm[0], t(cd),
                           t(cn), t(ind), pd.X0, pd.goff, pd.w, pd.wtm,
                           pd.sum_w, pd.norm_sq0, th_robust=float(opts.th_robust),
                           nearest=mode == "nn").numpy()
    _assert_k1(out, ref, np.asarray(cd) > 0)


def test_v2_plain_matches_pallas_v2_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    script = _load_script()
    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl)
                                    if not n.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(script, "pl", shim)
    ins = kernel_variants.make_inputs(C=2, H=32, W=256)
    import jax.numpy as jnp

    args = [jnp.asarray(ins[k]) for k in kernel_variants.ARG_ORDER]
    ref, kept = script.score_view_v2(*args, n_texels=25, th_robust=1.2, n_rows=24,
                                     n_cols=384, nearest=False, wide=False,
                                     rowgather="loop", tile_h=8)
    kept = np.asarray(kept)
    assert kept.mean() > 0.5, kept.mean()
    out = tk.score_view_v2(*kernel_variants.as_args(ins, "cpu"), th_robust=1.2)
    _assert_k1(out.numpy(), np.asarray(ref), kept)


def test_v2_window_share_is_the_kernels():
    """Only the kernel stages a window, so only it reports the share."""
    args = kernel_variants.as_args(kernel_variants.make_inputs(C=1, H=16, W=32), "cpu")
    with pytest.raises(ValueError, match="in_window"):
        tk.score_view_v2(*args, th_robust=1.2,
                         in_window=torch.zeros(1, 16, 32, dtype=torch.uint8))


def test_v2_operand_checks_raise_on_a_non_contiguous_image():
    args = list(kernel_variants.as_args(kernel_variants.make_inputs(C=1, H=16, W=32), "cpu"))
    args[0] = args[0].t().contiguous().t()
    assert not args[0].is_contiguous()
    with pytest.raises(ValueError, match="img: not contiguous"):
        tk.score_view_v2(*args, th_robust=1.2)


@pytest.mark.parametrize("width,pitch", [(32, 32), (30, 32), (33, 36)])
def test_v2_rows_are_pitched_for_tma(width, pitch):
    """TMA needs 16-byte row strides: the wrapper pads rows that are not a
    multiple of 4 floats long, in a copy with the same values."""
    img = torch.arange(3 * width, dtype=torch.float32).reshape(3, width)
    out, got = tk._pitched(img)
    assert got == pitch and out.shape == (3, pitch)
    assert torch.equal(out[:, :width], img)
    assert (out is img) == (width == pitch)
    # a misaligned base is copied too
    tail = torch.zeros(3 * 32 + 1)[1:].reshape(3, 32)
    assert tk._pitched(tail)[0] is not tail
