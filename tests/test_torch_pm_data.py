"""Packed PatchMatch data of the port (pack_pm_data, compute_patch_weights)
against the JAX package on the same host inputs: rtol 1e-5."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import make_case, port_data, to_numpy_dict  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch import densify  # noqa: E402
from openmvs_tpu_torch.geometry.camera import Camera  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402

torch.set_num_threads(1)


def _port_build(case, popts, usable=None):
    cam = lambda c: Camera(c.K, c.R, c.C)  # noqa: E731
    return densify._build_pm_data(
        case["ref"], cam(case["ref_cam"]), case["nbrs"],
        [cam(c) for c in case["nbr_cams"]], popts, 2.0, 10.0, case["prior"],
        case["nbr_depths"], usable=usable, device="cpu")


def _compare(a: dict, b: dict, prefix=""):
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, dict):
            _compare(va, vb, prefix + k + ".")
            continue
        vb = vb.numpy() if torch.is_tensor(vb) else np.asarray(vb)
        assert va.shape == vb.shape, (prefix + k, va.shape, vb.shape)
        if va.dtype == bool:
            assert (va == vb).mean() > 0.9999, prefix + k
        else:
            np.testing.assert_allclose(vb, va, rtol=1e-5, atol=1e-6,
                                       err_msg=prefix + k)


@pytest.mark.parametrize("geom,lowres", [(False, False), (True, True)])
def test_pack_pm_data_matches_jax(geom, lowres):
    data, _, _, popts, case = make_case(60, 80, 2, geom=geom, lowres=lowres)
    _compare(to_numpy_dict(data), _port_build(case, popts)._asdict()
             | {"views": _port_build(case, popts).views._asdict()})


def test_usable_mask_reaches_valid():
    data, _, _, popts, case = make_case(40, 56, 1)
    usable = np.ones((40, 56), bool)
    usable[10:20, 5:30] = False
    pd = _port_build(case, popts, usable=usable)
    from openmvs_tpu.densify import _build_pm_data
    from openmvs_tpu.config import DenseOptions
    jd = _build_pm_data(case["ref"], case["ref_cam"], case["nbrs"], case["nbr_cams"],
                        DenseOptions(sub_resolution_levels=0, estimation_iters=1),
                        2.0, 10.0, None, None, usable=usable)
    np.testing.assert_array_equal(pd.valid.numpy(), np.asarray(jd.valid))
    assert not pd.valid[10:20, 5:30].any()


@pytest.mark.parametrize("shape", [(30, 44), (61, 37)])
def test_compute_patch_weights_matches_jax(shape):
    from openmvs_tpu.config import DenseOptions
    from openmvs_tpu_torch.config import DenseOptions as PortOptions

    ref = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    ja = jpm.compute_patch_weights(jnp.asarray(ref), DenseOptions())
    tb = tpm.compute_patch_weights(torch.from_numpy(ref), PortOptions())
    for name, a, b in zip(("w", "wtm", "sum_w", "norm_sq0"), ja, tb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_convert_round_trip():
    """pm_data_from_numpy carries every field of the JAX PMData across."""
    data, _, _, _, _ = make_case(40, 56, 2, geom=True, lowres=True)
    pd = port_data(data)
    _compare(to_numpy_dict(data), pd._asdict() | {"views": pd.views._asdict()})
    assert pd.valid.dtype == torch.bool and pd.d_min.dtype == torch.float32
