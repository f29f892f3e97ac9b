"""The port's host key derivation and block hash against jax.random and the
JAX package's ``_block_uniform``: bit-exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 131, 7919 * 3 + 131 * 4 + 2, 1000 + 262, 2 ** 31 - 1]


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    kt = rng.prng_key(seed)
    assert _key(k) == kt
    for d in (0, 1, 2, 5, 131, 262, 264, 2 ** 31 + 5, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(k, np.uint32(d))) == rng.fold_in(kt, d)
    for n in (2, 5):
        assert [_key(s) for s in jax.random.split(k, n)] == list(rng.split(kt, n))
    # the chains the sweep schedule derives
    k2 = jax.random.fold_in(jax.random.fold_in(k, 3), 131 + 2)
    a, b, c, d, e = jax.random.split(k2, 5)
    assert [_key(x) for x in (a, b, c, d, e)] == list(
        rng.split(rng.fold_in(rng.fold_in(kt, 3), 133), 5))


@pytest.mark.parametrize("seed,fold", [(0, 1), (12345, 7), (2 ** 31 - 1, 262)])
def test_block_uniform_bit_identical(seed, fold):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    H, W = 45, 131   # not multiples of the 8-pixel block
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32) + 1000,
                         np.arange(H, dtype=np.float32) + 37)
    uv = np.stack([uu, vv], -1)
    for lo, hi in ((0.0, 1.0), (0.0, np.pi), (np.pi / 2, np.pi)):
        a = np.asarray(jpm._block_uniform(k, jnp.asarray(uv), lo, hi))
        b = rng.block_uniform(_key(k), torch.from_numpy(uv), lo, hi).numpy()
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


def test_random_fields_match_jax():
    """_random_depth / _random_normal built on the hash, against the JAX
    package's functions compiled as the sweep compiles them (XLA fuses
    their multiply-adds, which the port writes as fmas)."""
    from openmvs_tpu_torch.ops import patchmatch as tpm

    k = jax.random.PRNGKey(99)
    uu, vv = np.meshgrid(np.arange(40, dtype=np.float32), np.arange(24, dtype=np.float32))
    uv = np.stack([uu, vv], -1)
    X0 = np.stack([(uu - 20) / 36, (vv - 12) / 36, np.ones_like(uu)], -1).astype(np.float32)
    d_j = np.asarray(jax.jit(jpm._random_depth)(k, jnp.asarray(uv), jnp.float32(2.0),
                                                jnp.float32(10.0)))
    d_t = tpm._random_depth(_key(k), torch.from_numpy(uv), torch.tensor(2.0), torch.tensor(10.0))
    np.testing.assert_array_equal(d_j, d_t.numpy())
    n_j = np.asarray(jax.jit(jpm._random_normal)(k, jnp.asarray(uv), jnp.asarray(X0)))
    n_t = tpm._random_normal(_key(k), torch.from_numpy(uv), torch.from_numpy(X0)).numpy()
    # the port's sin/cos are correctly rounded, XLA's compiled ones are
    # within an ulp, so a product of two may differ by two ulps (of 1)
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=2 * 2.0 ** -23)


def test_argmin_ties_inf_and_nan_match_jax():
    """Candidate selection: argmin over a stack with inf ties and a NaN
    picks the same index in both libraries (first minimum; NaN wins)."""
    s = np.array([[np.inf, 1.0, np.inf, 0.5],
                  [np.inf, 1.0, np.nan, 0.5],
                  [np.inf, 2.0, 0.1, 0.25]], np.float32)
    a = np.asarray(jnp.argmin(jnp.asarray(s), axis=0))
    b = torch.argmin(torch.from_numpy(s), dim=0).numpy()
    np.testing.assert_array_equal(a, b)
    x = np.array([1.0, np.nan, 0.5], np.float32)
    y = np.array([0.7, 0.2, np.nan], np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.minimum(x, y)),
                                  torch.minimum(torch.from_numpy(x), torch.from_numpy(y)).numpy())
