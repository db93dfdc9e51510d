"""The port's threefry2x32 streams against `jax.random` (legacy layout).

Every JAX call runs inside a scoped ``jax.threefry_partitionable(False)``
block: the reference's streams were pinned under the legacy counter
layout, and a global setting would change the JAX package's own tests.

Tolerances:
* raw bits, keys (`PRNGKey`, `split`, `fold_in`, `fold_col_keys`) and
  `uniform`: bitwise;
* `erfinv_f32` over all 2^23 inputs `normal` can feed it: <= 2 ulp (the
  port follows XLA's polynomial, but XLA's compiled CPU code contracts
  its multiply-adds into FMAs and has its own log1p);
* `normal`: <= 3 ulp (the 2-ulp erfinv gap, times sqrt(2) in float32,
  can round to 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import key_from_numpy
from repro_torch.core import rng as trng


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b))) if a.size else 0


def _tk(k) -> torch.Tensor:
    return key_from_numpy(np.asarray(k), device="cpu")


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_prng_key_split_fold_in_bitwise(seed):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        tk = trng.PRNGKey(seed, device="cpu")
        np.testing.assert_array_equal(np.asarray(k), tk.numpy())
        for num in (2, 3, 5):
            want = np.asarray(jax.random.split(k, num))
            got = torch.stack(trng.split(tk, num)).numpy()
            np.testing.assert_array_equal(want, got)
        for data in (0, 1, 7, 123456, 2**31 - 1):
            np.testing.assert_array_equal(
                np.asarray(jax.random.fold_in(k, data)),
                trng.fold_in(tk, data).numpy(),
            )


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (4, 1, 1), (6, 1, 16), (2, 33)])
def test_bits_and_uniform_bitwise_single_key(shape):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(11)
        want_bits = np.asarray(jax.random.bits(k, shape))
        want_u = np.asarray(jax.random.uniform(k, shape))
    tk = trng.PRNGKey(11, device="cpu")
    np.testing.assert_array_equal(want_bits, trng.random_bits(tk, shape).numpy())
    np.testing.assert_array_equal(want_u, trng.uniform(tk, shape).numpy())


def test_key_batch_matches_vmap():
    ids = np.arange(9, dtype=np.int32) * 37 + 100
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(3)
        kb = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(ids))
        want_split = np.asarray(jax.vmap(lambda kk: jax.random.split(kk, 3))(kb))
        want_fold = np.asarray(jax.vmap(lambda kk: jax.random.fold_in(kk, 5))(kb))
        want_bits = np.asarray(jax.vmap(lambda kk: jax.random.bits(kk, (1, 16)))(kb))
        want_u = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (3,)))(kb))
        want_n = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (1, 16)))(kb))
        want_n1 = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (1, 1)))(kb))
    tkb = trng.fold_col_keys(_tk(k), torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(kb), tkb.numpy())
    np.testing.assert_array_equal(want_split, torch.stack(trng.split(tkb, 3), 1).numpy())
    np.testing.assert_array_equal(want_fold, trng.fold_in(tkb, 5).numpy())
    np.testing.assert_array_equal(want_bits, trng.random_bits(tkb, (9, 1, 16)).numpy())
    np.testing.assert_array_equal(want_u, trng.uniform(tkb, (9, 3)).numpy())
    assert _ulp(want_n, trng.normal(tkb, (9, 1, 16)).numpy()) <= 3
    assert _ulp(want_n1, trng.normal(tkb, (9, 1, 1)).numpy()) <= 3


@pytest.mark.parametrize("shape", [(5,), (64, 32), (12, 1, 16)])
def test_normal_within_3_ulp(shape):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(5)
        want = np.asarray(jax.random.normal(k, shape))
    got = trng.normal(trng.PRNGKey(5, device="cpu"), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert _ulp(want, got) <= 3


def test_erfinv_over_all_mantissas_within_2_ulp():
    """Every u that `normal` can draw: one per 23-bit mantissa."""
    m = np.arange(1 << 23, dtype=np.uint32)
    f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * (np.float32(1.0) - lo) + lo).astype(np.float32)
    want = np.asarray(jax.jit(jax.scipy.special.erfinv)(jnp.asarray(u)))
    got = trng.erfinv_f32(torch.from_numpy(u)).numpy()
    assert _ulp(want, got) <= 2
    # torch.erfinv rounds differently: the port must not use it.
    assert _ulp(want, torch.erfinv(torch.from_numpy(u)).numpy()) > 2


def test_erfinv_tail_sqrt_correctly_rounded():
    """The tail branch's square root is the correctly rounded float32 one
    (XLA's), for every w >= 5 that `normal` can feed erf^-1: on the CPU
    the port does not trust PyTorch's vectorized `sqrt`, whose first call
    after a `log1p` can run a chunk of it at about 3e-4 accuracy."""
    m = np.arange(1 << 23, dtype=np.uint32)
    f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    x = torch.from_numpy(np.maximum(lo, f * (np.float32(1.0) - lo) + lo))
    w = -torch.log1p(x * -x)
    w = w[torch.isfinite(w) & (w >= 5.0)]
    assert w.numel() > 1000
    want = np.sqrt(w.numpy())
    np.testing.assert_array_equal(trng._sqrt_f32(w).numpy(), want)
    np.testing.assert_array_equal(trng._sqrt_f32(torch.tensor([0.0, 4.0, float("inf")])).numpy(),
                                  np.array([0.0, 2.0, np.inf], np.float32))
