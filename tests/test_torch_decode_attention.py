"""deepspeed_tpu_torch decode attention vs the JAX package.

The port's plain decode attention (what its wrapper runs for CPU tensors;
the CUDA kernel is held against it on the card by chip_smoke.py) is
compared with the JAX Pallas ``_decode_kernel`` in interpret mode and
with ``decode_attention_xla``, on the same seeded numpy inputs.

Tolerance: fp32 <= 1e-5 abs — both sides accumulate in fp32 (the Pallas
kernel runs its fp32 products at HIGHEST precision); only the summation
order differs.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import deepspeed_tpu.ops.pallas.decode_attention as da_jax
from deepspeed_tpu_torch.ops.kernels import decode_attention as da

ATOL = 1e-5


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, H, KV, hd, S_max, lens, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S_max, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S_max, KV, hd), dtype=np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _port(q, k, v, lens):
    return da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lens)).numpy()


# MHA and GQA (H=8 over KV=2); head dims 8 and 24 (24 is not a power of
# two); S_max 37 has no multiple-of-8 divisor (the Pallas launcher pads
# it), ragged lengths include 1 and S_max
CASES = [
    (3, 4, 4, 8, 37, [1, 37, 20]),
    (3, 8, 2, 24, 37, [37, 1, 9]),
    (2, 8, 2, 8, 64, [64, 33]),
    (4, 4, 4, 24, 29, [29, 1, 2, 17]),
]


@pytest.mark.parametrize("B,H,KV,hd,S_max,lens", CASES)
def test_plain_matches_pallas_interpret(interpret_pallas, B, H, KV, hd,
                                        S_max, lens):
    q, k, v, L = _inputs(B, H, KV, hd, S_max, lens, seed=B * 100 + hd)
    ref = np.asarray(da_jax.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L)))
    np.testing.assert_allclose(_port(q, k, v, L), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,H,KV,hd,S_max,lens", CASES)
def test_plain_matches_xla_reference(B, H, KV, hd, S_max, lens):
    q, k, v, L = _inputs(B, H, KV, hd, S_max, lens, seed=B * 7 + hd)
    ref = np.asarray(da_jax.decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L)))
    np.testing.assert_allclose(_port(q, k, v, L), ref, atol=ATOL, rtol=0)


def test_empty_row_returns_zeros_like_the_kernel(interpret_pallas):
    """cache_len 0: the Pallas kernel's max(l, 1e-30) gives zeros; the
    port's plain version (and its CUDA kernel) must too."""
    q, k, v, L = _inputs(2, 4, 2, 8, 16, [0, 16], seed=3)
    ref = np.asarray(da_jax.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L)))
    out = _port(q, k, v, L)
    np.testing.assert_array_equal(out[0], np.zeros_like(out[0]))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_sm_scale_override_matches_xla():
    q, k, v, L = _inputs(2, 4, 4, 8, 16, [5, 16], seed=4)
    ref = np.asarray(da_jax.decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L),
        sm_scale=1.0))
    out = da.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(L), sm_scale=1.0).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
