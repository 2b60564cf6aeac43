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


# ------------------------------------------- the ALiBi and windowed forms
from deepspeed_tpu.models.bloom import alibi_slopes as jax_alibi_slopes

#: MHA at head_dim 64, GQA rep 3 over a head count that is no power of two
#: (12: the second ALiBi slope series) at 64, and GQA rep 4 at 128
VARIANT_CASES = [
    (3, 4, 4, 64, 40, [1, 40, 23]),
    (2, 12, 4, 64, 33, [33, 9]),
    (3, 8, 2, 128, 40, [40, 5, 17]),
]
WINDOW = 8
POISON = 1e3


def _variant_inputs(B, H, KV, hd, S_max, lens, variant, int8_cache, seed):
    """Seeded inputs of one variant: ALiBi slopes [H] as BLOOM makes them,
    or per-row floors (lens - WINDOW, at least 0; the last row floored at
    0) with every position below a row's floor poisoned with large values,
    so that a kernel reading one of them cannot pass."""
    q, k, v, L = _inputs(B, H, KV, hd, S_max, lens, seed)
    extra = {}
    if variant == "alibi":
        extra["alibi_slopes"] = np.asarray(jax_alibi_slopes(H), np.float32)
    else:
        floors = np.maximum(L - WINDOW, 0).astype(np.int32)
        floors[-1] = 0
        for b, f in enumerate(floors):
            k[b, :f] = POISON
            v[b, :f] = -POISON
        extra["min_pos"] = floors
    if int8_cache:
        kq, ks = (np.asarray(a) for a in da_jax.quantize_kv(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in da_jax.quantize_kv(jnp.asarray(v)))
        k, v = kq, vq
        extra.update(k_scale=ks, v_scale=vs)
    return q, k, v, L, extra


@pytest.mark.parametrize("int8_cache", [False, True])
@pytest.mark.parametrize("variant", ["alibi", "windowed"])
@pytest.mark.parametrize("B,H,KV,hd,S_max,lens", VARIANT_CASES)
def test_variants_match_pallas_interpret_and_xla(interpret_pallas, B, H, KV,
                                                 hd, S_max, lens, variant,
                                                 int8_cache):
    """The ALiBi and windowed forms (the Pallas kernel's ``alibi`` and
    ``windowed`` variants), each over a float and an int8 cache."""
    q, k, v, L, extra = _variant_inputs(B, H, KV, hd, S_max, lens, variant,
                                        int8_cache, seed=B * 31 + hd)
    jx = {n: jnp.asarray(a) for n, a in extra.items()}
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L))
    kern = np.asarray(da_jax.decode_attention_pallas(*args, **jx))
    ref = np.asarray(da_jax.decode_attention_xla(*args, **jx))
    out = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(L),
        **{n: torch.from_numpy(a) for n, a in extra.items()}).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_window_floor_at_the_length_returns_zeros(interpret_pallas):
    """A row whose floor is at or past its length attends nothing and
    returns zeros, as the Pallas kernel does; a floor of 0 is the plain
    causal form."""
    q, k, v, L = _inputs(3, 4, 2, 64, 16, [5, 16, 16], seed=6)
    floors = np.asarray([5, 0, 3], np.int32)
    out = da.decode_attention(*map(torch.from_numpy, (q, k, v, L)),
                              min_pos=torch.from_numpy(floors)).numpy()
    kern = np.asarray(da_jax.decode_attention_pallas(
        *map(jnp.asarray, (q, k, v, L)), min_pos=jnp.asarray(floors)))
    np.testing.assert_array_equal(out[0], np.zeros_like(out[0]))
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[1], _port(q, k, v, L)[1], atol=0, rtol=0)


def test_unscaled_window_matches_xla():
    """GPT-Neo's local layers: sm_scale 1.0 and a window floor (large
    scores, the softmax kept in fp32)."""
    q, k, v, L, extra = _variant_inputs(2, 4, 4, 64, 24, [24, 13],
                                        "windowed", False, seed=8)
    ref = np.asarray(da_jax.decode_attention_xla(
        *map(jnp.asarray, (q, k, v, L)), sm_scale=1.0,
        min_pos=jnp.asarray(extra["min_pos"])))
    out = da.decode_attention(*map(torch.from_numpy, (q, k, v, L)),
                              sm_scale=1.0,
                              min_pos=torch.from_numpy(extra["min_pos"]))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_variant_arguments_are_checked_before_a_launch():
    """The CUDA wrapper refuses slopes or floors of the wrong type or
    shape before it loads anything."""
    q, k, v, L = map(torch.from_numpy, _inputs(2, 4, 4, 64, 16, [3, 9], 1))
    with pytest.raises(ValueError, match="alibi_slopes"):
        da.decode_attention_cuda(q, k, v, L, alibi_slopes=torch.ones(3))
    with pytest.raises(ValueError, match="min_pos"):
        da.decode_attention_cuda(q, k, v, L,
                                 min_pos=torch.zeros(2, dtype=torch.int64))
