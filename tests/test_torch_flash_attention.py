"""deepspeed_tpu_torch flash-attention forward vs the JAX package.

The port's plain flash forward (what its wrapper runs for CPU tensors;
the CUDA kernel is held against it on the card by chip_smoke.py) returns
(o, lse) and is compared with the JAX Pallas ``_fwd_kernel`` driven
through ``_fwd(..., interpret=True)`` / ``chunk_fwd(..., interpret=True)``
on the same seeded numpy inputs.

Tolerance: fp32 <= 1e-5 abs on o and lse — both sides accumulate in fp32;
only the summation order (online vs one-shot softmax) differs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.pallas import ds_flash_attention as fa_jax
from deepspeed_tpu_torch.ops.attention import (causal_attention,
                                               plain_causal_attention)
from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa

ATOL = 1e-5


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32))


def _segments(B, S):
    """Two packed segments then a segment-0 pad run per row."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        a = S // 3 + b
        c = 2 * S // 3 + b
        seg[b, :a] = 1
        seg[b, a:c] = 2
    return seg


def _jax_fwd(q, k, v, seg, causal):
    o, (_, _, _, _, lse) = fa_jax._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seg is None else jnp.asarray(seg), causal, None, 512, 512,
        interpret=True)
    return np.asarray(o), np.asarray(lse)


def _port_fwd(q, k, v, seg, causal):
    o, lse = fa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if seg is None else torch.from_numpy(seg), causal)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("S", [48, 80])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_plain_matches_pallas_fwd(S, causal, H, KV):
    q, k, v = _inputs(2, S, H, KV, 24, seed=S + H)
    o_ref, lse_ref = _jax_fwd(q, k, v, None, causal)
    o, lse = _port_fwd(q, k, v, None, causal)
    np.testing.assert_allclose(o, o_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, lse_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [48, 80])
def test_plain_matches_pallas_fwd_segments(causal, S):
    q, k, v = _inputs(2, S, 8, 2, 24, seed=7 + S)
    seg = _segments(2, S)
    o_ref, lse_ref = _jax_fwd(q, k, v, seg, causal)
    o, lse = _port_fwd(q, k, v, seg, causal)
    np.testing.assert_allclose(o, o_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, lse_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd,seg", [(64, False), (80, False), (96, False),
                                    (128, False), (96, True)])
def test_plain_matches_pallas_fwd_kernel_head_dims(hd, seg):
    """The head dims the CUDA kernel takes (``HEAD_DIMS``), GQA 4 / 2,
    causal, S 40 (one ragged tile), with and without segment ids."""
    assert hd in fa.HEAD_DIMS
    q, k, v = _inputs(1, 40, 4, 2, hd, seed=hd + seg)
    sg = _segments(1, 40) if seg else None
    o_ref, lse_ref = _jax_fwd(q, k, v, sg, True)
    o, lse = _port_fwd(q, k, v, sg, True)
    np.testing.assert_allclose(o, o_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, lse_ref, atol=ATOL, rtol=0)


def test_plain_matches_chunk_fwd():
    q, k, v = _inputs(1, 48, 4, 4, 24, seed=11)
    o_ref, lse_ref = fa_jax.chunk_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      interpret=True)
    o, lse = _port_fwd(q, k, v, None, True)
    np.testing.assert_allclose(o, np.asarray(o_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, np.asarray(lse_ref), atol=ATOL, rtol=0)


def test_causal_attention_dispatch_matches_plain_einsum():
    """On CPU tensors ``causal_attention`` (impl auto / flash) and the
    explicit plain einsum agree, GQA included."""
    q, k, v = _inputs(2, 20, 8, 2, 24, seed=5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = plain_causal_attention(tq, tk, tv).numpy()
    for impl in ("auto", "flash", "plain"):
        out = causal_attention(tq, tk, tv, impl=impl).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        causal_attention(tq, tk, tv, impl="xla")
