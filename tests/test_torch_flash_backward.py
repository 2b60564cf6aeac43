"""deepspeed_tpu_torch flash-attention backward vs the JAX package.

The port's plain backward (what ``flash_attention_bwd`` runs for CPU
tensors; the CUDA kernels are held against it on the card by
chip_smoke.py) is compared with the JAX Pallas ``_dkv_kernel`` /
``_dq_kernel`` driven through ``_bwd_calls(..., interpret=True)`` on the
same seeded numpy inputs and the same lse / delta; the autograd Function
``DSFlashAttention`` on CPU tensors is compared with ``jax.vjp`` of
``ds_flash_attention`` under Pallas interpret mode, and with autograd
through the plain einsum attention.

Tolerance: fp32 <= 1e-5 abs on dq, dk, dv (and o) — both sides
accumulate in fp32; only the summation order differs.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from deepspeed_tpu.ops.pallas import ds_flash_attention as fa_jax
from deepspeed_tpu_torch.ops.attention import causal_attention
from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa

ATOL = 1e-5
HD = 24


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, S, H, KV, seed, hd=HD):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, H, hd), dtype=np.float32))


def _segments(B, S):
    """Two packed segments then a segment-0 pad run per row."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        seg[b, :S // 3 + b] = 1
        seg[b, S // 3 + b:2 * S // 3 + b] = 2
    return seg


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL,
                                   rtol=0)


def _check_plain_bwd(q, k, v, do, seg, causal):
    """The plain backward against the reference's ``_bwd_calls`` in
    interpret mode, given the reference forward's lse and delta."""
    jseg = None if seg is None else jnp.asarray(seg)
    o, (_, _, _, _, lse) = fa_jax._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, causal, None,
        512, 512, interpret=True)
    delta = np.einsum("bshd,bshd->bhs", do, np.asarray(o))
    ref = fa_jax._bwd_calls(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(do), lse, jnp.asarray(delta), jseg,
                            causal, None, 512, 512, interpret=True)
    got = fa.flash_attention_bwd_plain(
        *_t(q, k, v, do, np.array(lse), delta, seg), causal=causal)
    _close([t.numpy() for t in got], ref)


@pytest.mark.parametrize("S", [48, 80])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_bwd_matches_pallas_bwd_calls(S, causal, H, KV, packed):
    q, k, v, do = _inputs(2, S, H, KV, seed=S + H + packed)
    _check_plain_bwd(q, k, v, do, _segments(2, S) if packed else None,
                     causal)


@pytest.mark.parametrize("hd", [64, 80, 96, 128])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_bwd_matches_pallas_bwd_calls_head_dims(hd, packed):
    """The head dims the CUDA kernels take (``HEAD_DIMS``), GQA 4 / 2,
    causal, S 40 (one ragged tile), with and without segment ids."""
    assert hd in fa.HEAD_DIMS
    q, k, v, do = _inputs(2, 40, 4, 2, seed=hd + packed, hd=hd)
    _check_plain_bwd(q, k, v, do, _segments(2, 40) if packed else None,
                     True)


@pytest.mark.parametrize("S", [48, 80])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_jax_vjp(interpret_pallas, S, H, KV,
                                           packed, causal):
    q, k, v, do = _inputs(2, S, H, KV, seed=3 * S + KV + packed)
    seg = _segments(2, S) if packed else None
    jseg = None if seg is None else jnp.asarray(seg)
    o_ref, vjp = jax.vjp(
        lambda a, b, c: fa_jax.ds_flash_attention(a, b, c, jseg, causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = fa.ds_flash_attention(tq, tk, tv, *_t(seg), causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    _close([o.detach().numpy()], [o_ref])
    _close([g.numpy() for g in got], ref)


@pytest.mark.parametrize("H,KV,packed", [(4, 4, False), (8, 2, False),
                                         (8, 2, True)])
def test_autograd_matches_plain_einsum_attention(H, KV, packed):
    """The Function (impl "flash") against autograd through the einsum
    reference (impl "plain"), both through ``causal_attention``."""
    q, k, v, do = _inputs(2, 40, H, KV, seed=11 + H)
    seg = _segments(2, 40) if packed else None
    grads = []
    for impl in ("flash", "plain"):
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        o = causal_attention(tq, tk, tv, impl=impl,
                             segment_ids=_t(seg)[0])
        grads.append(torch.autograd.grad(o, (tq, tk, tv),
                                         torch.from_numpy(do)))
    _close([g.numpy() for g in grads[0]], [g.numpy() for g in grads[1]])


def test_cpu_backward_launches_no_kernel_and_no_segment_grad():
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dkv_launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    q, k, v, do = _inputs(1, 20, 4, 2, seed=2)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    seg = torch.from_numpy(_segments(1, 20)).float().requires_grad_()
    o = fa.ds_flash_attention(tq, tk, tv, seg)
    o.backward(torch.from_numpy(do))
    assert all(t.grad is not None for t in (tq, tk, tv))
    assert seg.grad is None
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd
            .dkv_launches, fa.flash_attention_bwd.dq_launches) == (0, 0, 0)


def test_bwd_cuda_wrapper_rejects_what_the_kernels_do_not_take():
    """Validation runs before any launch, so it is checkable here."""
    q = torch.zeros(1, 8, 4, 64)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd_cuda(q[..., :24], q[..., :24], q[..., :24],
                                    q[..., :24], lse, lse)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_bwd_cuda(q, q, q, q[:, :4], lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse[..., :4], lse)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse, lse.double())
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_bwd_cuda(q, q, q,
                                    torch.zeros(1, 8, 4, 128)[..., ::2],
                                    lse, lse)


def _misaligned(shape, dtype):
    """A view whose base address is 2 bytes past a 16-byte boundary."""
    return torch.zeros(*shape[:3], shape[3] + 8, dtype=dtype)[..., 1:][
        ..., :shape[3]]


def _narrow_rows(shape, dtype):
    """A view whose sequence and batch strides are not a multiple of 16
    bytes (rows of shape[3] + 2 elements, the head dim contiguous)."""
    B, S, H, hd = shape
    return torch.zeros(B, S, H * hd + 2, dtype=dtype)[..., :H * hd] \
        .unflatten(-1, (H, hd))


@pytest.mark.parametrize("fault", [_misaligned, _narrow_rows])
@pytest.mark.parametrize("which", ["q", "k", "v", "dO"])
def test_bwd_cuda_wrapper_rejects_what_the_tma_maps_do_not_take(which,
                                                                fault):
    """The bf16 kernels read q, k, v and dO through TMA tensor maps, which
    need a 16-byte aligned base and strides that are multiples of 16
    bytes; each tensor is checked before any launch."""
    shape = (1, 8, 4, 64)
    t = {n: torch.zeros(shape, dtype=torch.bfloat16)
         for n in ("q", "k", "v", "dO")}
    t[which] = fault(shape, torch.bfloat16)
    assert t[which].shape == shape
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match=f"{which} strides"):
        fa.flash_attention_bwd_cuda(t["q"], t["k"], t["v"], t["dO"], lse,
                                    lse)
