"""The flash kernels' fp16 inputs: the port's plain forward and backward
(what ``flash_attention_fwd`` / ``flash_attention_bwd`` run for CPU
tensors, and what chip_smoke.py phase 32 holds the fp16 CUDA forms
against) against the JAX package's Pallas ``_fwd`` and ``_bwd_calls`` in
interpret mode on the same seeded fp16 inputs, causal and with segment
ids, and the autograd Function on fp16 CPU tensors against the two.

Both sides compute in fp32 and round the outputs to fp16 (the reference
returns dk / dv in fp32; they are rounded here the same way).
Tolerance: one fp16 rounding of the output, 2^-10 of each tensor's max
magnitude, on o, dq, dk and dv; lse (fp32 on both sides) <= 1e-5 abs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deepspeed_tpu.ops.pallas import ds_flash_attention as fa_jax
from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa

HD = 32
ROUND = 2.0 ** -10


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, S, H, KV, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 .astype(np.float16)
                 for shape in ((B, S, H, HD), (B, S, KV, HD), (B, S, KV, HD),
                               (B, S, H, HD)))


def _segments(B, S):
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        seg[b, :S // 3 + b] = 1
        seg[b, S // 3 + b:2 * S // 3 + b] = 2
    return seg


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float16).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ROUND * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("causal,seg,kv", [(True, False, 4),
                                           (True, True, 2),
                                           (False, True, 4)])
def test_plain_fp16_matches_pallas(interpret_pallas, causal, seg, kv):
    B, S, H = 2, 160, 4
    q, k, v, do = _inputs(B, S, H, kv, seed=11 + kv)
    sg = _segments(B, S) if seg else None
    jseg = None if sg is None else jnp.asarray(sg)
    o, (_, _, _, _, lse) = fa_jax._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, causal, None,
        512, 512, interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tseg = None if sg is None else torch.from_numpy(sg)
    po, plse = fa.flash_attention_fwd_plain(*t[:3], tseg, causal)
    assert po.dtype == torch.float16 and plse.dtype == torch.float32
    _close(po.numpy(), o, "o")
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), atol=1e-5,
                               rtol=0)
    delta = np.einsum("bshd,bshd->bhs", do.astype(np.float32),
                      np.asarray(o, np.float32))
    ref = fa_jax._bwd_calls(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(do), lse, jnp.asarray(delta), jseg,
                            causal, None, 512, 512, interpret=True)
    got = fa.flash_attention_bwd_plain(
        *t, torch.from_numpy(np.array(lse)), torch.from_numpy(delta), tseg,
        causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float16
        _close(g.numpy(), r, name)
    # the autograd Function on fp16 CPU tensors runs the same two
    ql, kl, vl = (x.clone().requires_grad_() for x in t[:3])
    out = fa.ds_flash_attention(ql, kl, vl, tseg, causal)
    out.backward(t[3])
    assert torch.equal(out.detach(), po)
    for name, g, r in zip(("dq", "dk", "dv"), (ql.grad, kl.grad, vl.grad),
                          ref):
        _close(g.numpy(), r, f"autograd {name}")


def test_fp16_is_a_kernel_dtype():
    """The wrapper's dtype codes: fp16 is one of them, and its CUDA path
    takes fp16 views (the CPU tensors here take the plain version)."""
    assert fa._DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                               torch.float16: 2}
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    fa._check_qkv(q, q, q)
    with pytest.raises(ValueError, match="dtypes"):
        fa._check_qkv(q, q.float(), q)
