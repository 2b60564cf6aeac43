"""Attention dispatch for the port (counterpart of
``deepspeed_tpu/ops/attention.py``, single-device branch).

``causal_attention`` with ``impl="auto"`` or ``"flash"`` runs the
differentiable flash attention (``DSFlashAttention``): the CUDA forward
and backward kernels for CUDA tensors at every sequence length (the
reference's S >= 256 cut was a TPU launch-cost trade; on the GPU no plain
path runs), their plain versions for CPU tensors.  ``impl="plain"``
selects :func:`plain_causal_attention`, the einsum reference (gradients
by autograd through plain torch ops), explicitly.
"""
import torch

from deepspeed_tpu_torch.ops.kernels.ds_flash_attention import \
    ds_flash_attention

ATTENTION_IMPLS = ("auto", "flash", "plain")


def plain_causal_attention(q, k, v, segment_ids=None):
    """Einsum attention with a causal mask, [B, S, H, hd] layout, fp32
    scores and softmax (mirrors ``xla_causal_attention``); KV may divide
    H.  ``segment_ids`` [B, S] restricts attention within segments."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                 device=q.device))[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q, k, v, impl: str = "auto", segment_ids=None):
    """q [B, S, H, hd], k/v [B, S, KV, hd] -> [B, S, H, hd]."""
    if impl == "plain":
        return plain_causal_attention(q, k, v, segment_ids)
    if impl in ("auto", "flash"):
        return ds_flash_attention(q, k, v, segment_ids=segment_ids,
                                  causal=True)
    raise ValueError(f"causal_attention: impl {impl!r} not in "
                     f"{ATTENTION_IMPLS}")
