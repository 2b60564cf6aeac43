"""Attention dispatch for the port (counterpart of
``deepspeed_tpu/ops/attention.py``, single-device branch).

``causal_attention`` with ``impl="auto"`` or ``"flash"`` runs the
differentiable flash attention (``DSFlashAttention``): the CUDA forward
and backward kernels for CUDA tensors at every sequence length (the
reference's S >= 256 cut was a TPU launch-cost trade; on the GPU no plain
path runs), their plain versions for CPU tensors.  ``impl="plain"``
selects :func:`plain_causal_attention`, the einsum reference (gradients
by autograd through plain torch ops), explicitly.

``bidirectional_attention`` (encoders: BERT) runs the same kernels with
``causal=False``; a key padding mask becomes the kernels' segment ids
(real tokens segment 1, pads segment 0), as the reference maps it.
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


def plain_bidirectional_attention(q, k, v, pad_mask=None):
    """Encoder attention without a causal mask (mirrors
    ``xla_bidirectional_attention``): fp32 scores, keys where ``pad_mask``
    [B, S] is 0 masked with the fp32 minimum, probabilities in q's dtype.
    Pad queries see the real keys here (only keys are masked)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    if pad_mask is not None:
        keep = pad_mask[:, None, None, :].to(torch.bool)
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def bidirectional_attention(q, k, v, pad_mask=None, impl: str = "auto"):
    """q / k / v [B, S, H, hd] -> [B, S, H, hd], no causal mask.
    ``impl="auto"`` / ``"flash"``: the flash kernels at every S, the
    padding mask [B, S] (1 real, 0 pad; bool or integer) as segment ids,
    so a real query sees the real keys and a pad query only the pads (the
    reference's flash route).  Real-token rows equal the plain route's;
    pad rows do not, and are the caller's to ignore (BERT's MLM labels are
    -100 there)."""
    if impl == "plain":
        return plain_bidirectional_attention(q, k, v, pad_mask)
    if impl in ("auto", "flash"):
        return ds_flash_attention(q, k, v, segment_ids=pad_mask,
                                  causal=False)
    raise ValueError(f"bidirectional_attention: impl {impl!r} not in "
                     f"{ATTENTION_IMPLS}")
