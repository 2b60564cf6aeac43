"""Token sampling (counterpart of ``deepspeed_tpu/inference/sampling.py``
and of ``serving/spec/verifier.py`` ``process_sampling_logits``):
greedy, temperature, top-k, top-p.

Random draws use the Gumbel-max form ``argmax(x + g)`` with ``g`` drawn
from a ``torch.Generator``.  The numbers differ from JAX's for the same
seed (another generator); greedy decoding is exact.
"""
import torch

NEG_INF = -1e30


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row; mask the rest. logits [B, V]."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                       logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: keep the smallest prefix of the sorted distribution
    with cumulative probability >= p (the first token always kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u ~ U[0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, generator: torch.Generator = None, *,
           do_sample: bool = True, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / max(temperature, 1e-6)
    if top_k:
        x = apply_top_k(x, top_k)
    if top_p < 1.0:
        x = apply_top_p(x, top_p)
    g = gumbel_noise(x.shape, generator, x.device)
    return torch.argmax(x + g, dim=-1).to(torch.int32)


def process_sampling_logits(x, temps, top_ks, top_ps):
    """Per-row temperature + top-k + top-p masking with per-row parameters
    (``temps``/``top_ps`` float [B], ``top_ks`` int [B]; top_k = 0 and
    top_p >= 1 are no-ops): raw logits [B, V] -> fp32 processed logits
    whose softmax is the distribution sampling draws from."""
    V = x.shape[-1]
    x = x.float() / temps.clamp_min(1e-6)[:, None]
    neg = torch.full_like(x, NEG_INF)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    kth = sorted_desc.gather(
        -1, (top_ks.long() - 1).clamp(0, V - 1)[:, None])
    x = torch.where((top_ks[:, None] > 0) & (x < kth), neg, x)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    thresh = torch.where(keep, sorted_desc,
                         torch.full_like(sorted_desc, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(x < thresh, neg, x)
