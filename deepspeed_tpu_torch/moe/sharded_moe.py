"""Top-k routing (counterpart of ``deepspeed_tpu/moe/sharded_moe.py``
``TopKRouting`` :24 and ``topk_routing`` :36): the capacity-free routing
decision the grouped dispatch consumes.

The selection is the reference's iterative argmax with -1e9 suppression,
not ``torch.topk`` (whose tie-break differs); ``torch.argmax``, like
``jnp.argmax``, returns the first maximum.  The capacity formulation
(``topkgating``, dense [T, E, C] tensors) belongs to the einsum dispatch,
which the port has not ported (ROADMAP.md Queue B: MoE training).
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F


class TopKRouting(NamedTuple):
    l_aux: torch.Tensor          # load-balancing loss (scalar fp32)
    router_z_loss: torch.Tensor  # scalar fp32 (0 when disabled)
    expert_idx: torch.Tensor     # [T, k] int32 chosen expert per choice
    gate_weights: torch.Tensor   # [T, k] fp32 normalized gate values


def topk_routing(logits, k: int, noise_rng=None,
                 z_loss_coef: float = 0.0) -> TopKRouting:
    """``logits`` [T, E] -> :class:`TopKRouting`: softmax gates in fp32,
    the top-1 load-balancing loss, k rounds of argmax with the chosen
    expert suppressed by -1e9, and the chosen gates normalised by their
    sum (clamped at fp32 eps).  The noisy gate (``noise_rng``) is a
    training feature and is refused."""
    if noise_rng is not None:
        raise NotImplementedError(
            "topk_routing(noise_rng=...): the noisy gate is a training "
            "feature, not ported to deepspeed_tpu_torch yet (ROADMAP.md "
            "Queue B: MoE training)")
    T, E = logits.shape
    select = logits.float()
    gates = torch.softmax(select, dim=-1)
    top1 = torch.argmax(select, dim=-1)
    me = gates.mean(0)
    ce = F.one_hot(top1, E).float().mean(0)
    l_aux = (me * ce).sum() * E
    z_loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    if z_loss_coef > 0:
        z = torch.logsumexp(select, dim=-1)
        z_loss = z_loss_coef * (z ** 2).mean()
    remaining = select
    chosen_gates, chosen_idx = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        chosen_idx.append(idx)
        chosen_gates.append(gates.gather(1, idx[:, None])[:, 0])
        remaining = remaining - F.one_hot(idx, E).float() * 1e9
    denom = chosen_gates[0]
    for g in chosen_gates[1:]:
        denom = denom + g
    denom = torch.clamp(denom, min=torch.finfo(torch.float32).eps)
    expert_idx = torch.stack(chosen_idx, dim=1).to(torch.int32)
    gate_weights = torch.stack([g / denom for g in chosen_gates], dim=1)
    return TopKRouting(l_aux, z_loss, expert_idx, gate_weights)
