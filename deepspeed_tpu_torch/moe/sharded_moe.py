"""Top-k gating (counterpart of ``deepspeed_tpu/moe/sharded_moe.py``):
the capacity-free routing decision the grouped dispatch consumes
(``TopKRouting`` :24, ``topk_routing`` :36) and the GShard capacity
formulation of the einsum dispatch (``GateOutput`` :17, ``_capacity``
:109, ``_one_hot_dispatch`` :115, ``topkgating`` :141, ``top1gating`` /
``top2gating`` :170-191): dense [T, E, C] combine weights and dispatch
mask, capacity enforced by each token's position in its expert (a cumsum
in token order, the earlier choice rounds' occupancy first), tokens past
capacity dropped.

The selection is the reference's iterative argmax with -1e9 suppression,
not ``torch.topk`` (whose tie-break differs); ``torch.argmax``, like
``jnp.argmax``, returns the first maximum.  The losses are differentiable
through the router as ``jax.grad`` sees them: the aux loss through the
mean softmax gates (the top-1 fractions are counts), the z loss through
the logsumexp, the combine weights through the chosen gates.  The noisy
gate (``noise_rng``, gumbel jitter on the selection logits) is refused
(ROADMAP.md Queue A: MoE training — noisy gate).
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F


NOISY_GATE_ITEM = "ROADMAP.md Queue A: MoE training — noisy gate"


def _refuse_noise(noise_rng, what):
    if noise_rng is not None:
        raise NotImplementedError(
            f"{what}(noise_rng=...): the noisy gate is not ported to "
            f"deepspeed_tpu_torch yet ({NOISY_GATE_ITEM})")


class GateOutput(NamedTuple):
    l_aux: torch.Tensor            # load-balancing loss (scalar)
    combine_weights: torch.Tensor  # [T, E, C] fp32
    dispatch_mask: torch.Tensor    # [T, E, C] bool
    router_z_loss: torch.Tensor    # scalar (0 when disabled)


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
    sum (clamped at fp32 eps).  The noisy gate (``noise_rng``) is
    refused."""
    _refuse_noise(noise_rng, "topk_routing")
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


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int, top_k: int = 1) -> int:
    cap = int(num_tokens * top_k / num_experts * capacity_factor)
    return max(cap, min_capacity)


def _one_hot_dispatch(indices, gates_for_choice, num_experts: int,
                      capacity: int, occupancy=None):
    """``indices`` [T] chosen expert per token, ``gates_for_choice`` [T]
    its weight; ``occupancy`` [E] the capacity slots earlier choice rounds
    took, so this round's positions start after them.  Returns ([T, E, C]
    combine, [T, E, C] mask, per-expert kept counts [E])."""
    mask = F.one_hot(indices.long(), num_experts)                 # [T, E]
    pos_in_expert = torch.cumsum(mask, 0) * mask - mask
    if occupancy is not None:
        pos_in_expert = pos_in_expert + occupancy[None, :] * mask
    mask = mask * (pos_in_expert < capacity)
    pos = (pos_in_expert * mask).sum(1)                           # [T]
    kept = mask.sum(1) > 0                                        # [T]
    loc = F.one_hot(pos, capacity).float()                        # [T, C]
    combine = (gates_for_choice * kept)[:, None, None] \
        * mask.float()[:, :, None] * loc[:, None, :]
    return combine, combine > 0, mask.sum(0)


def topkgating(logits, k: int, capacity_factor: float = 1.0,
               min_capacity: int = 4, noise_rng=None,
               z_loss_coef: float = 0.0, routing: TopKRouting = None
               ) -> GateOutput:
    """``logits`` [T, E] -> :class:`GateOutput` with capacity
    ``max(int(T k / E * capacity_factor), min_capacity)``: each choice
    round's tokens take the next free slots of their expert in token
    order; a token past capacity drops from that expert.  A caller that
    holds the :func:`topk_routing` decision passes it in."""
    T, E = logits.shape
    capacity = _capacity(T, E, capacity_factor, min_capacity, top_k=k)
    if routing is None:
        routing = topk_routing(logits, k, noise_rng, z_loss_coef)
    combine_total = torch.zeros((T, E, capacity), dtype=torch.float32,
                                device=logits.device)
    occupancy = torch.zeros(E, dtype=torch.int64, device=logits.device)
    for i in range(k):
        combine, _, counts = _one_hot_dispatch(
            routing.expert_idx[:, i], routing.gate_weights[:, i], E,
            capacity, occupancy=occupancy)
        combine_total = combine_total + combine
        occupancy = occupancy + counts
    return GateOutput(routing.l_aux, combine_total, combine_total > 0,
                      routing.router_z_loss)


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noise_rng=None) -> GateOutput:
    """The reference's ``top1gating`` (its gate value is not normalised
    for k = 1)."""
    _refuse_noise(noise_rng, "top1gating")
    T, E = logits.shape
    select = logits.float()
    gates = torch.softmax(select, dim=-1)
    capacity = _capacity(T, E, capacity_factor, min_capacity, 1)
    idx = torch.argmax(select, dim=-1)
    me = gates.mean(0)
    ce = F.one_hot(idx, E).float().mean(0)
    l_aux = (me * ce).sum() * E
    gate_val = gates.gather(1, idx[:, None])[:, 0]
    combine, mask, _ = _one_hot_dispatch(idx, gate_val, E, capacity)
    return GateOutput(l_aux, combine, mask,
                      torch.zeros((), dtype=torch.float32,
                                  device=logits.device))


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noise_rng=None) -> GateOutput:
    """The reference's ``top2gating``: :func:`topkgating` at k = 2."""
    return topkgating(logits, 2, capacity_factor, min_capacity, noise_rng)
