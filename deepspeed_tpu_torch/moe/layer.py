"""MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``: ``MoEConfig``
:43, ``resolve_dispatch_mode`` :143, ``_expert_ffn`` :260,
``_grouped_moe`` :285, ``_glu`` :334, ``_routing_logits`` :350,
``moe_layer`` :357; ``_finish_residual`` :419 is the identity without
``use_residual``, and its residual branch is refused).

Two dispatch formulations, as the reference's:

- grouped (megablocks-style, drop-free): the [T, k] routed (token,
  choice) pairs run the expert FFN through the grouped-GEMM kernels
  (``ops/kernels/grouped_gemm.py``) and combine by their normalised
  gates.  At eval, R = T * k <= ``SLOT_MAX_ROWS`` (decode, short
  prefills) takes the slot kernel over the raw rows; a larger R, and
  every training call, sorts and pads the rows per expert for the
  group-padded kernel, through :func:`grouped_gemm`'s autograd Function
  (its backward: the transposed-RHS and dW kernels).  On CPU tensors the
  same rule picks between the plain versions.  Int8 serving: expert
  stacks that arrive as ``QuantizedTensor`` leaves (the decode path's
  ``keep_quantized``) go to the int8 grouped kernels as they are, and a
  quantized router goes through qgemm in fp32 (the reference's ``qdot``).
- einsum (the GShard capacity formulation, plain PyTorch): dense [T, E,
  C] dispatch / combine tensors from :func:`topkgating` (capacity
  ``capacity_factor`` when training, ``eval_capacity_factor`` at eval;
  tokens past capacity drop), two einsums around a batched expert FFN.
  It is what ``"auto"`` resolves to when training.

Refused, each raising ``NotImplementedError`` naming its ROADMAP item:
the noisy gate (``noisy_gate_policy``), the residual MoE
(``use_residual``).  Router-health telemetry is left out (ROADMAP.md
Queue A: telemetry), and so is expert parallelism (one device).
"""
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.model import qdot
from deepspeed_tpu_torch.moe.sharded_moe import (NOISY_GATE_ITEM,
                                                 topk_routing, topkgating)
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg

#: dispatch formulations the reference accepts
DISPATCH_MODES = ("auto", "einsum", "grouped")
RESIDUAL_ITEM = "ROADMAP.md Queue A: MoE training — residual MoE"


@dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig`` and its defaults."""
    d_model: int
    d_ff: int
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None    # None; 'Jitter' is refused
    activation: str = "silu_glu"               # silu_glu (Mixtral) | gelu
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 0.0
    use_residual: bool = False
    dispatch_mode: str = "einsum"


def resolve_dispatch_mode(config: MoEConfig, train: bool,
                          override: Optional[str] = None) -> str:
    """-> ``"einsum"`` or ``"grouped"`` for this call.  ``override`` is
    ``serving.moe_dispatch`` (it wins over the layer config, as in the
    reference); ``"auto"`` is einsum when training and grouped at eval."""
    mode = override or config.dispatch_mode or "auto"
    if mode not in DISPATCH_MODES:
        raise ValueError(f"moe dispatch mode {mode!r}: choose one of "
                         f"{DISPATCH_MODES}")
    if mode == "auto":
        mode = "einsum" if train else "grouped"
    return mode


def _routing_logits(params, xt):
    """Router matmul in fp32 ([T, D] @ [D, E]) through ``qdot``: an int8
    router stays quantized into qgemm (fp32 x), a float one is cast to
    fp32."""
    return qdot(xt.float(), params["router"])


def _glu(mm, x, w_gate, w_in, config: MoEConfig):
    if config.activation == "silu_glu":
        return F.silu(mm(x, w_gate)) * mm(x, w_in)
    return F.gelu(mm(x, w_in), approximate="tanh")


def _grouped_moe(params, xt, config: MoEConfig, train: bool):
    """Drop-free grouped dispatch: route, run the expert FFN as grouped
    GEMMs over the routed rows, combine each token's k outputs weighted by
    its normalised gates.  Returns (combined [T, D], aux scalar)."""
    T, D = xt.shape
    E, k = config.num_experts, config.top_k
    dt = xt.dtype
    logits = _routing_logits(params, xt)
    routing = topk_routing(logits, k, None, config.z_loss_coef)
    eids = routing.expert_idx.reshape(-1)                 # [T * k]
    gates = routing.gate_weights.reshape(-1)              # [T * k] fp32
    tids = torch.arange(T * k, device=xt.device) // k
    rows = xt.index_select(0, tids)                       # [T * k, D]
    w_gate = params.get("w_gate")
    w_in, w_out = params["w_in"], params["w_out"]
    if not train and T * k <= gg.SLOT_MAX_ROWS:
        # decode-sized: each distinct routed expert streams once, no
        # scatter or gather
        plan = gg.make_slot_plan(eids, E)

        def mm(a, w):
            return gg.ds_ggemm_slots(a, w, plan)
        out_rows = mm(_glu(mm, rows, w_gate, w_in, config), w_out)
    else:
        # the stable sort rebuilds the same plan in a remat recompute
        plan = gg.make_group_plan(eids, E)

        def mm(a, w):
            return gg.grouped_gemm(a, w, plan)
        h = _glu(mm, gg.scatter_to_groups(rows, plan), w_gate, w_in, config)
        out_rows = gg.gather_from_groups(mm(h, w_out), plan)
    combined = (gates.to(dt)[:, None] * out_rows).reshape(T, k, D).sum(1)
    aux = routing.l_aux * config.aux_loss_coef + routing.router_z_loss
    return combined, aux


def _expert_ffn(params, x, config: MoEConfig):
    """x [E, C, D] (per-expert capacity slots) -> [E, C, D]: each expert's
    FFN over its slots, batched over E."""
    dt = x.dtype
    w_in, w_out = params["w_in"].to(dt), params["w_out"].to(dt)
    if config.activation == "silu_glu":
        h = F.silu(x @ params["w_gate"].to(dt)) * (x @ w_in)
    else:
        h = F.gelu(x @ w_in, approximate="tanh")
    return h @ w_out


def _einsum_moe(params, xt, config: MoEConfig, train: bool):
    """The GShard capacity formulation: dispatch [T, E, C] x [T, D] ->
    [E, C, D], the experts, combine [T, E, C] x [E, C, D] -> [T, D].
    Returns (combined [T, D], aux scalar)."""
    logits = _routing_logits(params, xt)
    cf = config.capacity_factor if train else config.eval_capacity_factor
    routing = topk_routing(logits, config.top_k, None, config.z_loss_coef)
    gate = topkgating(logits, config.top_k, cf, config.min_capacity, None,
                      config.z_loss_coef, routing=routing)
    dt = xt.dtype
    dispatched = torch.einsum("tec,td->ecd", gate.dispatch_mask.to(dt), xt)
    out = _expert_ffn(params, dispatched, config)
    combined = torch.einsum("tec,ecd->td", gate.combine_weights.to(dt), out)
    aux = gate.l_aux * config.aux_loss_coef + gate.router_z_loss
    return combined, aux


def moe_layer(params: dict, x, config: MoEConfig, train: bool = False):
    """x [B, S, D] -> (out [B, S, D], aux loss scalar) by the resolved
    dispatch (see :func:`resolve_dispatch_mode`)."""
    mode = resolve_dispatch_mode(config, train)
    if config.use_residual:
        raise NotImplementedError(
            "MoEConfig.use_residual (residual MoE): not ported to "
            f"deepspeed_tpu_torch yet ({RESIDUAL_ITEM})")
    if train and config.noisy_gate_policy:
        raise NotImplementedError(
            f"MoEConfig.noisy_gate_policy={config.noisy_gate_policy!r}: "
            f"not ported to deepspeed_tpu_torch yet ({NOISY_GATE_ITEM})")
    B, S, D = x.shape
    moe = _grouped_moe if mode == "grouped" else _einsum_moe
    combined, aux = moe(params, x.reshape(B * S, D), config, train)
    return combined.reshape(B, S, D), aux
