"""MoE layer of the serving path (counterpart of
``deepspeed_tpu/moe/layer.py``: ``MoEConfig`` :43, ``_grouped_moe`` :285,
``_glu`` :334, ``_routing_logits`` :350, ``moe_layer`` :357 in grouped
mode; ``_finish_residual`` :419 is the identity without ``use_residual``,
and its residual branch is refused).

Grouped (megablocks-style, drop-free) dispatch: the [T, k] routed
(token, choice) pairs run the expert FFN through the grouped-GEMM kernels
(``ops/kernels/grouped_gemm.py``) and combine by their normalised gates.
R = T * k <= ``SLOT_MAX_ROWS`` (decode, short prefills) takes the slot
kernel over the raw rows; a larger R sorts and pads the rows per expert
for the group-padded kernel.  On CPU tensors the same rule picks between
the two plain versions.  Int8 serving: expert stacks that arrive as
``QuantizedTensor`` leaves (the decode path's ``keep_quantized``) go
to the int8 grouped kernels as they are, and a quantized router goes
through qgemm in fp32 (the reference's ``qdot``).

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the einsum (GShard capacity) dispatch and ``train=True`` (MoE
training), the residual MoE (``use_residual``), expert parallelism.
Router-health telemetry is left out (ROADMAP.md Queue A: telemetry).
"""
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.model import qdot
from deepspeed_tpu_torch.moe.sharded_moe import topk_routing
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg

#: dispatch formulations the reference accepts
DISPATCH_MODES = ("auto", "einsum", "grouped")
_TRAIN_ITEM = "ROADMAP.md Queue B: MoE training (port slice 7)"


@dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig`` and its defaults, less the fields
    only the einsum dispatch and training read (``capacity_factor``,
    ``eval_capacity_factor``, ``min_capacity``, ``noisy_gate_policy``):
    the grouped dispatch is drop-free and serving routes without noise."""
    d_model: int
    d_ff: int
    num_experts: int = 8
    top_k: int = 2
    activation: str = "silu_glu"               # silu_glu (Mixtral) | gelu
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 0.0
    use_residual: bool = False
    dispatch_mode: str = "einsum"


def resolve_dispatch_mode(config: MoEConfig, train: bool,
                          override: Optional[str] = None) -> str:
    """-> ``"grouped"``, the one formulation the port serves.  ``override``
    is ``serving.moe_dispatch`` (it wins over the layer config, as in the
    reference); ``"auto"`` resolves to grouped at eval.  Training and the
    einsum formulation raise."""
    mode = override or config.dispatch_mode or "auto"
    if mode not in DISPATCH_MODES:
        raise ValueError(f"moe dispatch mode {mode!r}: choose one of "
                         f"{DISPATCH_MODES}")
    if train:
        raise NotImplementedError(
            f"moe_layer(train=True): MoE training is not ported to "
            f"deepspeed_tpu_torch yet ({_TRAIN_ITEM})")
    if mode == "einsum":
        raise NotImplementedError(
            "moe dispatch 'einsum' (the GShard capacity formulation): not "
            f"ported to deepspeed_tpu_torch yet ({_TRAIN_ITEM}); the port "
            "serves the grouped dispatch ('auto' or 'grouped')")
    return "grouped"


def _routing_logits(params, xt):
    """Router matmul in fp32 ([T, D] @ [D, E]) through ``qdot``: an int8
    router stays quantized into qgemm (fp32 x), a float one is cast to
    fp32."""
    return qdot(xt.float(), params["router"])


def _glu(mm, x, w_gate, w_in, config: MoEConfig):
    if config.activation == "silu_glu":
        return F.silu(mm(x, w_gate)) * mm(x, w_in)
    return F.gelu(mm(x, w_in), approximate="tanh")


def _grouped_moe(params, xt, config: MoEConfig):
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
    if T * k <= gg.SLOT_MAX_ROWS:
        # decode-sized: each distinct routed expert streams once, no
        # scatter or gather
        plan = gg.make_slot_plan(eids, E)

        def mm(a, w):
            return gg.ds_ggemm_slots(a, w, plan)
        out_rows = mm(_glu(mm, rows, w_gate, w_in, config), w_out)
    else:
        plan = gg.make_group_plan(eids, E)

        def mm(a, w):
            return gg.ds_ggemm(a, w, plan)
        h = _glu(mm, gg.scatter_to_groups(rows, plan), w_gate, w_in, config)
        out_rows = gg.gather_from_groups(mm(h, w_out), plan)
    combined = (gates.to(dt)[:, None] * out_rows).reshape(T, k, D).sum(1)
    aux = routing.l_aux * config.aux_loss_coef + routing.router_z_loss
    return combined, aux


def moe_layer(params: dict, x, config: MoEConfig, train: bool = False):
    """x [B, S, D] -> (out [B, S, D], aux loss scalar), grouped dispatch
    (see :func:`_grouped_moe`)."""
    resolve_dispatch_mode(config, train)
    if config.use_residual:
        raise NotImplementedError(
            "MoEConfig.use_residual (residual MoE): not ported to "
            f"deepspeed_tpu_torch yet ({_TRAIN_ITEM})")
    B, S, D = x.shape
    combined, aux = _grouped_moe(params, x.reshape(B * S, D), config)
    return combined.reshape(B, S, D), aux
