"""MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``: ``MoEConfig``
:43, ``resolve_dispatch_mode`` :143,
``dispatch_scope`` :130, ``_expert_ffn`` :260, ``_grouped_moe`` :285,
``_glu`` :334, ``_routing_logits`` :350, ``moe_layer`` :357,
``_finish_residual`` :419).

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

The noisy gate (``noisy_gate_policy``, when training) adds Gumbel noise
to the selection logits (``moe/sharded_moe.py``); ``moe_layer``'s
``rng`` is the noise itself, a ``torch.Generator`` or an int seed of one
(the models derive it from the config seed, the step, the micro-step and
the layer, so a resumed run draws the same noise with no saved generator
state, and a remat recompute draws it again).  The residual MoE
(``use_residual``, PR-MoE) runs a dense FFN beside the experts and mixes
the two per token by a softmax coefficient computed in fp32 and cast
back to the compute dtype.  Router-health telemetry is left out
(ROADMAP.md Queue A: telemetry), and so is expert parallelism (one
device).

A serving scheduler picks the dispatch for the calls it makes with
:func:`dispatch_scope` (``serving.moe_dispatch``), as the reference's
``set_dispatch_override``; the einsum dispatch at eval drops tokens
beyond ``eval_capacity_factor`` as the reference's does.
"""
import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.model import qdot
from deepspeed_tpu_torch.moe.sharded_moe import topk_routing, topkgating
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg

#: dispatch formulations the reference accepts
DISPATCH_MODES = ("auto", "einsum", "grouped")
#: the serving scheduler's ``serving.moe_dispatch`` (None: defer to the
#: layer config), set around its model calls by ``dispatch_scope``
_dispatch_override: Optional[str] = None


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
    noisy_gate_policy: Optional[str] = None    # None | 'Jitter' 
    activation: str = "silu_glu"               # silu_glu (Mixtral) | gelu
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 0.0
    use_residual: bool = False
    dispatch_mode: str = "einsum"


@contextlib.contextmanager
def dispatch_scope(mode: Optional[str]):
    """Force a dispatch mode (``serving.moe_dispatch``) for the MoE layers
    called inside this scope; None defers to each layer's config."""
    global _dispatch_override
    if mode is not None and mode not in DISPATCH_MODES:
        raise ValueError(f"moe dispatch mode {mode!r}: choose one of "
                         f"{DISPATCH_MODES}")
    prev, _dispatch_override = _dispatch_override, mode
    try:
        yield
    finally:
        _dispatch_override = prev


def resolve_dispatch_mode(config: MoEConfig, train: bool,
                          override: Optional[str] = None) -> str:
    """-> ``"einsum"`` or ``"grouped"`` for this call.  ``override`` (or
    the enclosing :func:`dispatch_scope`) is ``serving.moe_dispatch`` (it
    wins over the layer config, as in the reference); ``"auto"`` is
    einsum when training and grouped at eval."""
    mode = (override or _dispatch_override or config.dispatch_mode
            or "auto")
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


def moe_shapes(config: MoEConfig, lead=(), std: float = 0.02) -> dict:
    """Leaf shapes and init scales of one layer's MoE params (``lead``:
    stacked dims in front, such as the layer count)."""
    E, D, F = config.num_experts, config.d_model, config.d_ff
    lead = tuple(lead)
    out = {"router": (lead + (D, E), std),
           "w_in": (lead + (E, D, F), std),
           "w_out": (lead + (E, F, D), std)}
    if config.activation == "silu_glu":
        out["w_gate"] = (lead + (E, D, F), std)
    out.update(residual_shapes(config, lead, std))
    return out


def residual_shapes(config: MoEConfig, lead=(), std: float = 0.02) -> dict:
    """The residual MoE's leaves (none without ``use_residual``)."""
    if not config.use_residual:
        return {}
    D, F = config.d_model, config.d_ff
    lead = tuple(lead)
    out = {"res_in": (lead + (D, F), std), "res_out": (lead + (F, D), std),
           "coef_w": (lead + (D, 2), std), "coef_b": (lead + (2,), 0)}
    if config.activation == "silu_glu":
        out["res_gate"] = (lead + (D, F), std)
    return out


def _noise_source(rng, config: MoEConfig, train: bool, device):
    """The noisy gate's noise for ``topk_routing``: None unless training
    with a ``noisy_gate_policy``; an int ``rng`` seeds a generator on
    ``device``."""
    if not (train and config.noisy_gate_policy) or rng is None:
        return None
    if isinstance(rng, (torch.Tensor, torch.Generator)):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def _grouped_moe(params, xt, config: MoEConfig, train: bool, noise=None):
    """Drop-free grouped dispatch: route, run the expert FFN as grouped
    GEMMs over the routed rows, combine each token's k outputs weighted by
    its normalised gates.  Returns (combined [T, D], aux scalar)."""
    T, D = xt.shape
    E, k = config.num_experts, config.top_k
    dt = xt.dtype
    logits = _routing_logits(params, xt)
    routing = topk_routing(logits, k, noise, config.z_loss_coef)
    eids = routing.expert_idx.reshape(-1)                 # [T * k]
    gates = routing.gate_weights.reshape(-1)              # [T * k] fp32
    # each token's k rows (token-major, as the reference's gather by
    # arange(T k) // k); by expand, whose backward sums a token's k row
    # gradients in a fixed order (an index_select's backward would add
    # them with atomics, in an order that changes from run to run)
    rows = xt[:, None, :].expand(T, k, D).reshape(T * k, D).contiguous()
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


def _einsum_moe(params, xt, config: MoEConfig, train: bool, noise=None):
    """The GShard capacity formulation: dispatch [T, E, C] x [T, D] ->
    [E, C, D], the experts, combine [T, E, C] x [E, C, D] -> [T, D].
    Returns (combined [T, D], aux scalar)."""
    logits = _routing_logits(params, xt)
    cf = config.capacity_factor if train else config.eval_capacity_factor
    routing = topk_routing(logits, config.top_k, noise, config.z_loss_coef)
    gate = topkgating(logits, config.top_k, cf, config.min_capacity, None,
                      config.z_loss_coef, routing=routing)
    dt = xt.dtype
    dispatched = torch.einsum("tec,td->ecd", gate.dispatch_mask.to(dt), xt)
    out = _expert_ffn(params, dispatched, config)
    combined = torch.einsum("tec,ecd->td", gate.combine_weights.to(dt), out)
    aux = gate.l_aux * config.aux_loss_coef + gate.router_z_loss
    return combined, aux


def moe_layer(params: dict, x, config: MoEConfig, train: bool = False,
              rng=None):
    """x [B, S, D] -> (out [B, S, D], aux loss scalar) by the resolved
    dispatch (see :func:`resolve_dispatch_mode`).  ``rng``: the noisy
    gate's noise source when training with ``noisy_gate_policy`` (the
    [T, E] noise, a ``torch.Generator`` or an int seed)."""
    mode = resolve_dispatch_mode(config, train)
    B, S, D = x.shape
    noise = _noise_source(rng, config, train, x.device)
    moe = _grouped_moe if mode == "grouped" else _einsum_moe
    combined, aux = moe(params, x.reshape(B * S, D), config, train, noise)
    return _finish_residual(params, x, combined.reshape(B, S, D), aux,
                            config)


def _finish_residual(params, x, moe_out, aux, config: MoEConfig):
    """Residual MoE (the reference's ``_finish_residual``): a dense FFN
    beside the experts, mixed per token by a 2-way softmax coefficient
    (computed in fp32, cast to the compute dtype); the identity without
    ``use_residual``."""
    if config.use_residual:
        dt = x.dtype
        if config.activation == "silu_glu":
            h = F.silu(qdot(x, params["res_gate"])) * qdot(x,
                                                           params["res_in"])
        else:
            h = F.gelu(qdot(x, params["res_in"]), approximate="tanh")
        res = qdot(h, params["res_out"])
        coef = torch.softmax(
            (qdot(x, params["coef_w"]) + params["coef_b"].to(dt)).float(),
            dim=-1).to(dt)
        moe_out = moe_out * coef[..., 0:1] + res * coef[..., 1:]
    return moe_out, aux
