"""Mixtral-style MoE decoder in PyTorch (counterpart of
``deepspeed_tpu/models/mixtral.py``): Llama attention blocks (RMSNorm,
split Q/K/V projections, rotary embeddings with the split-half pairing,
grouped-query attention) whose FFN is a top-k-routed SwiGLU expert layer
(``moe/layer.py``, grouped dispatch through the grouped-GEMM kernels).

Plain functions over a params dict with the reference's names and
stacked layout: ``blocks`` leaves are [L, ...], the experts' stacks
``blocks["moe"]["w_gate" | "w_in"]`` [L, E, D, F] and ``w_out``
[L, E, F, D], every projection ``[in, out]`` (``x @ w``).

Serving goes through the generic hook-driven ``prefill`` / ``decode_step``
of ``models/serving.py``: prefill runs the flash forward per layer over
the compact GQA cache ([L, B, S, KV, hd]); decode writes the new K/V in
place, runs the decode-attention kernel (rotary positions per row), and
the MoE FFN rides the slot kernel (R = B * top_k <= 128) or the
group-padded kernel (larger R: long prefills, wide decode batches); with
int8 weights decode keeps the expert stacks, projections and router
quantized into the int8 grouped GEMMs and qgemm, and prefill dequantizes
each layer whole.  With ``fused=True`` a decode step runs the fused
per-layer kernel over each layer's attention half (RMSNorm, Q/K/V,
rotary, GQA attention, attention-out + residual: ``mlp="none"``) and
then the expert FFN on the grouped-GEMM kernels (``moe_tail``), as the
reference wires it.

Initialisation: :func:`init_params` draws the weights ON THE DEVICE with
a ``torch.Generator`` seeded there, leaf by leaf and, for the stacks,
layer by layer (and expert by expert), writing straight into stacks of
the requested dtype: a host init of 46.7 B values, or an fp32 copy of a
bf16 stack, would not fit.  :func:`init_quantized_params` draws the same
values and quantizes each slice as it is drawn (int8 serving).  Their
values are not the JAX package's (``jax.random`` and torch draw
different numbers from a seed); tests carry the JAX init across with
``checkpoint/jax_params.py``.

Training: :func:`forward_with_aux` with ``train=True`` routes through the
MoE layer's training dispatch (``moe_dispatch``: "auto" is the einsum
capacity formulation, "grouped" the grouped-GEMM kernels and their
backward), and with ``remat`` each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with the
"nothing" policy: only the layer inputs are kept, the whole layer is
recomputed in the backward pass, the expert plan included: its stable
sort rebuilds the same plan).  The model's ``loss_fn`` is the
reference's: the fp32 cross-entropy of ``logits[:, :-1]`` plus the
layers' summed aux losses.

Depth on one 80 GB card: Mixtral-8x7B's 32 layers are 93.4 GB in bf16,
so bf16 serving runs a cut depth (``num_layers=16``); with int8 weights
(``quant.enabled``: int8 experts, projections and router, 47.7 GB in
all) the whole published model fits.
"""
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models import serving
from deepspeed_tpu_torch.models.llama import _rms_norm, rope
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              layer_params, maybe_stream,
                                              qdot, resolve_size, run_block,
                                              seeded_device_init)
from deepspeed_tpu_torch.moe.layer import MoEConfig, moe_layer
from deepspeed_tpu_torch.ops.attention import ATTENTION_IMPLS, causal_attention


@dataclass(frozen=True)
class MixtralConfig:
    """The reference's ``MixtralConfig``, same fields and defaults.  Only
    the "nothing" remat policy is ported (``check_remat_policy``)."""
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    d_model: int = 4096
    d_ff: int = 14336
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    #: None: drop-free at eval (capacity E / top_k of the tokens)
    eval_capacity_factor: "float | None" = None
    #: "auto" (einsum when training, grouped at eval), "einsum",
    #: "grouped"; the scheduler serves the grouped dispatch only
    moe_dispatch: str = "auto"
    aux_loss_coef: float = 0.01
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = False             # activation checkpointing per layer
    remat_policy: str = "nothing"   # the only policy ported ("nothing")
    attention_impl: str = "auto"    # auto | flash (kernel) | plain

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"MixtralConfig.attention_impl="
                             f"{self.attention_impl!r}: choose one of "
                             f"{ATTENTION_IMPLS}")
        if self.remat:
            check_remat_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def moe(self) -> MoEConfig:
        eval_cf = (self.eval_capacity_factor
                   if self.eval_capacity_factor is not None
                   else self.num_experts / self.top_k)
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         num_experts=self.num_experts, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         eval_capacity_factor=eval_cf,
                         aux_loss_coef=self.aux_loss_coef,
                         activation="silu_glu",
                         dispatch_mode=self.moe_dispatch)


MIXTRAL_SIZES = {
    "tiny": dict(vocab_size=256, max_seq_len=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, d_model=32, d_ff=64, num_experts=4, top_k=2),
    "1b-moe": dict(vocab_size=32000, max_seq_len=2048, num_layers=8,
                   num_heads=16, num_kv_heads=8, d_model=1024, d_ff=3584,
                   num_experts=8, top_k=2),
    "8x7b": dict(),
}


def _shapes(config: MixtralConfig) -> dict:
    """Leaf shapes and init scales (None: ones) of the params tree."""
    D, V, L = config.d_model, config.vocab_size, config.num_layers
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    E, F = config.num_experts, config.d_ff
    std = 0.02
    res = std / (2 * L) ** 0.5
    return {
        "wte": ((V, D), std),
        "blocks": {
            "attn_norm": ((L, D), None),
            "wq": ((L, D, H * hd), std),
            "wk": ((L, D, KV * hd), std),
            "wv": ((L, D, KV * hd), std),
            "wo": ((L, H * hd, D), res),
            "mlp_norm": ((L, D), None),
            "moe": {
                "router": ((L, D, E), std),
                "w_gate": ((L, E, D, F), std),
                "w_in": ((L, E, D, F), std),
                "w_out": ((L, E, F, D), res),
            },
        },
        "final_norm": ((D,), None),
        "lm_head": ((D, V), std),
    }


def init_params(config: MixtralConfig, seed: int = 0, device=None,
                dtype=None) -> dict:
    """Seeded normal init (the reference's scales: 0.02, and 0.02 /
    sqrt(2 L) for the residual projections ``wo`` and ``w_out``; norms
    ones), drawn on ``device`` (``None``: the GPU) into ``dtype`` (fp32
    when None).  Each stacked leaf fills one [layer (, expert)] slice at a
    time, so the fp32 draw never exceeds one slice.  Not the JAX package's
    values (see the module docstring)."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=False)


def init_quantized_params(config: MixtralConfig, seed: int = 0,
                          device=None, dtype=None) -> dict:
    """The int8 serving weights of :func:`init_params` drawn on the
    device: exactly ``block_quantize_int8`` of each >= 3-dim ``blocks``
    leaf of ``init_params(config, seed, device, dtype)`` (the projections,
    the router and the expert stacks, as ``QuantizedTensor``s dequantizing
    to ``dtype``), the rest as ``init_params`` gives it.  Each [layer (,
    expert)] slice is drawn, rounded to ``dtype``, quantized and written
    into preallocated int8 / fp32 stacks — the groups run along the last
    dim, so this is the reference engine's leaf-by-leaf load — and the
    peak is the int8 total plus one slice: Mixtral-8x7B's 30 GB bf16
    expert leaf never exists."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=True)


def embed(params, tokens, config: MixtralConfig):
    return params["wte"].to(config.torch_dtype)[tokens.long()]


def head(params, x, config: MixtralConfig):
    """Final RMSNorm + the (untied) LM head."""
    x = _rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return x @ params["lm_head"].to(x.dtype)


def _qkv(x, layer, config: MixtralConfig, positions=None):
    """RMSNorm + Q/K/V + rotary; x [B, S, D] -> q [B, S, H, hd], k/v
    [B, S, KV, hd] (KV heads not repeated: the caches stay compact)."""
    B, S, _ = x.shape
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    h = _rms_norm(x, layer["attn_norm"], config.rms_norm_eps)
    q = rope(qdot(h, layer["wq"]).reshape(B, S, H, hd), config.rope_theta,
             positions)
    kk = rope(qdot(h, layer["wk"]).reshape(B, S, KV, hd), config.rope_theta,
              positions)
    v = qdot(h, layer["wv"]).reshape(B, S, KV, hd)
    return q, kk, v


def _moe_finish(x, attn_flat, layer, config: MixtralConfig,
                train: bool = False):
    """Attention-out projection + residual + the routed-expert FFN +
    residual; returns (x, aux loss)."""
    x = x + qdot(attn_flat, layer["wo"])
    h = _rms_norm(x, layer["mlp_norm"], config.rms_norm_eps)
    moe_out, aux = moe_layer(layer["moe"], h, config.moe, train=train)
    return x + moe_out, aux


def _block(x, layer, config: MixtralConfig, train: bool, seg=None):
    """One decoder layer; x [B, S, D] -> (x, aux loss)."""
    B, S, _ = x.shape
    q, kk, v = _qkv(x, layer, config)
    attn = causal_attention(q, kk, v, impl=config.attention_impl,
                            segment_ids=seg)
    return _moe_finish(x, attn.reshape(B, S, -1), layer, config, train)


def forward_with_aux(params, batch, config: MixtralConfig,
                     train: bool = False):
    """Token ids [B, S] -> (logits [B, S, V], summed aux loss): the full
    causal forward, each layer under ``torch.utils.checkpoint`` with
    ``remat``."""
    x = embed(params, batch["input_ids"], config)
    seg = batch.get("segment_ids") if isinstance(batch, dict) else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(config.num_layers):
        layer = maybe_stream(layer_params(params["blocks"], l))
        x, a = run_block(_block, config.remat, x, layer, config, train, seg)
        aux = aux + a
    return head(params, x, config), aux


def loss_fn(params, batch, config: MixtralConfig):
    """The reference's Mixtral loss: the mean fp32 cross-entropy of
    ``logits[:, :-1]`` against ``input_ids[:, 1:]`` plus the summed aux
    losses of a training forward."""
    tokens = batch["input_ids"]
    logits, aux = forward_with_aux(params, batch, config, train=True)
    ce = F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                         tokens[:, 1:].long().flatten())
    return ce + aux


def fused_spec(config: MixtralConfig):
    """The fused-layer spec of a Mixtral layer, wired as the reference's
    (``mixtral.py:220-226``): RMSNorm, split Q/K/V, GQA, full rotary, no
    biases, no MLP (the expert FFN stays outside the kernel)."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import FusedLayerSpec
    return FusedLayerSpec(
        num_heads=config.num_heads, num_kv_heads=config.num_kv_heads,
        head_dim=config.head_dim, d_model=config.d_model, norm="rms",
        eps=config.rms_norm_eps, qkv="split", qkv_bias=False,
        out_bias=False, mlp="none", rotary_dims=config.head_dim,
        rope_theta=config.rope_theta)


def fused_weights(layer):
    """The attention half of a layer as the fused layer's canonical
    weights (the reference's ``fused_weights``)."""
    return {"n1_s": layer["attn_norm"], "wq": layer["wq"], "wk": layer["wk"],
            "wv": layer["wv"], "wo": layer["wo"]}


def moe_tail(x, layer, config: MixtralConfig):
    """RMSNorm + the routed-expert FFN + residual after the fused layer's
    attention half (the reference's ``moe_tail``): the experts stay on the
    grouped-GEMM kernels."""
    h = _rms_norm(x, layer["mlp_norm"], config.rms_norm_eps)
    return x + moe_layer(layer["moe"], h, config.moe, train=False)[0]


def _serving_fns(config: MixtralConfig):
    """(init_cache_fn, prefill_fn, decode_fn): the generic hook-driven
    serving forms (``models/serving.py``) with Mixtral's hooks (the
    reference's ``_serving_fns``, without the speculative verify form)."""
    spec = fused_spec(config)
    hooks = dict(
        embed_fn=lambda p, t: embed(p, t, config),
        qkv_fn=lambda x, layer, pos: _qkv(x, layer, config, pos),
        finish_fn=lambda x, a, layer: _moe_finish(x, a, layer, config)[0],
        head_fn=lambda p, x: head(p, x, config),
        num_heads=config.num_heads)

    def init_cache_fn(bs, max_len, dtype=None, device=None):
        dtype = config.torch_dtype if dtype is None else dtype
        if isinstance(dtype, str) and dtype != "int8":
            dtype = getattr(torch, dtype)
        return serving.init_cache(config.num_layers, config.num_kv_heads,
                                  config.head_dim, bs, max_len, dtype,
                                  device)

    def prefill_fn(p, b, c):
        return serving.prefill(p, b, c, attention_impl=config.attention_impl,
                               **hooks)

    def decode_fn(p, t, c, lengths, fused=False):
        return serving.decode_step(p, t, c, lengths, fused=fused,
                                   fused_spec=spec,
                                   fused_weights_fn=fused_weights,
                                   moe_tail_fn=lambda x, layer: moe_tail(
                                       x, layer, config), **hooks)

    return init_cache_fn, prefill_fn, decode_fn


def count_params(config: MixtralConfig) -> int:
    def n(spec):
        if isinstance(spec, dict):
            return sum(n(v) for v in spec.values())
        size = 1
        for d in spec[0]:
            size *= d
        return size
    return n(_shapes(config))


def mixtral_model(size: str = "8x7b", **overrides) -> Model:
    """``mixtral:<size>`` (tiny, 1b-moe, 8x7b) with config overrides, e.g.
    ``mixtral_model("8x7b", num_layers=16)``."""
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        mixtral_params_from_numpy
    cfg_kwargs = resolve_size(MIXTRAL_SIZES, size, "mixtral")
    cfg_kwargs.update(overrides)
    config = MixtralConfig(**cfg_kwargs)
    n_params = count_params(config)
    # active params per token: the dense part + top_k / E of the experts
    active = n_params - (1 - config.top_k / config.num_experts) * (
        3 * config.num_layers * config.num_experts * config.d_model
        * config.d_ff)
    init_cache_fn, prefill_fn, decode_fn = _serving_fns(config)
    return Model(
        config=config,
        init_fn=partial(init_params, config),
        quantized_init_fn=partial(init_quantized_params, config),
        params_from_numpy_fn=mixtral_params_from_numpy,
        apply_fn=lambda p, b: forward_with_aux(p, b, config)[0],
        loss_fn=partial(loss_fn, config=config),
        flops_per_token=6.0 * active,
        meta={"name": f"mixtral-{size}", "n_params": n_params,
              "active_params": active, "num_experts": config.num_experts},
        init_cache_fn=init_cache_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, fused_spec=fused_spec(config))
