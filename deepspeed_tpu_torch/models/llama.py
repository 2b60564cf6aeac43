"""Llama-2 / Llama-3-style decoder in PyTorch (counterpart of
``deepspeed_tpu/models/llama.py``): RMSNorm, rotary position embeddings
(the split-half pairing), grouped-query attention, a SwiGLU MLP;
``attn_bias`` gives the InternLM variant (biased q / k / v / o).

Plain functions over a params dict with the reference's names and
stacked layout: ``blocks`` leaves are [L, ...], every projection
``[in, out]`` (``x @ w``).  Mixtral reuses ``_rms_norm``, ``rope_freqs``
and ``rope``.

Serving goes through the generic hook-driven ``prefill`` / ``decode_step``
of ``models/serving.py``: prefill runs the flash forward per layer over
the compact GQA cache ([L, B, S, KV, hd]); a decode step either runs the
unfused composition (the new K/V written into the cache in place, the
decode-attention kernel, int8 projections through qgemm) or, with
``fused=True``, one fused-layer kernel per layer with the reference's
spec (RMSNorm, split Q/K/V, full rotary, GQA, SwiGLU).

Initialisation: :func:`init_params` draws the weights on the device from
a ``torch.Generator`` (``models/model.py seeded_device_init``), and
:func:`init_quantized_params` draws the same values and quantizes each
[layer] slice as it is drawn (int8 serving).  :func:`numpy_init_params`
is a copy of the reference's host init, so tests give both packages the
same weights.

Training differentiates :func:`forward` with autograd under the causal-LM
loss (``models/model.py default_lm_loss``); the flash kernels run forward
and backward at the model's head dim, GQA included, and with ``remat``
each layer runs under ``torch.utils.checkpoint`` (``run_block``, the
"nothing" policy).  Not ported here: LoRA serving (a ``lora=`` argument to
prefill / decode raises: ROADMAP.md Queue A: serving extensions), and the
speculative ``verify_fn`` (speculative decoding is refused by the serving
config: ROADMAP.md Queue A: serving extensions).
"""
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models import serving
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              layer_params, maybe_stream,
                                              qdot, resolve_size, run_block,
                                              seeded_device_init)
from deepspeed_tpu_torch.ops.attention import ATTENTION_IMPLS, causal_attention


def _rms_norm(x, scale, eps):
    """RMSNorm in fp32, cast back to the input dtype (the reference's).
    On the card the statistics come from ``F.rms_norm``'s kernel, one
    block per row, so a row's bits do not depend on the rows beside it:
    torch's ``mean`` over the last dim changes its summation order with
    the row count (``chip_smoke.py`` phase 21's
    ``row_0_equal_at_B_2_4_8``).  On the CPU the reference's
    arithmetic."""
    if x.device.type == "cuda":
        return F.rms_norm(x.float(), x.shape[-1:], scale.float(),
                          eps).to(x.dtype)
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(theta: float, head_dim: int, device=None):
    """``theta ** (-arange(hd/2) / (hd/2))`` as the reference computes it
    (jnp with x64 off): the exponent is an fp32 division, and the power is
    the fp32 value nearest the exact one (XLA's fp32 ``pow`` is correctly
    rounded; torch's fp32 ``pow`` can miss by one ulp, so it is evaluated
    on the fp32 operands in double and rounded once).  Not Python floats:
    their float64 exponent is another number."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.int32, device=device) / half
    # theta rounded to fp32 on the host: a device tensor built from a
    # Python number would be a blocking copy on every call
    base = float(torch.tensor(theta, dtype=torch.float32))
    return torch.pow(base, expo.double()).float()


def rope(x, theta: float, positions=None, interleaved: bool = False):
    """Rotary embeddings on [B, S, H, hd] (the reference's ``rope``).
    ``interleaved=False`` pairs dim i with i + hd/2 (the split-half
    pairing of Llama / NeoX / Mixtral); ``interleaved=True`` pairs (2i,
    2i + 1).  ``positions``: [S] (shared across the batch) or [B, S] (per
    row, decode)."""
    B, S, H, hd = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    freqs = rope_freqs(theta, hd, x.device)
    if positions.dim() == 1:
        angles = positions[:, None] * freqs[None, :]             # [S, hd/2]
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:
        angles = positions[:, :, None] * freqs[None, None, :]    # [B, S, hd/2]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(x.shape)
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@dataclass(frozen=True)
class LlamaConfig:
    """The reference's ``LlamaConfig``, same fields and defaults."""
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32          # < num_heads: grouped-query attention
    d_model: int = 4096
    d_mlp: int = 11008
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    #: InternLM variant: biased q / k / v / o projections
    attn_bias: bool = False
    dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "auto"    # auto | flash (kernel) | plain

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"LlamaConfig.attention_impl="
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


LLAMA_SIZES = {
    "tiny": dict(vocab_size=256, max_seq_len=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, d_model=32, d_mlp=64),
    "7b": dict(num_layers=32, num_heads=32, num_kv_heads=32, d_model=4096,
               d_mlp=11008),
    "13b": dict(num_layers=40, num_heads=40, num_kv_heads=40, d_model=5120,
                d_mlp=13824),
    "70b": dict(num_layers=80, num_heads=64, num_kv_heads=8, d_model=8192,
                d_mlp=28672),
}


def _shapes(config: LlamaConfig) -> dict:
    """Leaf shapes and init scales (None: ones, 0: zeros) of the params
    tree, the reference's scales: 0.02, and 0.02 / sqrt(2 L) for the
    residual projections ``wo`` and ``w_down``."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    std = 0.02
    res = std / (2 * L) ** 0.5
    blocks = {
        "attn_norm": ((L, D), None),
        "wq": ((L, D, H * hd), std),
        "wk": ((L, D, KV * hd), std),
        "wv": ((L, D, KV * hd), std),
        "wo": ((L, H * hd, D), res),
        "mlp_norm": ((L, D), None),
        "w_gate": ((L, D, M), std),
        "w_up": ((L, D, M), std),
        "w_down": ((L, M, D), res),
    }
    if config.attn_bias:
        blocks.update(wq_b=((L, H * hd), 0), wk_b=((L, KV * hd), 0),
                      wv_b=((L, KV * hd), 0), wo_b=((L, D), 0))
    return {"wte": ((V, D), std), "blocks": blocks,
            "final_norm": ((D,), None), "lm_head": ((D, V), std)}


def numpy_init_params(config: LlamaConfig, seed: int = 0) -> dict:
    """Host-side init with numpy's PCG64, a copy of the reference's
    ``numpy_init_params``: the same seed gives the same values as
    ``deepspeed_tpu.models.llama.numpy_init_params``."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    rng = np.random.default_rng(seed)
    std = 0.02
    res_std = std / (2 * L) ** 0.5

    def norm(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    blocks = {
        "attn_norm": np.ones((L, D), np.float32),
        "wq": norm((L, D, H * hd), std),
        "wk": norm((L, D, KV * hd), std),
        "wv": norm((L, D, KV * hd), std),
        "wo": norm((L, H * hd, D), res_std),
        "mlp_norm": np.ones((L, D), np.float32),
        "w_gate": norm((L, D, M), std),
        "w_up": norm((L, D, M), std),
        "w_down": norm((L, M, D), res_std),
    }
    if config.attn_bias:
        blocks.update({"wq_b": np.zeros((L, H * hd), np.float32),
                       "wk_b": np.zeros((L, KV * hd), np.float32),
                       "wv_b": np.zeros((L, KV * hd), np.float32),
                       "wo_b": np.zeros((L, D), np.float32)})
    return {
        "wte": norm((V, D), std),
        "blocks": blocks,
        "final_norm": np.ones((D,), np.float32),
        "lm_head": norm((D, V), std),
    }


def init_params(config: LlamaConfig, seed: int = 0, device=None,
                dtype=None) -> dict:
    """Seeded normal init (the reference's scales; norms ones, biases
    zeros) drawn on ``device`` (``None``: the GPU) into ``dtype`` (fp32
    when None), one [layer] slice at a time.  Not the JAX package's
    values (see the module docstring)."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=False)


def init_quantized_params(config: LlamaConfig, seed: int = 0, device=None,
                          dtype=None) -> dict:
    """The int8 serving weights of :func:`init_params` drawn on the
    device: ``block_quantize_int8`` of each [layer] slice of the seven
    projection stacks as it is drawn (``QuantizedTensor``s dequantizing to
    ``dtype``), the rest as ``init_params`` gives it."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=True)


def embed(params, tokens, config: LlamaConfig):
    return params["wte"].to(config.torch_dtype)[tokens.long()]


def head(params, x, config: LlamaConfig):
    """Final RMSNorm + the (untied) LM head."""
    x = _rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return qdot(x, params["lm_head"])


def _block_qkv(x, layer, config: LlamaConfig, positions=None):
    """RMSNorm + Q/K/V (+ biases) + rotary; x [B, S, D] -> q [B, S, H,
    hd], k/v [B, S, KV, hd] (KV heads not repeated: the caches stay
    compact)."""
    B, S, _ = x.shape
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    h = _rms_norm(x, layer["attn_norm"], config.rms_norm_eps)
    dt = h.dtype
    q, kk, v = qdot(h, layer["wq"]), qdot(h, layer["wk"]), qdot(h, layer["wv"])
    if config.attn_bias:
        q = q + layer["wq_b"].to(dt)
        kk = kk + layer["wk_b"].to(dt)
        v = v + layer["wv_b"].to(dt)
    q = rope(q.reshape(B, S, H, hd), config.rope_theta, positions)
    kk = rope(kk.reshape(B, S, KV, hd), config.rope_theta, positions)
    return q, kk, v.reshape(B, S, KV, hd)


def _block_finish(x, attn_flat, layer, config: LlamaConfig):
    """Attention-out projection (+ bias) + residual, then RMSNorm + the
    SwiGLU MLP + residual."""
    attn_out = qdot(attn_flat, layer["wo"])
    if config.attn_bias:
        attn_out = attn_out + layer["wo_b"].to(x.dtype)
    x = x + attn_out
    h = _rms_norm(x, layer["mlp_norm"], config.rms_norm_eps)
    gated = F.silu(qdot(h, layer["w_gate"])) * qdot(h, layer["w_up"])
    return x + qdot(gated, layer["w_down"])


def _block(x, layer, config: LlamaConfig, seg=None):
    """One decoder layer of the full causal forward; x [B, S, D]."""
    B, S, _ = x.shape
    q, kk, v = _block_qkv(x, layer, config)
    attn = causal_attention(q, kk, v, impl=config.attention_impl,
                            segment_ids=seg)
    return _block_finish(x, attn.reshape(B, S, -1), layer, config)


def forward(params, batch, config: LlamaConfig):
    """Token ids [B, S] -> logits [B, S, V]: the full causal forward (the
    training forward, each layer under ``torch.utils.checkpoint`` with
    ``remat``; the tests' oracle)."""
    x = embed(params, batch["input_ids"], config)
    seg = batch.get("segment_ids") if isinstance(batch, dict) else None
    for l in range(config.num_layers):
        x = run_block(_block, config.remat, x,
                      maybe_stream(layer_params(params["blocks"], l)),
                      config, seg)
    return head(params, x, config)


def fused_spec(config: LlamaConfig):
    """The fused-layer spec of a Llama layer, the reference's
    (``llama.py:290-296``): RMSNorm, split Q/K/V (biased for
    ``attn_bias``), full rotary, GQA, SwiGLU."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import FusedLayerSpec
    return FusedLayerSpec(
        num_heads=config.num_heads, num_kv_heads=config.num_kv_heads,
        head_dim=config.head_dim, d_model=config.d_model, norm="rms",
        eps=config.rms_norm_eps, qkv="split", qkv_bias=config.attn_bias,
        out_bias=config.attn_bias, mlp="swiglu", mlp_bias=False,
        rotary_dims=config.head_dim, rope_theta=config.rope_theta)


def fused_weights(layer, config: LlamaConfig):
    """One layer's params as the fused layer's canonical weights (the
    reference's ``fused_weights``)."""
    cw = {"n1_s": layer["attn_norm"], "wq": layer["wq"], "wk": layer["wk"],
          "wv": layer["wv"], "wo": layer["wo"], "n2_s": layer["mlp_norm"],
          "w_gate": layer["w_gate"], "w_up": layer["w_up"],
          "w_down": layer["w_down"]}
    if config.attn_bias:
        cw.update(bq=layer["wq_b"], bk=layer["wk_b"], bv=layer["wv_b"],
                  bo=layer["wo_b"])
    return cw


def _refuse_lora(lora):
    if lora is not None:
        raise NotImplementedError(
            "Llama LoRA serving (lora=): not ported to deepspeed_tpu_torch "
            "yet (ROADMAP.md Queue A: serving extensions)")


def _serving_fns(config: LlamaConfig):
    """(init_cache_fn, prefill_fn, decode_fn): the generic hook-driven
    serving forms (``models/serving.py``) with Llama's hooks and fused
    spec (the reference's ``_serving_fns``, without the speculative verify
    form)."""
    spec = fused_spec(config)
    hooks = dict(
        embed_fn=lambda p, t: embed(p, t, config),
        qkv_fn=lambda x, layer, pos: _block_qkv(x, layer, config, pos),
        finish_fn=lambda x, a, layer: _block_finish(x, a, layer, config),
        head_fn=lambda p, x: head(p, x, config),
        num_heads=config.num_heads)

    def init_cache_fn(bs, max_len, dtype=None, device=None):
        dtype = config.torch_dtype if dtype is None else dtype
        if isinstance(dtype, str) and dtype != "int8":
            dtype = getattr(torch, dtype)
        return serving.init_cache(config.num_layers, config.num_kv_heads,
                                  config.head_dim, bs, max_len, dtype,
                                  device)

    def prefill_fn(p, b, c, lora=None):
        _refuse_lora(lora)
        return serving.prefill(p, b, c, attention_impl=config.attention_impl,
                               **hooks)

    def decode_fn(p, t, c, lengths, fused=False, lora=None):
        _refuse_lora(lora)
        return serving.decode_step(
            p, t, c, lengths, fused=fused, fused_spec=spec,
            fused_weights_fn=lambda layer: fused_weights(layer, config),
            **hooks)

    return init_cache_fn, prefill_fn, decode_fn


def count_params(config: LlamaConfig) -> int:
    """The reference's ``count_params`` (its formula counts no
    ``attn_bias`` biases)."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    per_layer = 2 * D + D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * M
    return V * D + L * per_layer + D + D * V


def llama_model(size: str = "7b", **overrides) -> Model:
    """``llama:<size>`` (tiny, 7b, 13b, 70b) with config overrides, e.g.
    ``llama_model("7b", num_layers=4)``."""
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        llama_params_from_numpy
    cfg_kwargs = resolve_size(LLAMA_SIZES, size, "llama")
    cfg_kwargs.update(overrides)
    config = LlamaConfig(**cfg_kwargs)
    n_params = count_params(config)
    init_cache_fn, prefill_fn, decode_fn = _serving_fns(config)
    return Model(
        config=config,
        init_fn=partial(init_params, config),
        quantized_init_fn=partial(init_quantized_params, config),
        numpy_init_fn=partial(numpy_init_params, config),
        params_from_numpy_fn=llama_params_from_numpy,
        apply_fn=lambda p, b: forward(p, b, config),
        flops_per_token=6.0 * n_params,
        meta={"name": f"llama-{size}", "n_params": n_params},
        init_cache_fn=init_cache_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, fused_spec=fused_spec(config))
