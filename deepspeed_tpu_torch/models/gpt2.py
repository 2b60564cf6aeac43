"""GPT-2 family in PyTorch (counterpart of ``deepspeed_tpu/models/gpt2.py``).

Plain functions over a params dict with the reference's names and
stacked ``[L, ...]`` block layout; projection weights keep the
reference's ``[in, out]`` orientation (``x @ w``).  Serving: prefill runs
the flash forward per layer (int8 weights dequantize per layer first, as
the reference's ``maybe_stream``); a decode step either runs the
reference's unfused composition — QKV, the new K/V written into the cache
in place, the decode-attention kernel, the finish, with int8 projections
through the qgemm kernel — or, with ``fused=True``, one fused-layer
kernel per layer.  An int8 cache quantizes each new K/V vector
(``quantize_kv``).  GPT-Neo serves through two hooks of these functions
(the reference's): a prefill ``attn_fn`` and, at decode, ``sm_scale``
and a per-layer window floor ``min_pos_fn`` for the decode kernel.
Training differentiates ``forward`` with autograd; with ``remat`` each
layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` with the "nothing" policy: only the layer inputs are
kept, the whole layer, flash forward included, is recomputed in the
backward pass).
"""
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              layer_params, maybe_stream,
                                              qdot, resolve_size, run_block)
from deepspeed_tpu_torch.models.serving import (_fused_layer_pass,
                                                fused_decode_active,
                                                qgemm_active, write_token)
from deepspeed_tpu_torch.models.serving import init_cache as _init_cache
from deepspeed_tpu_torch.ops.attention import ATTENTION_IMPLS, causal_attention
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, quantize_kv, quantize_prefill_into_cache)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"          # compute dtype
    remat: bool = False             # activation checkpointing per layer
    remat_policy: str = "nothing"   # the only policy ported ("nothing")
    attention_impl: str = "auto"    # auto | flash (kernel) | plain (einsum)
    activation: str = "gelu"        # gelu (tanh approx) | gelu_exact | relu
    mlp_dim: int = 0                # 0 = the GPT-2 default 4*d_model

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"GPT2Config.attention_impl="
                             f"{self.attention_impl!r}: choose one of "
                             f"{ATTENTION_IMPLS}")
        if self.remat:
            check_remat_policy(self.remat_policy)

    @property
    def d_mlp(self) -> int:
        return self.mlp_dim or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


GPT2_SIZES = {
    "125m": dict(num_layers=12, num_heads=12, d_model=768),
    "350m": dict(num_layers=24, num_heads=16, d_model=1024),
    "760m": dict(num_layers=24, num_heads=16, d_model=1536),
    "1.3b": dict(num_layers=24, num_heads=32, d_model=2048),
    "2.7b": dict(num_layers=32, num_heads=32, d_model=2560),
    "6.7b": dict(num_layers=32, num_heads=32, d_model=4096),
    "13b": dict(num_layers=40, num_heads=40, d_model=5120),
}


def numpy_init_params(config: GPT2Config, seed: int = 0) -> dict:
    """Host-side init with numpy's PCG64, a copy of the reference's
    ``numpy_init_params``: the same seed gives the same values as
    ``deepspeed_tpu.models.gpt2.numpy_init_params``."""
    D, V, S, L, M = (config.d_model, config.vocab_size, config.max_seq_len,
                     config.num_layers, config.d_mlp)
    rng = np.random.default_rng(seed)
    std = 0.02
    res_std = std / (2 * L) ** 0.5

    def norm(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    return {
        "wte": norm((V, D), std),
        "wpe": norm((S, D), std),
        "blocks": {
            "ln1_scale": np.ones((L, D), np.float32),
            "ln1_bias": np.zeros((L, D), np.float32),
            "qkv_w": norm((L, D, 3 * D), std),
            "qkv_b": np.zeros((L, 3 * D), np.float32),
            "proj_w": norm((L, D, D), res_std),
            "proj_b": np.zeros((L, D), np.float32),
            "ln2_scale": np.ones((L, D), np.float32),
            "ln2_bias": np.zeros((L, D), np.float32),
            "mlp_in_w": norm((L, D, M), std),
            "mlp_in_b": np.zeros((L, M), np.float32),
            "mlp_out_w": norm((L, M, D), res_std),
            "mlp_out_b": np.zeros((L, D), np.float32),
        },
        "lnf_scale": np.ones((D,), np.float32),
        "lnf_bias": np.zeros((D,), np.float32),
    }


def param_shapes(config: GPT2Config) -> dict:
    """Leaf shapes and init scales of :func:`numpy_init_params` (None:
    ones, 0: zeros) for ``models/model.py seeded_device_init``: a tree
    too large for the host init is drawn on the device (GPT-Neo 2.7B)."""
    D, V, S, L, M = (config.d_model, config.vocab_size, config.max_seq_len,
                     config.num_layers, config.d_mlp)
    std = 0.02
    res = std / (2 * L) ** 0.5
    return {
        "wte": ((V, D), std), "wpe": ((S, D), std),
        "blocks": {
            "ln1_scale": ((L, D), None), "ln1_bias": ((L, D), 0),
            "qkv_w": ((L, D, 3 * D), std), "qkv_b": ((L, 3 * D), 0),
            "proj_w": ((L, D, D), res), "proj_b": ((L, D), 0),
            "ln2_scale": ((L, D), None), "ln2_bias": ((L, D), 0),
            "mlp_in_w": ((L, D, M), std), "mlp_in_b": ((L, M), 0),
            "mlp_out_w": ((L, M, D), res), "mlp_out_b": ((L, D), 0)},
        "lnf_scale": ((D,), None), "lnf_bias": ((D,), 0)}


def _layer_norm(x, scale, bias, eps):
    """fp32 statistics, output in the input dtype (the reference's).  On
    the card the statistics come from ``F.layer_norm``'s kernel, one block
    per row, so a row's bits do not depend on the rows beside it: torch's
    ``mean`` over the last dim changes its summation order with the row
    count (``chip_smoke.py`` phase 21's ``row_0_equal_at_B_2_4_8``),
    which parts a decode batch from the one-row static generate.  On the
    CPU the reference's arithmetic (the fused layer's plain version
    shares it)."""
    if x.device.type == "cuda":
        return F.layer_norm(x.float(), x.shape[-1:], scale.float(),
                            bias.float(), eps).to(x.dtype)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _block_qkv(x, layer, config: GPT2Config):
    """LN1 + QKV projection; x [B, S, D] -> q/k/v [B, S, H, hd] (views
    of one fused projection output)."""
    H, hd = config.num_heads, config.head_dim
    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"],
                    config.layer_norm_eps)
    qkv = qdot(h, layer["qkv_w"]) + layer["qkv_b"].to(h.dtype)
    q, kk, v = qkv.split(config.d_model, dim=-1)
    return (q.unflatten(-1, (H, hd)), kk.unflatten(-1, (H, hd)),
            v.unflatten(-1, (H, hd)))


def _activation(h, config: GPT2Config):
    if config.activation == "relu":
        return F.relu(h)
    if config.activation == "gelu_exact":
        return F.gelu(h)
    return F.gelu(h, approximate="tanh")


def _block_finish(x, attn, layer, config: GPT2Config):
    """Post-attention half: proj + residual + MLP; x/attn [..., D]."""
    proj = qdot(attn, layer["proj_w"]) + layer["proj_b"].to(x.dtype)
    x = x + proj
    h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"],
                    config.layer_norm_eps)
    h = qdot(h, layer["mlp_in_w"]) + layer["mlp_in_b"].to(h.dtype)
    h = _activation(h, config)
    return x + (qdot(h, layer["mlp_out_w"])
                + layer["mlp_out_b"].to(x.dtype))


def embed(params, batch, config: GPT2Config):
    tokens = batch["input_ids"]
    dtype = config.torch_dtype
    S = tokens.shape[1]
    return (params["wte"].to(dtype)[tokens.long()]
            + params["wpe"].to(dtype)[:S])


def head(params, x, config: GPT2Config):
    """Final LN + tied-embedding logits."""
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"],
                    config.layer_norm_eps)
    return x @ params["wte"].to(x.dtype).T


def _block(x, layer, config: GPT2Config, segment_ids=None):
    """One transformer block; x [B, S, D]."""
    B, S, D = x.shape
    q, kk, v = _block_qkv(x, layer, config)
    attn = causal_attention(q, kk, v, impl=config.attention_impl,
                            segment_ids=segment_ids)
    return _block_finish(x, attn.reshape(B, S, D), layer, config)


def forward(params, batch, config: GPT2Config):
    """Token ids [B, S] -> logits [B, S, V] (full causal forward)."""
    x = embed(params, batch, config)
    seg = batch.get("segment_ids") if isinstance(batch, dict) else None
    for l in range(config.num_layers):
        x = run_block(_block, config.remat, x,
                      layer_params(params["blocks"], l), config, seg)
    return head(params, x, config)


def init_cache(config: GPT2Config, batch_size: int, max_len: int,
               dtype=None, device=None):
    """``dtype="int8"`` selects the quantized cache (int8 payload plus one
    fp32 scale per cached head vector)."""
    dtype = config.torch_dtype if dtype is None else dtype
    if isinstance(dtype, str) and dtype != "int8":
        dtype = getattr(torch, dtype)
    return _init_cache(config.num_layers, config.num_heads, config.head_dim,
                       batch_size, max_len, dtype, device)


def _fused_spec(config: GPT2Config, sm_scale=None):
    """The fused-layer spec of a GPT-2 layer: LayerNorm, fused QKV with
    bias, serial residual, the configured activation."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import FusedLayerSpec
    mlp = {"gelu": "gelu_tanh", "gelu_exact": "gelu_exact",
           "relu": "relu"}.get(config.activation, "gelu_tanh")
    return FusedLayerSpec(
        num_heads=config.num_heads, num_kv_heads=config.num_heads,
        head_dim=config.head_dim, d_model=config.d_model, norm="ln",
        eps=config.layer_norm_eps, qkv="fused", qkv_bias=True,
        out_bias=True, mlp=mlp, mlp_bias=True, sm_scale=sm_scale)


def _fused_weights(layer):
    return {"n1_s": layer["ln1_scale"], "n1_b": layer["ln1_bias"],
            "wqkv": layer["qkv_w"], "bqkv": layer["qkv_b"],
            "wo": layer["proj_w"], "bo": layer["proj_b"],
            "n2_s": layer["ln2_scale"], "n2_b": layer["ln2_bias"],
            "w_in": layer["mlp_in_w"], "b_in": layer["mlp_in_b"],
            "w_out": layer["mlp_out_w"], "b_out": layer["mlp_out_b"]}


def prefill(params, batch, cache, config: GPT2Config, attn_fn=None):
    """Causal forward over (right-padded) prompts [B, S], filling cache
    positions [0, S) in place (an int8 cache gets the quantized K/V).
    Int8 weights dequantize per layer (``maybe_stream``) for the torch
    matmuls.  ``attn_fn(q, k, v, layer_idx)`` replaces the causal
    attention (GPT-Neo's banded, unscaled form).  Returns (logits [B, S,
    V], cache)."""
    x = embed(params, batch, config)
    B, S, D = x.shape
    quantized = "k_s" in cache
    for l in range(config.num_layers):
        layer = maybe_stream(layer_params(params["blocks"], l))
        q, kk, v = _block_qkv(x, layer, config)
        attn = (causal_attention(q, kk, v, impl=config.attention_impl)
                if attn_fn is None else attn_fn(q, kk, v, l))
        # in place: this layer's prompt K/V straight into the cache
        if quantized:
            quantize_prefill_into_cache(
                {name: c[l:l + 1] for name, c in cache.items()}, kk[None],
                v[None])
        else:
            cache["k"][l, :, :S] = kk
            cache["v"][l, :, :S] = v
        x = _block_finish(x, attn.reshape(B, S, D), layer, config)
    return head(params, x, config), cache


def decode_step(params, tokens, cache, lengths, config: GPT2Config,
                fused: bool = False, sm_scale=None, min_pos_fn=None):
    """One decode step.  tokens [B], lengths [B] int32 = current cache
    fill per row (the new token's position).  Writes the new K/V into
    ``cache`` in place and returns (logits [B, V], cache).  ``fused``:
    one fused-layer kernel per layer; otherwise the reference's unfused
    branch, int8 projections through qgemm (``keep_quantized``).
    GPT-Neo's hooks: ``sm_scale`` overrides the score scale and
    ``min_pos_fn(layer_idx, lengths) -> [B] int32`` gives each layer's
    window floor to the decode kernel; a ``min_pos_fn`` keeps the unfused
    path (no fused spec takes a window), so ``fused`` raises with one."""
    B = tokens.shape[0]
    D = config.d_model
    dtype = config.torch_dtype
    x = (params["wte"].to(dtype)[tokens.long()]
         + params["wpe"].to(dtype)[lengths.long()])               # [B, D]
    spec = _fused_spec(config, sm_scale) if min_pos_fn is None else None
    if fused_decode_active(spec, fused):
        x, cache = _fused_layer_pass(params, x[:, None, :], cache, lengths,
                                     spec=spec, weights_fn=_fused_weights)
        return head(params, x, config)[:, 0], cache
    quantized = "k_s" in cache
    keep_q = qgemm_active(params["blocks"])
    kc, vc = cache["k"], cache["v"]
    fill = (lengths + 1).to(torch.int32)
    for l in range(config.num_layers):
        layer = maybe_stream(layer_params(params["blocks"], l),
                             keep_quantized=keep_q)
        q, kk, v = _block_qkv(x[:, None, :], layer, config)
        if quantized:
            kq, ks1 = quantize_kv(kk[:, 0])
            vq, vs1 = quantize_kv(v[:, 0])
            write_token(kc, l, kq, lengths)
            write_token(vc, l, vq, lengths)
            write_token(cache["k_s"], l, ks1, lengths)
            write_token(cache["v_s"], l, vs1, lengths)
            kw = dict(k_scale=cache["k_s"][l], v_scale=cache["v_s"][l])
        else:
            write_token(kc, l, kk[:, 0], lengths)
            write_token(vc, l, v[:, 0], lengths)
            kw = {}
        if min_pos_fn is not None:
            kw["min_pos"] = min_pos_fn(l, lengths)
        attn = decode_attention(q[:, 0].contiguous(), kc[l], vc[l], fill,
                                sm_scale=sm_scale, **kw)
        x = _block_finish(x, attn.reshape(B, D).to(x.dtype), layer, config)
    return head(params, x[:, None, :], config)[:, 0], cache


def count_params(config: GPT2Config) -> int:
    D, V, S, L, M = (config.d_model, config.vocab_size, config.max_seq_len,
                     config.num_layers, config.d_mlp)
    per_layer = 4 * D + 3 * D * D + 3 * D + D * D + D + 2 * D * M + M + D
    return V * D + S * D + L * per_layer + 2 * D


def gpt2_model(size: str = "125m", **overrides) -> Model:
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        gpt2_params_from_numpy
    cfg_kwargs = resolve_size(GPT2_SIZES, size, "gpt2")
    cfg_kwargs.update(overrides)
    config = GPT2Config(**cfg_kwargs)
    n_params = count_params(config)
    return Model(
        config=config,
        flops_per_token=6.0 * n_params,
        meta={"name": f"gpt2-{size}", "n_params": n_params},
        numpy_init_fn=partial(numpy_init_params, config),
        params_from_numpy_fn=gpt2_params_from_numpy,
        apply_fn=lambda p, b: forward(p, b, config),
        init_cache_fn=lambda bs, ml, dtype=None, device=None: init_cache(
            config, bs, ml, dtype, device),
        prefill_fn=lambda p, b, c: prefill(p, b, c, config),
        decode_fn=lambda p, t, c, l, fused=False: decode_step(
            p, t, c, l, config, fused=fused),
        fused_spec=_fused_spec(config),
    )
