"""GPT-NeoX-style decoder in PyTorch (counterpart of
``deepspeed_tpu/models/neox.py``: Pythia / GPT-NeoX-20B): LayerNorm with
biases, a fused QKV projection packed head-major (per head [q | k | v])
with PARTIAL rotary embeddings (the first ``rotary_ndims`` of each head
rotate, split-half pairing; the rest pass through), a biased exact-GELU
MLP, and the parallel attention + MLP residual.  ``rotary_interleaved``
and ``head_bias`` are the GPT-J variants (rotate-every-two pairing, a
biased untied head); they run the unfused path.

Plain functions over a params dict with the reference's names and
stacked ``[L, ...]`` layout (every projection ``[in, out]``, ``x @ w``).
``rope`` comes from the port's ``models/llama.py``, as the reference's
``neox.py`` takes it from its ``llama.py``.

Serving goes through the generic hook-driven ``prefill`` /
``decode_step`` of ``models/serving.py``: prefill runs the flash forward
per layer; a decode step runs the unfused composition (decode-attention
kernel, int8 projections through qgemm) or, with ``fused=True``, one
fused-layer kernel per layer with the reference's spec (head-major QKV,
partial rotary, exact GELU, the parallel residual).

Initialisation: :func:`init_params` draws the weights on the device
(``models/model.py seeded_device_init``; GPT-NeoX-20B is 82 GB in fp32,
so it is never built on the host), :func:`init_quantized_params` draws
the same values and quantizes each [layer] slice of the four projection
stacks as it is drawn; :func:`numpy_init_params` is a host init with the
reference's scales, for the tests (the reference draws with
``jax.random``, so the tests hand the same numpy tree to both packages).
Training differentiates :func:`forward` under the causal-LM loss, the
flash kernels forward and backward; with ``remat`` each layer runs under
``torch.utils.checkpoint`` (``run_block``, the "nothing" policy).
"""
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models import serving
from deepspeed_tpu_torch.models.gpt2 import _layer_norm
from deepspeed_tpu_torch.models.llama import rope
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              layer_params, maybe_stream,
                                              numpy_seeded_init, qdot,
                                              resolve_size, run_block,
                                              seeded_device_init)
from deepspeed_tpu_torch.ops.attention import ATTENTION_IMPLS, causal_attention


@dataclass(frozen=True)
class NeoXConfig:
    """The reference's ``NeoXConfig``, same fields and defaults."""
    vocab_size: int = 50432
    max_seq_len: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    d_model: int = 512
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    #: HF GPT-NeoX's hidden_act "gelu" is the exact erf GELU
    gelu_approximate: bool = False
    #: GPT-J variants: the rotate-every-two rotary pairing and the biased
    #: untied head
    rotary_interleaved: bool = False
    head_bias: bool = False
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "auto"    # auto | flash (kernel) | plain

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"NeoXConfig.attention_impl="
                             f"{self.attention_impl!r}: choose one of "
                             f"{ATTENTION_IMPLS}")
        if self.remat:
            check_remat_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def d_mlp(self) -> int:
        return 4 * self.d_model

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


NEOX_SIZES = {
    "tiny": dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=4,
                 d_model=32),
    "pythia-160m": dict(vocab_size=50304, max_seq_len=2048, num_layers=12,
                        num_heads=12, d_model=768),
    "20b": dict(vocab_size=50432, max_seq_len=2048, num_layers=44,
                num_heads=64, d_model=6144, rotary_pct=0.25),
}


def _shapes(config: NeoXConfig) -> dict:
    """Leaf shapes and init scales (None: ones, 0: zeros) of the params
    tree, the reference's: 0.02, and 0.02 / sqrt(2 L) for ``dense_w`` and
    ``mlp_out_w``."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    std = 0.02
    res = std / (2 * L) ** 0.5
    tree = {
        "wte": ((V, D), std),
        "blocks": {
            "ln1_scale": ((L, D), None), "ln1_bias": ((L, D), 0),
            "ln2_scale": ((L, D), None), "ln2_bias": ((L, D), 0),
            "qkv_w": ((L, D, 3 * D), std), "qkv_b": ((L, 3 * D), 0),
            "dense_w": ((L, D, D), res), "dense_b": ((L, D), 0),
            "mlp_in_w": ((L, D, M), std), "mlp_in_b": ((L, M), 0),
            "mlp_out_w": ((L, M, D), res), "mlp_out_b": ((L, D), 0)},
        "lnf_scale": ((D,), None), "lnf_bias": ((D,), 0),
        "embed_out": ((D, V), std)}
    if config.head_bias:
        tree["embed_out_b"] = ((V,), 0)
    return tree


def numpy_init_params(config: NeoXConfig, seed: int = 0) -> dict:
    """Host init with numpy's PCG64 at the reference's scales (the tests'
    weights, handed to both packages)."""
    return numpy_seeded_init(_shapes(config), seed)


def init_params(config: NeoXConfig, seed: int = 0, device=None,
                dtype=None) -> dict:
    """Seeded normal init drawn on ``device`` (``None``: the GPU) into
    ``dtype`` (fp32 when None), one [layer] slice at a time."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=False)


def init_quantized_params(config: NeoXConfig, seed: int = 0, device=None,
                          dtype=None) -> dict:
    """:func:`init_params` with the four projection stacks int8
    (``block_quantize_int8`` of each [layer] slice as it is drawn)."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=True)


#: the reference's ``_ln`` (fp32 statistics, output in the input dtype):
#: GPT-2's LayerNorm, row-independent on the card
_ln = _layer_norm


def _partial_rope(x, config: NeoXConfig, positions=None):
    """Rotate the first ``rotary_ndims`` of each head, pass the rest."""
    rot = config.rotary_ndims
    il = config.rotary_interleaved
    if rot >= x.shape[-1]:
        return rope(x, config.rope_theta, positions, interleaved=il)
    xr = rope(x[..., :rot], config.rope_theta, positions, interleaved=il)
    return torch.cat([xr, x[..., rot:]], dim=-1)


def _block_qkv(x, layer, config: NeoXConfig, positions=None):
    """LN1 + fused QKV (head-major [q|k|v] packing) + partial rotary; x
    [B, S, D] -> q / k / v [B, S, H, hd]."""
    H, hd = config.num_heads, config.head_dim
    h1 = _ln(x, layer["ln1_scale"], layer["ln1_bias"],
             config.layer_norm_eps)
    qkv = qdot(h1, layer["qkv_w"]) + layer["qkv_b"].to(x.dtype)
    q, kk, v = qkv.unflatten(-1, (H, 3 * hd)).split(hd, dim=-1)
    return (_partial_rope(q, config, positions),
            _partial_rope(kk, config, positions), v)


def _block_finish(x, attn_flat, layer, config: NeoXConfig):
    """Output projection + MLP with the parallel (norm2 over x; (x +
    attn) + mlp) or serial residual."""
    dt = x.dtype
    attn_out = qdot(attn_flat, layer["dense_w"]) + layer["dense_b"].to(dt)
    h2_in = x if config.use_parallel_residual else x + attn_out
    h2 = _ln(h2_in, layer["ln2_scale"], layer["ln2_bias"],
             config.layer_norm_eps)
    m = F.gelu(qdot(h2, layer["mlp_in_w"]) + layer["mlp_in_b"].to(dt),
               approximate="tanh" if config.gelu_approximate else "none")
    mlp_out = qdot(m, layer["mlp_out_w"]) + layer["mlp_out_b"].to(dt)
    if config.use_parallel_residual:
        return x + attn_out + mlp_out
    return h2_in + mlp_out


def embed(params, tokens, config: NeoXConfig):
    return params["wte"].to(config.torch_dtype)[tokens.long()]


def head(params, x, config: NeoXConfig):
    """Final LN + the untied head (+ its bias, GPT-J)."""
    x = _ln(x, params["lnf_scale"], params["lnf_bias"], config.layer_norm_eps)
    logits = x @ params["embed_out"].to(x.dtype)
    if config.head_bias:
        logits = logits + params["embed_out_b"].to(x.dtype)
    return logits


def _block(x, layer, config: NeoXConfig, seg=None):
    """One layer of the full causal forward; x [B, S, D]."""
    B, S, _ = x.shape
    q, kk, v = _block_qkv(x, layer, config)
    attn = causal_attention(q, kk, v, impl=config.attention_impl,
                            segment_ids=seg)
    return _block_finish(x, attn.reshape(B, S, -1), layer, config)


def forward(params, batch, config: NeoXConfig):
    """Token ids [B, S] -> logits [B, S, V] (the full causal forward, each
    layer under ``torch.utils.checkpoint`` with ``remat``)."""
    x = embed(params, batch["input_ids"], config)
    seg = batch.get("segment_ids") if isinstance(batch, dict) else None
    for l in range(config.num_layers):
        x = run_block(_block, config.remat, x,
                      maybe_stream(layer_params(params["blocks"], l)),
                      config, seg)
    return head(params, x, config)


def count_params(config: NeoXConfig) -> int:
    """The reference's ``count_params``."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    per_layer = 4 * D + 3 * D * D + 3 * D + D * D + D + D * M + M + M * D + D
    return (V * D + L * per_layer + 2 * D + D * V
            + (V if config.head_bias else 0))


def fused_spec(config: NeoXConfig):
    """The fused-layer spec of a NeoX layer, the reference's
    (``neox.py:233-243``): head-major QKV, partial rotary, exact (or tanh)
    GELU, the parallel or serial residual; GPT-J's interleaved rotary
    makes it a spec the kernel refuses."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import FusedLayerSpec
    return FusedLayerSpec(
        num_heads=config.num_heads, num_kv_heads=config.num_heads,
        head_dim=config.head_dim, d_model=config.d_model, norm="ln",
        eps=config.layer_norm_eps, qkv="headmajor", qkv_bias=True,
        out_bias=True,
        mlp="gelu_tanh" if config.gelu_approximate else "gelu_exact",
        mlp_bias=True,
        residual="parallel" if config.use_parallel_residual else "serial",
        rotary_dims=config.rotary_ndims, rope_theta=config.rope_theta,
        rotary_interleaved=config.rotary_interleaved)


def fused_weights(layer):
    """One NeoX or BLOOM layer's params as the fused layer's canonical
    weights (the reference's ``fused_weights``; both families share the
    block layout)."""
    return {"n1_s": layer["ln1_scale"], "n1_b": layer["ln1_bias"],
            "wqkv": layer["qkv_w"], "bqkv": layer["qkv_b"],
            "wo": layer["dense_w"], "bo": layer["dense_b"],
            "n2_s": layer["ln2_scale"], "n2_b": layer["ln2_bias"],
            "w_in": layer["mlp_in_w"], "b_in": layer["mlp_in_b"],
            "w_out": layer["mlp_out_w"], "b_out": layer["mlp_out_b"]}


def cache_fn(config):
    """``init_cache_fn`` of a family with H = KV heads (NeoX, BLOOM):
    ``(batch_size, max_len, dtype=None, device=None)`` -> cache dict."""
    def init_cache_fn(bs, max_len, dtype=None, device=None):
        dtype = config.torch_dtype if dtype is None else dtype
        if isinstance(dtype, str) and dtype != "int8":
            dtype = getattr(torch, dtype)
        return serving.init_cache(config.num_layers, config.num_heads,
                                  config.head_dim, bs, max_len, dtype,
                                  device)
    return init_cache_fn


def _serving_fns(config: NeoXConfig):
    """(init_cache_fn, prefill_fn, decode_fn): the generic hook-driven
    serving forms with NeoX's hooks and fused spec (the reference's
    ``_serving_fns``, without the speculative verify form)."""
    spec = fused_spec(config)
    hooks = dict(
        embed_fn=lambda p, t: embed(p, t, config),
        qkv_fn=lambda x, layer, pos: _block_qkv(x, layer, config, pos),
        finish_fn=lambda x, a, layer: _block_finish(x, a, layer, config),
        head_fn=lambda p, x: head(p, x, config),
        num_heads=config.num_heads)

    def prefill_fn(p, b, c):
        return serving.prefill(p, b, c, attention_impl=config.attention_impl,
                               **hooks)

    def decode_fn(p, t, c, lengths, fused=False):
        return serving.decode_step(p, t, c, lengths, fused=fused,
                                   fused_spec=spec,
                                   fused_weights_fn=fused_weights, **hooks)

    return cache_fn(config), prefill_fn, decode_fn


def neox_model(size: str = "20b", **overrides) -> Model:
    """``neox:<size>`` (tiny, pythia-160m, 20b) with config overrides,
    e.g. ``neox_model("20b", num_layers=4)``."""
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        neox_params_from_numpy
    cfg_kwargs = resolve_size(NEOX_SIZES, size, "neox")
    cfg_kwargs.update(overrides)
    config = NeoXConfig(**cfg_kwargs)
    n_params = count_params(config)
    init_cache_fn, prefill_fn, decode_fn = _serving_fns(config)
    return Model(
        config=config,
        init_fn=partial(init_params, config),
        quantized_init_fn=partial(init_quantized_params, config),
        numpy_init_fn=partial(numpy_init_params, config),
        params_from_numpy_fn=neox_params_from_numpy,
        apply_fn=lambda p, b: forward(p, b, config),
        flops_per_token=6.0 * n_params,
        meta={"name": f"neox-{size}", "n_params": n_params},
        init_cache_fn=init_cache_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, fused_spec=fused_spec(config))
