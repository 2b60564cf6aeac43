"""BLOOM-style decoder in PyTorch (counterpart of
``deepspeed_tpu/models/bloom.py``): ALiBi positional attention (no
position embeddings: each score gets ``slope[h] * key_position``), an
embedding LayerNorm, a fused QKV projection packed head-major, a biased
tanh-GELU MLP with the serial residual, and the head tied to the word
embeddings.

The block layout is GPT-NeoX's (``_ln`` and the fused-layer weight
mapping come from the port's ``models/neox.py``, as the reference takes
``_ln`` from its ``neox.py``).  Prefill attention is the reference's
einsum form with the ALiBi bias, in plain PyTorch (it is XLA, not a
kernel, in the reference); a decode step runs the decode-attention
kernel's ALiBi variant per layer, or with ``fused=True`` one fused-layer
kernel per layer with the reference's spec (head-major QKV, ALiBi).

Initialisation: :func:`init_params` (on the device),
:func:`init_quantized_params` (int8 projections, quantized as drawn) and
:func:`numpy_init_params` (the host init with the reference's scales,
for the tests).  Training differentiates :func:`forward` under the
causal-LM loss; its ALiBi attention is the plain einsum, as in the
reference, with gradients by autograd; with ``remat`` each layer runs
under ``torch.utils.checkpoint`` (``run_block``, the "nothing" policy).
"""
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models import serving
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              head_dot, layer_params,
                                              maybe_stream, numpy_seeded_init,
                                              qdot, resolve_size, run_block,
                                              seeded_device_init)
from deepspeed_tpu_torch.models.neox import _ln, cache_fn, fused_weights


@dataclass(frozen=True)
class BloomConfig:
    """The reference's ``BloomConfig``, same fields and defaults."""
    vocab_size: int = 250880
    max_seq_len: int = 2048
    num_layers: int = 4
    num_heads: int = 8
    d_model: int = 64
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "nothing"

    def __post_init__(self):
        if self.remat:
            check_remat_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def d_mlp(self) -> int:
        return 4 * self.d_model

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


BLOOM_SIZES = {
    "tiny": dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=4,
                 d_model=32),
    "560m": dict(vocab_size=250880, max_seq_len=2048, num_layers=24,
                 num_heads=16, d_model=1024),
}


def alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi per-head slopes (Press et al.; HF's build_alibi_tensor), a
    copy of the reference's: a geometric series for a power-of-two head
    count, else the nearest lower power's series followed by every
    other slope of the next power's."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(num_heads).is_integer():
        return pow2_slopes(num_heads)
    closest = 2 ** int(np.floor(np.log2(num_heads)))
    base = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return np.concatenate([base, extra])


def _shapes(config: BloomConfig) -> dict:
    """Leaf shapes and init scales (None: ones, 0: zeros), the
    reference's: 0.02, and 0.02 / sqrt(2 L) for ``dense_w`` and
    ``mlp_out_w``."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    std = 0.02
    res = std / (2 * L) ** 0.5
    return {
        "wte": ((V, D), std),
        "emb_ln_scale": ((D,), None), "emb_ln_bias": ((D,), 0),
        "blocks": {
            "ln1_scale": ((L, D), None), "ln1_bias": ((L, D), 0),
            "ln2_scale": ((L, D), None), "ln2_bias": ((L, D), 0),
            "qkv_w": ((L, D, 3 * D), std), "qkv_b": ((L, 3 * D), 0),
            "dense_w": ((L, D, D), res), "dense_b": ((L, D), 0),
            "mlp_in_w": ((L, D, M), std), "mlp_in_b": ((L, M), 0),
            "mlp_out_w": ((L, M, D), res), "mlp_out_b": ((L, D), 0)},
        "lnf_scale": ((D,), None), "lnf_bias": ((D,), 0)}


def numpy_init_params(config: BloomConfig, seed: int = 0) -> dict:
    """Host init with numpy's PCG64 at the reference's scales (the tests'
    weights, handed to both packages)."""
    return numpy_seeded_init(_shapes(config), seed)


def init_params(config: BloomConfig, seed: int = 0, device=None,
                dtype=None) -> dict:
    """Seeded normal init drawn on ``device`` (``None``: the GPU)."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=False)


def init_quantized_params(config: BloomConfig, seed: int = 0, device=None,
                          dtype=None) -> dict:
    """:func:`init_params` with the four projection stacks int8."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=True)


#: per (num_heads, device): the slopes as an fp32 tensor
_slope_tensors = {}


def slopes_on(num_heads: int, device) -> torch.Tensor:
    """:func:`alibi_slopes` as fp32 [H] on ``device``, made once."""
    key = (num_heads, torch.device(device))
    t = _slope_tensors.get(key)
    if t is None:
        t = torch.tensor(alibi_slopes(num_heads), dtype=torch.float32,
                         device=device)
        _slope_tensors[key] = t
    return t


def _alibi_attention(q, k, v, slopes, segment_ids=None):
    """Causal attention with the ALiBi bias ``slopes[h] * key_position``
    (the reference's einsum form: fp32 scores scaled by hd^-0.5, the bias
    added, the causal mask, softmax in fp32, probabilities in q's dtype);
    ``segment_ids`` restricts attention within packed segments."""
    B, S, H, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    pos = torch.arange(S, device=q.device)
    scores = scores + slopes[None, :, None, None] * pos.float()
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                 device=q.device))[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_qkv(x, layer, config: BloomConfig, positions=None):
    """LN1 + fused QKV (head-major [q|k|v] packing); no positional
    transform: ALiBi biases scores, not projections."""
    H, hd = config.num_heads, config.head_dim
    h = _ln(x, layer["ln1_scale"], layer["ln1_bias"], config.layer_norm_eps)
    qkv = qdot(h, layer["qkv_w"]) + layer["qkv_b"].to(x.dtype)
    return qkv.unflatten(-1, (H, 3 * hd)).split(hd, dim=-1)


def _block_finish(x, attn_flat, layer, config: BloomConfig):
    """Attention-out (+ bias) + residual, LN2, the MLP; the MLP's output
    bias is added after its residual, in the reference's order (the fused
    layer adds it before: the two agree where the bias is zero, as
    initialised)."""
    dt = x.dtype
    x = x + (qdot(attn_flat, layer["dense_w"]) + layer["dense_b"].to(dt))
    h = _ln(x, layer["ln2_scale"], layer["ln2_bias"], config.layer_norm_eps)
    m = F.gelu(qdot(h, layer["mlp_in_w"]) + layer["mlp_in_b"].to(dt),
               approximate="tanh")
    return x + qdot(m, layer["mlp_out_w"]) + layer["mlp_out_b"].to(dt)


def embed(params, tokens, config: BloomConfig):
    """Word embeddings + the embedding LayerNorm."""
    x = params["wte"].to(config.torch_dtype)[tokens.long()]
    return _ln(x, params["emb_ln_scale"], params["emb_ln_bias"],
               config.layer_norm_eps)


def head(params, x, config: BloomConfig):
    """Final LN + the head tied to the word embeddings."""
    x = _ln(x, params["lnf_scale"], params["lnf_bias"], config.layer_norm_eps)
    return head_dot(x, params["wte"], transpose_w=True)


def _block(x, layer, slopes, config: BloomConfig, seg=None):
    """One layer of the full causal forward; x [B, S, D]."""
    B, S, _ = x.shape
    q, kk, v = _block_qkv(x, layer, config)
    attn = _alibi_attention(q, kk, v, slopes, seg)
    return _block_finish(x, attn.reshape(B, S, -1), layer, config)


def forward(params, batch, config: BloomConfig):
    """Token ids [B, S] -> logits [B, S, V] (the full causal forward, each
    layer under ``torch.utils.checkpoint`` with ``remat``)."""
    tokens = batch["input_ids"]
    slopes = slopes_on(config.num_heads, tokens.device)
    x = embed(params, tokens, config)
    seg = batch.get("segment_ids") if isinstance(batch, dict) else None
    for l in range(config.num_layers):
        x = run_block(_block, config.remat, x,
                      maybe_stream(layer_params(params["blocks"], l)),
                      slopes, config, seg)
    return head(params, x, config)


def count_params(config: BloomConfig) -> int:
    """The reference's ``count_params``."""
    D, V, L, M = (config.d_model, config.vocab_size, config.num_layers,
                  config.d_mlp)
    per_layer = 4 * D + 3 * D * D + 3 * D + D * D + D + D * M + M + M * D + D
    return V * D + 2 * D + L * per_layer + 2 * D


def fused_spec(config: BloomConfig):
    """The fused-layer spec of a BLOOM layer, the reference's
    (``bloom.py:217-222``): head-major QKV, ALiBi, tanh GELU, the serial
    residual."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import FusedLayerSpec
    return FusedLayerSpec(
        num_heads=config.num_heads, num_kv_heads=config.num_heads,
        head_dim=config.head_dim, d_model=config.d_model, norm="ln",
        eps=config.layer_norm_eps, qkv="headmajor", qkv_bias=True,
        out_bias=True, mlp="gelu_tanh", mlp_bias=True, alibi=True)


def _serving_fns(config: BloomConfig):
    """(init_cache_fn, prefill_fn, decode_fn): the generic serving forms
    with BLOOM's hooks — the ALiBi einsum attention at prefill
    (``attn_fn``), the decode kernel's ``alibi_slopes`` form per token —
    and its fused spec (the reference's ``_serving_fns``, without the
    speculative verify form)."""
    spec = fused_spec(config)
    H = config.num_heads
    hooks = dict(
        embed_fn=lambda p, t: embed(p, t, config),
        qkv_fn=lambda x, layer, pos: _block_qkv(x, layer, config, pos),
        finish_fn=lambda x, a, layer: _block_finish(x, a, layer, config),
        head_fn=lambda p, x: head(p, x, config),
        num_heads=H)

    def prefill_fn(p, b, c):
        slopes = slopes_on(H, p["wte"].device)
        return serving.prefill(
            p, b, c, attention_impl="plain",
            attn_fn=lambda q, k, v: _alibi_attention(q, k, v, slopes),
            **hooks)

    def decode_fn(p, t, c, lengths, fused=False):
        return serving.decode_step(
            p, t, c, lengths, fused=fused, fused_spec=spec,
            fused_weights_fn=fused_weights,
            alibi_slopes=slopes_on(H, p["wte"].device), **hooks)

    return cache_fn(config), prefill_fn, decode_fn


def bloom_model(size: str = "560m", **overrides) -> Model:
    """``bloom:<size>`` (tiny, 560m) with config overrides."""
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        bloom_params_from_numpy
    cfg_kwargs = resolve_size(BLOOM_SIZES, size, "bloom")
    cfg_kwargs.update(overrides)
    config = BloomConfig(**cfg_kwargs)
    n_params = count_params(config)
    init_cache_fn, prefill_fn, decode_fn = _serving_fns(config)
    return Model(
        config=config,
        init_fn=partial(init_params, config),
        quantized_init_fn=partial(init_quantized_params, config),
        numpy_init_fn=partial(numpy_init_params, config),
        params_from_numpy_fn=bloom_params_from_numpy,
        apply_fn=lambda p, b: forward(p, b, config),
        flops_per_token=6.0 * n_params,
        meta={"name": f"bloom-{size}", "n_params": n_params},
        init_cache_fn=init_cache_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, fused_spec=fused_spec(config))
