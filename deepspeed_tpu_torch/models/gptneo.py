"""GPT-Neo decoder in PyTorch (counterpart of
``deepspeed_tpu/models/gptneo.py``): the GPT-2 layout (learned positions,
pre-LN blocks, tied head; ``models/gpt2.py``'s params, LayerNorm, MLP and
converters) with two GPT-Neo twists: attention layers alternate GLOBAL
and LOCAL (a sliding window of ``window_size`` positions, 256), and the
attention scores are UNSCALED (no 1 / sqrt(hd)).

Prefill runs the banded attention per layer in plain PyTorch (an einsum
in the reference too), through GPT-2's ``attn_fn`` hook.  A decode step
runs GPT-2's unfused composition with ``sm_scale=1`` and a per-layer
window floor (``min_pos_fn``: ``max(length + 1 - window, 0)`` on local
layers, 0 on global ones) for the decode-attention kernel's windowed
variant, which therefore runs on every layer, as in the reference.  No
fused-layer spec is wired: the fused kernel takes no window, and the
reference's never fuses GPT-Neo either (fused decode raises here).

GPT-Neo 2.7B (2.65 B params) is drawn on the device
(``models/model.py seeded_device_init`` over GPT-2's
``param_shapes``); the host init is GPT-2's ``numpy_init_params``.
Training differentiates :func:`forward` under the causal-LM loss; the
banded attention is the plain einsum, as in the reference, with gradients
by autograd; with ``remat`` each layer runs under
``torch.utils.checkpoint`` (``run_block``, the "nothing" policy).
"""
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import torch

from deepspeed_tpu_torch.models import gpt2 as _g
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              layer_params, maybe_stream,
                                              resolve_size, run_block,
                                              seeded_device_init)


@dataclass(frozen=True)
class GPTNeoConfig:
    """The reference's ``GPTNeoConfig``, same fields and defaults."""
    vocab_size: int = 50257
    max_seq_len: int = 2048
    num_layers: int = 4
    num_heads: int = 8
    d_model: int = 512
    layer_norm_eps: float = 1e-5
    #: per-layer attention kind, "global" or "local" (HF attention_types
    #: expanded); defaults to the GPT-Neo alternating pattern
    attention_layers: Tuple[str, ...] = ()
    window_size: int = 256
    activation: str = "gelu"        # tanh approx (HF gelu_new)
    mlp_dim: int = 0
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.remat:
            check_remat_policy(self.remat_policy)
        if self.attention_layers \
                and len(self.attention_layers) != self.num_layers:
            raise ValueError(f"GPTNeoConfig: {len(self.attention_layers)} "
                             f"attention_layers for {self.num_layers} layers")

    @property
    def d_mlp(self) -> int:
        return self.mlp_dim or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        if self.attention_layers:
            return self.attention_layers
        return tuple("global" if i % 2 == 0 else "local"
                     for i in range(self.num_layers))

    @property
    def windows(self) -> Tuple[int, ...]:
        """Each layer's window: 0 (global, plain causal) or
        ``window_size``."""
        return tuple(0 if kind == "global" else self.window_size
                     for kind in self.layer_kinds)


GPTNEO_SIZES = {
    "tiny": dict(vocab_size=256, max_seq_len=64, num_layers=2,
                 num_heads=4, d_model=32, window_size=16),
    "125m": dict(vocab_size=50257, max_seq_len=2048, num_layers=12,
                 num_heads=12, d_model=768),
    "1.3b": dict(vocab_size=50257, max_seq_len=2048, num_layers=24,
                 num_heads=16, d_model=2048),
    "2.7b": dict(vocab_size=50257, max_seq_len=2048, num_layers=32,
                 num_heads=20, d_model=2560),
}


def _gpt2_cfg(config: GPTNeoConfig) -> _g.GPT2Config:
    """The GPT-2 view the shared helpers take (same param layout, LN and
    MLP maths)."""
    return _g.GPT2Config(
        vocab_size=config.vocab_size, max_seq_len=config.max_seq_len,
        num_layers=config.num_layers, num_heads=config.num_heads,
        d_model=config.d_model, layer_norm_eps=config.layer_norm_eps,
        activation=config.activation, mlp_dim=config.mlp_dim,
        dtype=config.dtype, attention_impl=config.attention_impl)


def _banded_attention(q, k, v, window: int, segment_ids=None):
    """Causal attention with UNSCALED fp32 scores and, for ``window`` > 0,
    a sliding window (key j seen from query i when i - j < window);
    ``segment_ids`` restricts attention within packed segments."""
    B, S, H, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask = mask & (i - j < window)
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block(x, layer, window: int, g2: _g.GPT2Config, seg=None):
    """One layer of the full forward (GPT-2's, the banded attention in
    place of the causal one); x [B, S, D]."""
    B, S, D = x.shape
    q, kk, v = _g._block_qkv(x, layer, g2)
    attn = _banded_attention(q, kk, v, window, seg)
    return _g._block_finish(x, attn.reshape(B, S, D), layer, g2)


def forward(params, batch, config: GPTNeoConfig):
    """Token ids [B, S] -> logits [B, S, V] (the full forward, each layer
    under ``torch.utils.checkpoint`` with ``remat``)."""
    g2 = _gpt2_cfg(config)
    x = _g.embed(params, batch, g2)
    seg = batch.get("segment_ids") if isinstance(batch, dict) else None
    for l, window in enumerate(config.windows):
        x = run_block(_block, config.remat, x,
                      maybe_stream(layer_params(params["blocks"], l)),
                      window, g2, seg)
    return _g.head(params, x, g2)


def count_params(config: GPTNeoConfig) -> int:
    """The reference's ``count_params``."""
    D, V, L, M, S = (config.d_model, config.vocab_size, config.num_layers,
                     config.d_mlp, config.max_seq_len)
    per_layer = 4 * D + 3 * D * D + 3 * D + D * D + D + D * M + M + M * D + D
    return V * D + S * D + L * per_layer + 2 * D


def window_floor_fn(config: GPTNeoConfig):
    """``min_pos_fn(layer_idx, lengths) -> [B] int32``: the decode
    kernel's floor, ``max(lengths + 1 - window, 0)`` on a local layer (the
    new token at ``lengths`` sees the last ``window`` positions) and 0 on
    a global one (the reference's ``min_pos_fn``)."""
    windows = config.windows

    def min_pos_fn(idx, lengths):
        win = windows[idx]
        if not win:
            return torch.zeros_like(lengths, dtype=torch.int32)
        return torch.clamp(lengths + 1 - win, min=0).to(torch.int32)
    return min_pos_fn


def _serving_fns(config: GPTNeoConfig):
    """(init_cache_fn, prefill_fn, decode_fn): GPT-2's serving forms with
    the banded, unscaled attention at prefill and ``sm_scale=1`` with the
    window floor at decode."""
    g2 = _gpt2_cfg(config)
    windows = config.windows
    min_pos_fn = window_floor_fn(config)

    def attn_fn(q, k, v, idx):
        return _banded_attention(q, k, v, windows[idx])

    def init_cache_fn(bs, max_len, dtype=None, device=None):
        return _g.init_cache(g2, bs, max_len, dtype, device)

    def prefill_fn(p, b, c):
        return _g.prefill(p, b, c, g2, attn_fn=attn_fn)

    def decode_fn(p, t, c, lengths, fused=False):
        return _g.decode_step(p, t, c, lengths, g2, fused=fused,
                              sm_scale=1.0, min_pos_fn=min_pos_fn)

    return init_cache_fn, prefill_fn, decode_fn


def gptneo_model(size: str = "2.7b", **overrides) -> Model:
    """``gptneo:<size>`` (tiny, 125m, 1.3b, 2.7b) with config overrides."""
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        gpt2_params_from_numpy
    cfg_kwargs = resolve_size(GPTNEO_SIZES, size, "gptneo")
    cfg_kwargs.update(overrides)
    config = GPTNeoConfig(**cfg_kwargs)
    g2 = _gpt2_cfg(config)
    shapes = _g.param_shapes(g2)
    n_params = count_params(config)
    init_cache_fn, prefill_fn, decode_fn = _serving_fns(config)
    return Model(
        config=config,
        init_fn=lambda seed, device, dtype: seeded_device_init(
            shapes, seed, device, dtype, quantize=False),
        quantized_init_fn=lambda seed, device, dtype: seeded_device_init(
            shapes, seed, device, dtype, quantize=True),
        numpy_init_fn=partial(_g.numpy_init_params, g2),
        params_from_numpy_fn=gpt2_params_from_numpy,
        apply_fn=lambda p, b: forward(p, b, config),
        flops_per_token=6.0 * n_params,
        meta={"name": f"gptneo-{size}", "n_params": n_params},
        init_cache_fn=init_cache_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn)
