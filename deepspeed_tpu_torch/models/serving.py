"""KV-cache helpers shared by the serving paths (counterpart of
``deepspeed_tpu/models/serving.py`` ``write_token`` / ``select_token`` /
``init_cache``).

The reference is functional: a write returns a new cache.  Here the
cache is updated in place — ``index_put_`` on one layer's slice — which
saves a copy of the whole cache per decode step."""
import torch


def select_token(c_l, new, lengths):
    """Write ``new`` [B, ...] at per-row positions ``lengths`` [B] into one
    layer's cache slice ``c_l`` [B, S, ...], in place; returns ``c_l``."""
    rows = torch.arange(c_l.shape[0], device=c_l.device)
    c_l[rows, lengths.long()] = new.to(c_l.dtype)
    return c_l


def write_token(c, l, new, lengths):
    """One decode step's vectors ``new`` [B, ...] into layer ``l`` of the
    stacked cache ``c`` [L, B, S, ...] at positions ``lengths`` [B], in
    place (see :func:`select_token`); returns ``c``."""
    select_token(c[l], new, lengths)
    return c


def init_cache(num_layers, num_kv_heads, head_dim, batch_size, max_len,
               dtype, device):
    """Zero float cache ``{"k", "v"}`` of shape
    [L, batch_size, max_len, KV, head_dim]."""
    if str(dtype) == "int8":
        raise NotImplementedError(
            "int8 KV cache: not ported to deepspeed_tpu_torch yet "
            "(ROADMAP.md Queue B: int8 serving)")
    shape = (num_layers, batch_size, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
