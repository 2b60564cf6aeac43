"""KV-cache helpers shared by the serving paths (counterpart of
``deepspeed_tpu/models/serving.py`` ``write_token`` / ``select_token`` /
``init_cache``, the int8-weights routing and the fused per-layer pass).

The reference is functional: a write returns a new cache.  Here the
cache is updated in place — ``index_put_`` on one layer's slice — which
saves a copy of the whole cache per decode step.

Cache dict: ``{"k", "v"}`` [L, B, S, KV, hd], plus ``{"k_s", "v_s"}``
[L, B, S, KV] fp32 for an int8 cache (one symmetric scale per cached head
vector, ``ops/kernels/decode_attention.py`` helpers).

The reference's scan-form decode for large int8 models
(``use_scan_decode`` / ``quant_scan_threshold``) is not ported: with the
qgemm kernel consuming every quantized projection in place nothing is
left to dequantize inside the decode loop, and the reference keeps its
unrolled loop in that case too.
"""
import torch

from deepspeed_tpu_torch.models.model import QuantizedTensor, maybe_stream


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
    """Zero cache of shape [L, batch_size, max_len, KV, head_dim]:
    ``{"k", "v"}`` in ``dtype``, or for ``dtype="int8"`` int8 ``k``/``v``
    plus fp32 ``k_s``/``v_s`` [L, batch_size, max_len, KV] of ones."""
    shape = (num_layers, batch_size, max_len, num_kv_heads, head_dim)
    if str(dtype) in ("int8", "torch.int8"):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device),
                "v_s": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def qgemm_active(blocks) -> bool:
    """Whether the decode path hands the layer's int8 projection weights
    (``QuantizedTensor`` leaves of [L, in, out]) to the qgemm kernel in
    place of a dequantized copy.  The reference turns this on where its
    kernel is real (TPU); the port's wrapper is real on CUDA and its plain
    version on the CPU computes the same dequantize-then-matmul as the
    reference's jnp path, so it is on whenever the blocks are quantized."""
    return any(isinstance(w, QuantizedTensor) and w.q.dim() == 3
               for w in blocks.values())


def fused_decode_active(spec, fused_decode) -> bool:
    """Whether decode takes the fused per-layer path: the caller asked for
    it (``serving.fused_decode``) and the family wired a spec the port's
    kernel covers.  ``None`` is the unfused path (the reference turns it
    on by default on a TPU; the port leaves it off until the fused step
    is measured on the GPU)."""
    return bool(fused_decode) and spec is not None and spec.supported()


def _fused_keep_quantized(blocks) -> bool:
    """Int8 projection weights stay ``QuantizedTensor`` into the fused
    path: the kernel dequantizes them inside (CUDA), and the plain
    version's projections go through qgemm's plain version (CPU): the
    same condition as :func:`qgemm_active`."""
    return qgemm_active(blocks)


def _fused_layer_pass(params, x, cache, lengths, *, spec, weights_fn):
    """The fused per-layer loop (W = 1 for decode): ONE ``ds_fused_layer``
    call per layer replaces the QKV / cache write / decode attention /
    finish composition, then the window's new K/V (and, for an int8
    cache, their scales) land in the stacked cache with ``write_token``.
    Returns (x [B, W, D], cache)."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import ds_fused_layer
    blocks = params["blocks"]
    quantized = "k_s" in cache
    keep_q = _fused_keep_quantized(blocks)
    kc, vc = cache["k"], cache["v"]
    ksc, vsc = (cache["k_s"], cache["v_s"]) if quantized else (None, None)
    W = x.shape[1]
    for l in range(kc.shape[0]):
        layer = maybe_stream({k: v[l] for k, v in blocks.items()},
                             keep_quantized=keep_q)
        x, nk, nv, nks, nvs = ds_fused_layer(
            x, weights_fn(layer), kc[l], vc[l], lengths, spec,
            ks_l=ksc[l] if quantized else None,
            vs_l=vsc[l] if quantized else None)
        for j in range(W):
            write_token(kc, l, nk[:, j], lengths + j)
            write_token(vc, l, nv[:, j], lengths + j)
            if quantized:
                write_token(ksc, l, nks[:, j], lengths + j)
                write_token(vsc, l, nvs[:, j], lengths + j)
    return x, cache
