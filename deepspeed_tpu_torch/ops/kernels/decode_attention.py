"""Decode attention: one query token per row over a dense KV cache.

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py``: the float
cache and the int8 cache, each with the ALiBi variant (``alibi_slopes``
[H] fp32: the score of key position s for query head h gets
``slopes[h] * s``, BLOOM) and the windowed variant (``min_pos`` [B]
int32: positions below a per-row floor are masked, GPT-Neo's local
layers), plus the int8 cache helpers ``quantize_kv`` / ``dequantize_kv``
/ ``quantize_prefill_into_cache``.  :func:`decode_attention` launches the
CUDA kernel in ``csrc/decode_attention.cu`` for CUDA tensors (one launch
a call: each row's positions split into fixed chunks across CTAs, the
partials merged in chunk order through a workspace and arrival counters
from ``build.scratch``, so a row's bits follow only its own inputs) and
takes the plain PyTorch version :func:`decode_attention_plain` for CPU
tensors.

Layouts (the reference's public ones):
  q:         [B, H, hd]
  k/v cache: [B, S_max, KV, hd]   (H % KV == 0; query head h reads kv
                                   head h // (H // KV))
  k/v scale: [B, S_max, KV] fp32, int8 caches only (one symmetric scale
             per cached head vector)
  cache_len: [B] int32 — valid positions per row
  alibi_slopes: [H] fp32 per query head, or None
  min_pos:   [B] int32 first attended position per row, or None
  out:       [B, H, hd], the input dtype
A row with no attended position (``cache_len <= 0``, or a floor at or
past it) returns zeros.

int8 numerics follow the Pallas kernel: the cache dequantizes to fp32
and the query, scores, softmax and weighted sum stay in fp32.  The
reference's ``decode_attention_xla`` rounds the dequantized cache to the
query's dtype first; for a bf16 query the two differ by that rounding.
"""
import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels.quantization import true_div127

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 96, 128)
MAX_REP = 8
_DTYPES = (torch.float32, torch.bfloat16)


def quantize_kv(x):
    """[..., KV, hd] -> (int8 [..., KV, hd], fp32 scales [..., KV]): one
    symmetric scale per head vector (the reference's ``quantize_kv``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, true_div127(amax), torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    return q.float() * scale[..., None]


def quantize_prefill_into_cache(cache, ks, vs):
    """Quantize a prefill's K/V ([L, B, S, KV, hd]) into positions [0, S)
    of the int8 cache dict, in place; returns ``cache``."""
    S = ks.shape[2]
    kq, ksc = quantize_kv(ks)
    vq, vsc = quantize_kv(vs)
    cache["k"][:, :, :S] = kq
    cache["v"][:, :, :S] = vq
    cache["k_s"][:, :, :S] = ksc
    cache["v_s"][:, :, :S] = vsc
    return cache


def decode_attention_plain(q, k_cache, v_cache, cache_len, sm_scale=None,
                           k_scale=None, v_scale=None, alibi_slopes=None,
                           min_pos=None):
    """Plain PyTorch version (fp32 einsum + masked softmax, the reference's
    ``decode_attention_xla`` order: scores scaled, then the ALiBi bias
    added); rows with no valid position return zeros as the kernel does.
    int8 caches pass their fp32 scales."""
    B, H, hd = q.shape
    S_max, KV = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    rep = H // KV
    if k_scale is not None:
        k = dequantize_kv(k_cache, k_scale)
        v = dequantize_kv(v_cache, v_scale)
    else:
        k = k_cache.float()
        v = v_cache.float()
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) * sm_scale
    pos = torch.arange(S_max, device=q.device)
    if alibi_slopes is not None:
        scores = scores + (alibi_slopes.float()[None, :, None]
                           * pos.float()[None, None, :])
    valid = pos[None, None, :] < cache_len.to(q.device)[:, None, None]
    if min_pos is not None:
        valid &= pos[None, None, :] >= min_pos.to(q.device)[:, None, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * valid
    return torch.einsum("bhs,bshd->bhd", probs, v).to(q.dtype)


#: positions of the smallest chunk of any kernel instance (the kernel's
#: ``kMinChunk``): the workspace holds ceil(S_max / MIN_CHUNK) partials per
#: (row, kv head)
MIN_CHUNK = 64
_entries = {}


def _entry(quantized: bool):
    """The kernel's C entry point for the cache type, bound once."""
    lib = build.load("decode_attention")
    fn = lib.ds_decode_attention_int8 if quantized \
        else lib.ds_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * (11 if quantized else 9)
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _entries[quantized] = fn
    return fn


def _call(quantized, device, *args):
    """Launch the kernel on ``device``'s current stream with ``args``
    (pointers, then B, H, KV, S_max, head_dim, is_bf16, sm_scale);
    returns its ``cudaError_t``.  The device is made current only when it
    is not already (a decode step launches this once a layer)."""
    fn = _entries.get(quantized) or _entry(quantized)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def chunk_positions(head_dim: int, cache_dtype) -> int:
    """Positions per chunk (one CTA's share of a row) of the kernel
    instance for ``head_dim`` and a cache of ``cache_dtype`` (fp32, bf16
    or int8), as built: a compile-time constant of the instance."""
    fn = build.load("decode_attention").ds_decode_attention_chunk
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    c = fn(head_dim, torch.empty((), dtype=cache_dtype).element_size())
    if c < MIN_CHUNK:
        raise ValueError(f"decode_attention: no kernel instance for "
                         f"head_dim {head_dim}, cache {cache_dtype}")
    return c


def workspace_sizes(B, H, KV, S_max, hd):
    """(fp32 workspace floats, int counters) a launch asks of
    ``build.scratch``: one (m, l, acc) partial per (row, kv head, chunk)
    at the smallest chunk, and one arrival counter per (row, kv head)."""
    return B * KV * -(-S_max // MIN_CHUNK) * (H // KV) * (hd + 2), B * KV


def check_args(q, k_cache, v_cache, cache_len, k_scale=None, v_scale=None,
               alibi_slopes=None, min_pos=None):
    """Raise ValueError on anything the kernel does not take; returns
    (B, H, KV, S_max, hd, quantized)."""
    B, H, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: k/v cache shapes "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    Bk, S_max, KV, hdk = k_cache.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if H % KV or H // KV > MAX_REP:
        raise ValueError(f"decode_attention: {H} query heads over {KV} kv "
                         f"heads (need H % KV == 0, H // KV <= {MAX_REP})")
    quantized = k_scale is not None
    cache_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPES or k_cache.dtype != cache_dtype \
            or v_cache.dtype != cache_dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype}; need q in "
                         f"{_DTYPES} and a cache of q's dtype (or int8 "
                         "with scales)")
    if cache_len.dtype != torch.int32 or cache_len.shape != (B,):
        raise ValueError("decode_attention: cache_len must be int32 [B]")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("cache_len", cache_len)]
    if quantized:
        if v_scale is None or k_scale.shape != (B, S_max, KV) \
                or v_scale.shape != (B, S_max, KV) \
                or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise ValueError("decode_attention: int8 scales must be fp32 "
                             f"[B, S_max, KV] = {(B, S_max, KV)}")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    if alibi_slopes is not None:
        if alibi_slopes.dtype != torch.float32 \
                or alibi_slopes.shape != (H,):
            raise ValueError(f"decode_attention: alibi_slopes must be fp32 "
                             f"[H] = ({H},)")
        tensors.append(("alibi_slopes", alibi_slopes))
    if min_pos is not None:
        if min_pos.dtype != torch.int32 or min_pos.shape != (B,):
            raise ValueError("decode_attention: min_pos must be int32 [B]")
        tensors.append(("min_pos", min_pos))
    dev = q.device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    return B, H, KV, S_max, hd, quantized


def decode_attention_cuda(q, k_cache, v_cache, cache_len, sm_scale=None,
                          k_scale=None, v_scale=None, alibi_slopes=None,
                          min_pos=None):
    """Launch the CUDA kernel (one launch); raises on anything it does
    not take."""
    B, H, KV, S_max, hd, quantized = check_args(
        q, k_cache, v_cache, cache_len, k_scale, v_scale, alibi_slopes,
        min_pos)
    ptrs = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()]
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        # the kernel copies whole 16-byte units of q and of each head vector
        raise ValueError("decode_attention: q and k/v cache bases must be "
                         "16-byte aligned")
    if sm_scale is None:
        sm_scale = hd ** -0.5
    out = torch.empty_like(q)
    ws, counters = build.scratch(q.device,
                                 *workspace_sizes(B, H, KV, S_max, hd))
    if quantized:
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    ptrs += [cache_len.data_ptr(),
             0 if alibi_slopes is None else alibi_slopes.data_ptr(),
             0 if min_pos is None else min_pos.data_ptr(),
             out.data_ptr(), ws.data_ptr(), counters.data_ptr()]
    rc = _call(quantized, q.device, *ptrs, B, H, KV, S_max, hd,
               int(q.dtype == torch.bfloat16), float(sm_scale))
    build.check(rc, "decode_attention")
    if alibi_slopes is not None:
        decode_attention.alibi_launches += 1
    if min_pos is not None:
        decode_attention.windowed_launches += 1
    if alibi_slopes is None and min_pos is None:
        if quantized:
            decode_attention.int8_launches += 1
        else:
            decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, cache_len, sm_scale=None,
                     k_scale=None, v_scale=None, alibi_slopes=None,
                     min_pos=None):
    """The serving path's decode attention: CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  int8 caches pass their fp32
    ``k_scale`` / ``v_scale`` [B, S_max, KV]; ``alibi_slopes`` [H] fp32
    selects the ALiBi form, ``min_pos`` [B] int32 the window floor."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                     sm_scale, k_scale, v_scale,
                                     alibi_slopes, min_pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      sm_scale, k_scale, v_scale,
                                      alibi_slopes, min_pos)
    raise ValueError(f"decode_attention: unsupported device {q.device}")


#: kernel launches since the count was last set to 0: ``launches`` for
#: the float cache and ``int8_launches`` for the int8 cache with neither
#: extra; a call with ALiBi slopes counts in ``alibi_launches`` and one
#: with a window floor in ``windowed_launches`` (either cache)
decode_attention.launches = 0
decode_attention.int8_launches = 0
decode_attention.alibi_launches = 0
decode_attention.windowed_launches = 0
