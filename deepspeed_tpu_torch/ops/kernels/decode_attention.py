"""Decode attention: one query token per row over a dense KV cache.

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py`` (float cache, no
ALiBi, no window floor).  :func:`decode_attention` launches the CUDA
kernel in ``csrc/decode_attention.cu`` for CUDA tensors and takes the
plain PyTorch version :func:`decode_attention_plain` for CPU tensors.

Layouts (the reference's public ones):
  q:         [B, H, hd]
  k/v cache: [B, S_max, KV, hd]   (H % KV == 0; query head h reads kv
                                   head h // (H // KV))
  cache_len: [B] int32 — valid positions per row
  out:       [B, H, hd], the input dtype
A row with ``cache_len <= 0`` returns zeros.
"""
import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 96, 128)
MAX_REP = 8
_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_plain(q, k_cache, v_cache, cache_len, sm_scale=None):
    """Plain PyTorch version (fp32 einsum + masked softmax), mirroring
    ``decode_attention_xla``; rows with no valid position return zeros
    as the kernel does."""
    B, H, hd = q.shape
    S_max, KV = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    rep = H // KV
    k = k_cache.float()
    v = v_cache.float()
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) * sm_scale
    pos = torch.arange(S_max, device=q.device)
    valid = pos[None, None, :] < cache_len.to(q.device)[:, None, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * valid
    return torch.einsum("bhs,bshd->bhd", probs, v).to(q.dtype)


def _lib():
    lib = build.load("decode_attention")
    fn = lib.ds_decode_attention
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, k_cache, v_cache, cache_len, sm_scale=None):
    """Launch the CUDA kernel; raises on anything it does not take."""
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
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype}; need one of "
                         f"{_DTYPES}")
    if cache_len.dtype != torch.int32 or cache_len.shape != (B,):
        raise ValueError("decode_attention: cache_len must be int32 [B]")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_len", cache_len)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if sm_scale is None:
        sm_scale = hd ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    cache_len.data_ptr(), out.data_ptr(), B, H, KV, S_max,
                    hd, int(q.dtype == torch.bfloat16), float(sm_scale),
                    stream)
    build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, cache_len, sm_scale=None):
    """The serving path's decode attention: CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                     sm_scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      sm_scale)
    raise ValueError(f"decode_attention: unsupported device {q.device}")


#: kernel launches since the count was last set to 0
decode_attention.launches = 0
