"""Fused per-layer decode step (port of
``deepspeed_tpu/ops/pallas/fused_decode.py`` ``ds_fused_layer``): one
decoder layer's W-token window step in one kernel launch, so a decode
step issues L launches for its layers instead of about six per layer.

    norm1 -> QKV (+bias) -> rotary -> new K/V (int8 quantize for an int8
    cache) -> attention over the cache AND the window's own tokens ->
    attn-out (+bias) + residual -> norm2 -> MLP (+biases) + residual

:func:`ds_fused_layer` launches the CUDA kernel in ``csrc/fused_decode.cu``
for CUDA tensors and takes :func:`fused_layer_plain` for CPU tensors.  The
plain version is the reference's ``_ref_fused_layer``: exactly the unfused
per-layer composition (the same norms, projections, rotary,
``quantize_kv`` and decode attention, in plain PyTorch), so fused and
unfused decode agree bitwise on the CPU.

Specs covered: ``norm`` "ln" or "rms"; ``qkv`` "fused" ([D, 3D] thirds),
"headmajor" ([D, 3D] packed per head [q|k|v], GPT-NeoX and BLOOM; no
GQA) or "split" (``wq`` / ``wk`` / ``wv``); the QKV, attention-out and
GELU / ReLU MLP biases each optional; grouped-query attention
(``num_kv_heads`` dividing ``num_heads``); no rotary, full rotary
(``rotary_dims == head_dim``) or NeoX's partial rotary (``0 <
rotary_dims < head_dim``: the first ``rotary_dims`` of each head
rotate, split-half pairing over ``rotary_dims / 2``, the rest pass
through); ALiBi (``alibi=True``, the per-head slopes passed as
``alibi_slopes``); ``mlp`` gelu_tanh / gelu_exact / relu, ``swiglu``
(``w_gate``, ``w_up``, ``w_down``) or ``none`` (the layer ends after the
attention-out residual: a mixture-of-experts layer runs its experts
outside); the serial or the parallel residual (norm2 reads the layer
input; ``(x + attn_out) + mlp_out``); any window W >= 1; head_dim <=
128.  GPT-J's interleaved rotary raises NotImplementedError, as the
reference's kernel refuses it (``fused_decode.py:114``).  The
reference's VMEM-budget fallback is not ported: the kernel streams each
weight once per call and needs no resident layer.

The cache is input-only: the new K/V (int8 codes plus fp32 scales for an
int8 cache) come back as outputs and the caller writes them with
``write_token``, as in the reference.

Under bf16 compute the kernel's GEMM phases run on the decode weight
stream of ``csrc/decode_stream.cuh`` (the projections' shapes must meet
``qgemm.stream_ok``), with the K splits of ``qgemm.stream_splits``; its
attention phase is split over the cache in chunks of ``ATTN_CHUNK``
positions (:func:`attention_split_walk` walks that decomposition in
plain torch).
"""
import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_plain, quantize_kv)
from deepspeed_tpu_torch.ops.kernels.qgemm import qgemm_plain, stream_ok

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
#: K splits per GEMM phase the kernel may use (csrc kMaxSplit)
MAX_SPLIT = 16
#: the attention phase's chunk of cache positions (csrc kC: four warps of
#: 16 positions) and the query vectors of one work item (kQItem)
ATTN_CHUNK = 64
ATTN_QMAX = 4
#: the kernel's MLP kinds (csrc FusedArgs.mlp)
_MLPS = {"gelu_tanh": 0, "gelu_exact": 1, "relu": 2, "swiglu": 3, "none": 4}


@dataclass(frozen=True)
class FusedLayerSpec:
    """Static description of one decoder layer's fused step (the
    reference's ``FusedLayerSpec``, same fields and defaults)."""
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_model: int
    norm: str = "ln"                 # "ln" (scale+bias) | "rms"
    eps: float = 1e-5
    qkv: str = "fused"               # "fused" | "headmajor" | "split"
    qkv_bias: bool = True
    out_bias: bool = True
    mlp: str = "gelu_tanh"
    mlp_bias: bool = True
    residual: str = "serial"         # "serial" | "parallel"
    rotary_dims: int = 0
    rope_theta: float = 10000.0
    rotary_interleaved: bool = False
    alibi: bool = False
    sm_scale: Optional[float] = None

    @property
    def rep(self) -> int:
        return self.num_heads // self.num_kv_heads

    def unsupported(self) -> Optional[str]:
        """Why the fused kernel cannot run this spec, or None."""
        checks = (
            (self.norm not in ("ln", "rms"), f"norm={self.norm!r}"),
            (self.qkv not in ("fused", "headmajor", "split"),
             f"qkv={self.qkv!r}"),
            (self.mlp not in _MLPS, f"mlp={self.mlp!r}"),
            (self.residual not in ("serial", "parallel"),
             f"residual={self.residual!r}"),
            (self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads,
             f"num_heads={self.num_heads} over num_kv_heads="
             f"{self.num_kv_heads}"),
            (self.qkv in ("fused", "headmajor")
             and self.num_kv_heads != self.num_heads,
             f"qkv={self.qkv!r} with grouped-query attention"),
            (not 0 <= self.rotary_dims <= self.head_dim
             or self.rotary_dims % 2,
             f"rotary_dims={self.rotary_dims} of head_dim {self.head_dim}"),
            (self.rotary_interleaved, "rotary_interleaved"),
        )
        for bad, what in checks:
            if bad:
                return what
        return None

    def supported(self) -> bool:
        return self.unsupported() is None


def _weight_order(spec: FusedLayerSpec):
    """Canonical weight-dict keys of a spec, in kernel argument order (the
    reference's ``_weight_order``)."""
    order = ["n1_s"] + (["n1_b"] if spec.norm == "ln" else [])
    if spec.qkv == "split":
        order += ["wq", "wk", "wv"]
        if spec.qkv_bias:
            order += ["bq", "bk", "bv"]
    else:
        order += ["wqkv"]
        if spec.qkv_bias:
            order += ["bqkv"]
    order += ["wo"]
    if spec.out_bias:
        order += ["bo"]
    if spec.mlp != "none":
        order += ["n2_s"] + (["n2_b"] if spec.norm == "ln" else [])
        if spec.mlp == "swiglu":
            order += ["w_gate", "w_up", "w_down"]
        else:
            order += ["w_in"] + (["b_in"] if spec.mlp_bias else [])
            order += ["w_out"] + (["b_out"] if spec.mlp_bias else [])
    return order


def _check_spec(spec: FusedLayerSpec):
    why = spec.unsupported()
    if why is not None:
        raise NotImplementedError(
            f"ds_fused_layer: {why}: the fused layer kernel does not take "
            "this spec, as the reference's kernel does not; serve it with "
            "fused decode off")


# ------------------------------------------------------------ plain version
def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _norm(x, spec, scale, bias):
    """The spec's norm as the families' unfused blocks compute it."""
    from deepspeed_tpu_torch.models.llama import _rms_norm
    if spec.norm == "rms":
        return _rms_norm(x, scale, spec.eps)
    return _layer_norm(x, scale, bias, spec.eps)


def _dot(x, w):
    """The plain projection: int8 weights through qgemm's plain version
    (dequantize, round to x's dtype, matmul), float weights ``x @ w``."""
    if isinstance(w, QuantizedTensor):
        return qgemm_plain(x, w.q, w.s)
    return x @ w.to(x.dtype)


def _act(h, mlp):
    if mlp == "relu":
        return F.relu(h)
    return F.gelu(h, approximate="tanh" if mlp == "gelu_tanh" else "none")


def _ref_rope(x, spec: FusedLayerSpec, positions):
    """Full or partial (NeoX) rotary with the split-half pairing (the
    reference's ``_ref_rope``): the first ``rotary_dims`` of each head
    rotate, the rest pass through."""
    from deepspeed_tpu_torch.models.llama import rope
    rot = spec.rotary_dims
    if rot == x.shape[-1]:
        return rope(x, spec.rope_theta, positions)
    xr = rope(x[..., :rot], spec.rope_theta, positions)
    return torch.cat([xr, x[..., rot:]], dim=-1)


def _ref_qkv(x, cw, spec: FusedLayerSpec, positions, dot=_dot):
    """norm1 + QKV (+ biases) + rotary (the reference's ``_ref_qkv``):
    q [B, W, H, hd], k / v [B, W, KV, hd].  ``dot`` computes a
    projection."""
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    h = _norm(x, spec, cw["n1_s"], cw.get("n1_b"))
    dt = h.dtype
    if spec.qkv == "split":
        q, kk, v = (dot(h, cw[k]) for k in ("wq", "wk", "wv"))
        if spec.qkv_bias:
            q, kk, v = (t + cw[k].to(dt)
                        for t, k in zip((q, kk, v), ("bq", "bk", "bv")))
    else:
        qkv = dot(h, cw["wqkv"])
        if spec.qkv_bias:
            qkv = qkv + cw["bqkv"].to(dt)
        if spec.qkv == "headmajor":
            q, kk, v = qkv.unflatten(-1, (H, 3 * hd)).split(hd, dim=-1)
        else:
            q, kk, v = qkv.split(H * hd, dim=-1)
    if spec.qkv != "headmajor":
        q = q.unflatten(-1, (H, hd))
        kk, v = kk.unflatten(-1, (KV, hd)), v.unflatten(-1, (KV, hd))
    if spec.rotary_dims:
        q = _ref_rope(q, spec, positions)
        kk = _ref_rope(kk, spec, positions)
    return q, kk, v


def _ref_finish(x, attn_flat, cw, spec: FusedLayerSpec, dot=_dot):
    """attn-out (+ bias) + residual and norm2 + MLP + residual (the
    reference's ``_ref_finish``): serial, norm2 over ``x + attn_out``; or
    parallel, norm2 over ``x`` and ``(x + attn_out) + mlp_out``.
    ``mlp="none"`` stops after the attention residual; ``dot`` computes a
    projection."""
    dt = x.dtype
    attn_out = dot(attn_flat, cw["wo"])
    if spec.out_bias:
        attn_out = attn_out + cw["bo"].to(dt)
    res = x + attn_out
    if spec.mlp == "none":
        return res
    h2 = _norm(x if spec.residual == "parallel" else res, spec, cw["n2_s"],
               cw.get("n2_b"))
    if spec.mlp == "swiglu":
        gated = F.silu(dot(h2, cw["w_gate"])) * dot(h2, cw["w_up"])
        return res + dot(gated, cw["w_down"])
    m = dot(h2, cw["w_in"])
    if spec.mlp_bias:
        m = m + cw["b_in"].to(dt)
    m = dot(_act(m, spec.mlp), cw["w_out"])
    if spec.mlp_bias:
        m = m + cw["b_out"].to(dt)
    return res + m


def fused_layer_plain(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec,
                      ks_l=None, vs_l=None, alibi_slopes=None):
    """Plain PyTorch version (the reference's ``_ref_fused_layer``): the
    unfused per-layer body on copies of the cache, window position j
    rotated and written at ``lengths + j`` and attending ``lengths + j +
    1`` positions (with the ALiBi slopes for an ``alibi`` spec).  Returns
    ``(x_out, new_k, new_v, new_ks, new_vs)``."""
    _check_spec(spec)
    _check_slopes(spec, alibi_slopes)
    B, W, D = x.shape
    H, hd = spec.num_heads, spec.head_dim
    dt = x.dtype
    quantized = ks_l is not None
    rows = torch.arange(B, device=x.device)
    positions = lengths[:, None] + torch.arange(W, dtype=lengths.dtype,
                                                device=x.device)
    q, kk, v = _ref_qkv(x, cw, spec, positions)
    k_l, v_l = k_l.clone(), v_l.clone()
    if quantized:
        ks_l, vs_l = ks_l.clone(), vs_l.clone()
    new_k, new_v, new_ks, new_vs, cols = [], [], [], [], []
    for j in range(W):
        pos = (lengths + j).long()
        if quantized:
            kq, ks1 = quantize_kv(kk[:, j])
            vq, vs1 = quantize_kv(v[:, j])
            for c, val in ((k_l, kq), (v_l, vq), (ks_l, ks1), (vs_l, vs1)):
                c[rows, pos] = val
            new_k.append(kq)
            new_v.append(vq)
            new_ks.append(ks1)
            new_vs.append(vs1)
        else:
            k_l[rows, pos] = kk[:, j].to(k_l.dtype)
            v_l[rows, pos] = v[:, j].to(v_l.dtype)
            new_k.append(kk[:, j].to(k_l.dtype))
            new_v.append(v[:, j].to(v_l.dtype))
        cols.append(decode_attention_plain(
            q[:, j].contiguous(), k_l, v_l, (lengths + j + 1).to(torch.int32),
            spec.sm_scale, ks_l, vs_l, alibi_slopes))
    attn = torch.stack(cols, dim=1).reshape(B, W, H * hd).to(dt)
    x_out = _ref_finish(x, attn, cw, spec)
    out = (x_out, torch.stack(new_k, 1), torch.stack(new_v, 1))
    if quantized:
        return out + (torch.stack(new_ks, 1), torch.stack(new_vs, 1))
    return out + (None, None)


def attn_workspace(B, W, H, KV, hd, S_max):
    """(floats, counters) of the attention phase's chunk partials: per
    (row, kv head, query chunk) one slot per chunk of the cache and the
    window, each the max, sum and P V of up to ATTN_QMAX queries (csrc
    attn_ws_floats)."""
    nq = W * (H // KV)
    nqc = -(-nq // ATTN_QMAX)
    zmax = -(-(S_max + W) // ATTN_CHUNK)
    slot = min(nq, ATTN_QMAX) * (hd + 2)
    return B * KV * nqc * zmax * slot, B * KV * nqc


def attention_split_walk(q, k_l, v_l, lengths, kw, vw, sm_scale,
                         ks_l=None, vs_l=None, alibi_slopes=None,
                         chunk=None):
    """The fused kernel's attention phase in plain torch, fp32: q [B, W, H,
    hd] (the rotated queries), the cache k_l / v_l [B, S, KV, hd] (int8
    codes with ks_l / vs_l [B, S, KV], dequantized code * scale), the
    window's own K/V kw / vw [B, W, KV, hd] as the cache would hold them.
    Window position j of a row attends its cache's first lengths[b]
    positions and the window's first j + 1.  The walk: per (row, kv head,
    chunk of ATTN_QMAX query vectors) the positions in chunks of
    ``chunk`` (ATTN_CHUNK) at fixed absolute boundaries; per chunk the
    scores (q *
    sm_scale) . k, ALiBi as one rounded product and one rounded sum, the
    chunk's max m, p = exp(s - m), l = sum p, acc = p @ v; the chunks
    merged in order, online.  Returns [B, W, H, hd] fp32."""
    B, W, H, hd = q.shape
    KV = k_l.shape[2]
    rep = H // KV
    chunk = chunk or ATTN_CHUNK
    k = k_l.float() if ks_l is None else k_l.float() * ks_l[..., None]
    v = v_l.float() if vs_l is None else v_l.float() * vs_l[..., None]
    out = torch.zeros(B, W, H, hd, dtype=torch.float32)
    nq = W * rep
    for b in range(B):
        n_len = int(lengths[b])
        for kvh in range(KV):
            keys = torch.cat([k[b, :n_len, kvh], kw[b, :, kvh].float()])
            vals = torch.cat([v[b, :n_len, kvh], vw[b, :, kvh].float()])
            for q0 in range(0, nq, ATTN_QMAX):
                qq = list(range(q0, min(nq, q0 + ATTN_QMAX)))
                js = [i // rep for i in qq]
                hs = [kvh * rep + i % rep for i in qq]
                qv = q[b, js, hs].float() * sm_scale         # [qn, hd]
                total = n_len + js[-1] + 1
                lim = torch.tensor([n_len + j + 1 for j in js])
                M = torch.full((len(qq),), -1e30)
                Ls = torch.zeros(len(qq))
                O = torch.zeros(len(qq), hd)
                for s0 in range(0, total, chunk):
                    s1 = min(total, s0 + chunk)
                    pos = torch.arange(s0, s1)
                    sc = qv @ keys[s0:s1].T                   # [qn, n]
                    if alibi_slopes is not None:
                        sl = alibi_slopes[hs].float()[:, None]
                        sc = sc + sl * pos.float()[None]
                    valid = pos[None] < lim[:, None]
                    sc = torch.where(valid, sc, torch.tensor(-1e30))
                    m = sc.max(dim=1).values
                    p = torch.where(valid, torch.exp(sc - m[:, None]),
                                    torch.zeros(()))
                    l_c, a_c = p.sum(dim=1), p @ vals[s0:s1]
                    Mn = torch.maximum(M, m)
                    f0, f1 = torch.exp(M - Mn), torch.exp(m - Mn)
                    Ls = Ls * f0 + l_c * f1
                    O = O * f0[:, None] + a_c * f1[:, None]
                    M = Mn
                out[b, js, hs] = O / Ls.clamp_min(1e-30)[:, None]
    return out


def fused_layer_walk(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec, sms,
                     ks_l=None, vs_l=None, alibi_slopes=None):
    """The kernel's decomposition of one fused layer step in plain torch:
    the plain version's norms, biases, rotary and residuals, every
    projection by ``qgemm.decode_walk`` (its K splits on ``sms``
    multiprocessors, 8-row passes, split-order sums) and the attention by
    :func:`attention_split_walk` over the window's K/V as the cache holds
    them.  Returns ``x_out`` [B, W, D]."""
    from deepspeed_tpu_torch.ops.kernels.qgemm import decode_walk
    _check_spec(spec)
    B, W, D = x.shape
    H, hd = spec.num_heads, spec.head_dim

    def dot(a, w):
        lead = a.shape[:-1]
        if isinstance(w, QuantizedTensor):
            from deepspeed_tpu_torch.ops.kernels.quantization import \
                block_dequantize_int8
            wt = block_dequantize_int8(w.q, w.s).to(a.dtype)
        else:
            wt = w.to(a.dtype)
        return decode_walk(a.reshape(-1, a.shape[-1]), wt, sms).reshape(
            *lead, wt.shape[-1])
    positions = lengths[:, None] + torch.arange(W, dtype=lengths.dtype)
    q, kk, v = _ref_qkv(x, cw, spec, positions, dot)
    if ks_l is not None:
        (kq, ksw), (vq, vsw) = quantize_kv(kk), quantize_kv(v)
        kw, vw = kq.float() * ksw[..., None], vq.float() * vsw[..., None]
    else:
        kw, vw = kk.to(k_l.dtype).float(), v.to(v_l.dtype).float()
    sm = spec.sm_scale if spec.sm_scale is not None else hd ** -0.5
    attn = attention_split_walk(q, k_l, v_l, lengths, kw, vw, sm, ks_l,
                                vs_l, alibi_slopes)
    return _ref_finish(x, attn.reshape(B, W, H * hd).to(x.dtype), cw, spec,
                       dot)


def _check_slopes(spec: FusedLayerSpec, alibi_slopes):
    if spec.alibi != (alibi_slopes is not None):
        raise ValueError("ds_fused_layer: an alibi spec takes alibi_slopes "
                         "[H] and no other spec does")


# ------------------------------------------------------------------ kernel
class _Mat(ctypes.Structure):
    """``Mat`` of csrc/fused_decode.cu: one projection of a GEMM phase."""
    _fields_ = [("w", ctypes.c_void_p), ("s", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("nb", ctypes.c_int), ("N", ctypes.c_int),
                ("split", ctypes.c_int)]


class _FusedArgs(ctypes.Structure):
    """``FusedArgs`` of csrc/fused_decode.cu, field for field."""
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "W", "D", "H", "KV", "HD",
                                     "S_max", "norm", "mlp", "nqkv",
                                     "nmlp_in", "headmajor", "rot",
                                     "parallel")]
        + [("eps", ctypes.c_float), ("sm_scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in ("x", "lengths", "n1_s", "n1_b",
                                          "n2_s", "n2_b", "rope", "alibi")]
        + [("qkv", _Mat * 3), ("o", _Mat), ("mlp_in", _Mat * 2),
           ("mlp_out", _Mat)]
        + [(n, ctypes.c_void_p) for n in ("k_cache", "v_cache", "ks_cache",
                                          "vs_cache", "x_out", "new_k",
                                          "new_v", "new_ks", "new_vs",
                                          "abuf", "xres", "part")]
        + [("part_floats", ctypes.c_longlong)]
        + [(n, ctypes.c_void_p) for n in ("qf", "kw", "vw", "bar",
                                          "stamps", "attn_ws")]
        + [("attn_floats", ctypes.c_longlong), ("attn_cnt", ctypes.c_void_p)])

#: the intervals between the kernel's phase stamps (``stamps`` option of
#: :func:`fused_layer_cuda`); the last is CTA 0's share of the final
#: phase.  An ``mlp="none"`` layer ends at "residual": the later
#: intervals read 0
PHASES = ("norm1", "qkv_gemm", "qkv_epilogue", "attention", "out_proj_gemm",
          "residual", "norm2", "mlp_in_gemm", "mlp_in_epilogue",
          "mlp_out_gemm", "mlp_out_epilogue_cta0")


def _lib():
    lib = build.load("fused_decode")
    fn = lib.ds_fused_layer
    if fn.argtypes is None:
        size = lib.ds_fused_layer_args_size()
        if size != ctypes.sizeof(_FusedArgs):
            raise RuntimeError(f"ds_fused_layer: FusedArgs is {size} bytes in "
                               f"C, {ctypes.sizeof(_FusedArgs)} here")
        i = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_FusedArgs), i, i, i, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


#: per device: the grid barrier's [count, generation] (the count is 0
#: between launches; launches on one device are stream-ordered)
_barriers = {}
#: per (rope theta, rotary dims, device): the rotary frequencies
_rope_tables = {}


def _barrier(device):
    bar = _barriers.get(device)
    if bar is None:
        bar = torch.zeros(2, dtype=torch.int32, device=device)
        _barriers[device] = bar
    return bar


def _rope_table(theta, rot, device):
    """``rope_freqs(theta, rot)`` on ``device``, made once: the unfused
    path's own frequencies (over the rotary dims, as the reference's
    ``rope(x[..., :rot])``), so the kernel's angles are its angles."""
    from deepspeed_tpu_torch.models.llama import rope_freqs
    key = (float(theta), int(rot), device)
    table = _rope_tables.get(key)
    if table is None:
        table = rope_freqs(theta, rot, device).contiguous()
        _rope_tables[key] = table
    return table


def _expect(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"ds_fused_layer: {name} is {tuple(t.shape)} {t.dtype} on "
            f"{t.device} (contiguous: {t.is_contiguous()}); need "
            f"{tuple(shape)} {dtype} contiguous on {device}")


def _phases(spec: FusedLayerSpec, D, M):
    """The projections of each GEMM phase as (weight key, bias key or
    None, K, N), in the kernel's order: QKV, attention-out, MLP-in,
    MLP-out (the MLP phases empty for ``mlp="none"``)."""
    Dq = spec.num_heads * spec.head_dim
    Dk = spec.num_kv_heads * spec.head_dim
    if spec.qkv == "split":
        qkv = [(w, b if spec.qkv_bias else None, D, n) for w, b, n in
               (("wq", "bq", Dq), ("wk", "bk", Dk), ("wv", "bv", Dk))]
    else:
        qkv = [("wqkv", "bqkv" if spec.qkv_bias else None, D, Dq + 2 * Dk)]
    o = [("wo", "bo" if spec.out_bias else None, Dq, D)]
    if spec.mlp == "none":
        return qkv, o, [], []
    if spec.mlp == "swiglu":
        return (qkv, o, [("w_gate", None, D, M), ("w_up", None, D, M)],
                [("w_down", None, M, D)])
    bias = spec.mlp_bias
    return (qkv, o, [("w_in", "b_in" if bias else None, D, M)],
            [("w_out", "b_out" if bias else None, M, D)])


def fused_layer_cuda(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec,
                     ks_l=None, vs_l=None, alibi_slopes=None, stamps=None):
    """Launch the CUDA kernel; raises on anything it does not take.
    ``stamps``: an int64 CUDA tensor of ``len(PHASES) + 1`` elements that
    receives the device clock (ns) at each phase boundary (see PHASES)."""
    _check_spec(spec)
    _check_slopes(spec, alibi_slopes)
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"ds_fused_layer: x {tuple(x.shape)} {x.dtype}; "
                         f"need [B, W, D] in {_DTYPES}")
    B, W, D = x.shape
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if D != spec.d_model or hd > MAX_HEAD_DIM or H * hd != D:
        raise ValueError(f"ds_fused_layer: d_model {D} vs spec {spec}; the "
                         f"kernel takes H * head_dim == d_model, head_dim <= "
                         f"{MAX_HEAD_DIM}")
    dev, dt = x.device, x.dtype
    _expect("x", x, (B, W, D), dt, dev)
    quantized = ks_l is not None
    cdt = torch.int8 if quantized else dt
    S = k_l.shape[1] if k_l.dim() == 4 else -1
    for name, t in (("k_l", k_l), ("v_l", v_l)):
        _expect(name, t, (B, S, KV, hd), cdt, dev)
    if quantized:
        if vs_l is None:
            raise ValueError("ds_fused_layer: an int8 cache needs ks_l and "
                             "vs_l")
        for name, t in (("ks_l", ks_l), ("vs_l", vs_l)):
            _expect(name, t, (B, S, KV), torch.float32, dev)
    _expect("lengths", lengths, (B,), torch.int32, dev)
    M = 0
    if spec.mlp != "none":
        w_in = cw["w_gate" if spec.mlp == "swiglu" else "w_in"]
        M = (w_in.q if isinstance(w_in, QuantizedTensor) else w_in).shape[-1]
    phases = _phases(spec, D, M)
    w_int8 = isinstance(cw[phases[0][0][0]], QuantizedTensor)
    if dt == torch.bfloat16:
        for mats in phases:
            for key, _, K, N in mats:
                w = cw[key]
                nb = w.s.shape[-1] if w_int8 else 0
                if not stream_ok(K, N, nb, w_int8):
                    raise ValueError(
                        f"ds_fused_layer: {key} [{K}, {N}] (scale groups "
                        f"{nb}) is off the decode weight stream's shapes "
                        "(qgemm.stream_ok); serve it with fused decode off")
    a = _FusedArgs(B=B, W=W, D=D, H=H, KV=KV, HD=hd, S_max=S,
                   norm=int(spec.norm == "rms"), mlp=_MLPS[spec.mlp],
                   nqkv=len(phases[0]), nmlp_in=len(phases[2]),
                   headmajor=int(spec.qkv == "headmajor"),
                   rot=spec.rotary_dims,
                   parallel=int(spec.residual == "parallel"),
                   eps=float(spec.eps),
                   sm_scale=float(spec.sm_scale if spec.sm_scale is not None
                                  else hd ** -0.5))
    slots = (a.qkv, (a.o,), a.mlp_in, (a.mlp_out,))
    for mats, slot in zip(phases, slots):
        for (key, bkey, K, N), m in zip(mats, slot):
            w = cw[key]
            if isinstance(w, QuantizedTensor) != w_int8:
                raise ValueError("ds_fused_layer: the projection weights "
                                 "must be all int8 or all float")
            if w_int8:
                nb = w.s.shape[-1]
                _expect(key, w.q, (K, N), torch.int8, dev)
                _expect(f"{key} scales", w.s, (K, nb), torch.float32, dev)
                if not 1 <= nb <= N:
                    raise ValueError(f"ds_fused_layer: {key} has {nb} scale "
                                     f"groups over {N} columns")
                m.w, m.s, m.nb = w.q.data_ptr(), w.s.data_ptr(), nb
            else:
                _expect(key, w, (K, N), dt, dev)
                m.w = w.data_ptr()
            m.N = N
            if bkey is not None:
                _expect(bkey, cw[bkey], (N,), dt, dev)
                m.bias = cw[bkey].data_ptr()
    norms = [("n1_s", "n1_b")] + ([("n2_s", "n2_b")]
                                  if spec.mlp != "none" else [])
    for s_key, b_key in norms:
        _expect(s_key, cw[s_key], (D,), dt, dev)
        setattr(a, s_key, cw[s_key].data_ptr())
        if spec.norm == "ln":
            _expect(b_key, cw[b_key], (D,), dt, dev)
            setattr(a, b_key, cw[b_key].data_ptr())
    if spec.rotary_dims:
        a.rope = _rope_table(spec.rope_theta, spec.rotary_dims,
                             dev).data_ptr()
    if spec.alibi:
        _expect("alibi_slopes", alibi_slopes, (H,), torch.float32, dev)
        a.alibi = alibi_slopes.data_ptr()
    R = B * W
    x_out = torch.empty_like(x)
    new_k = torch.empty((B, W, KV, hd), dtype=cdt, device=dev)
    new_v = torch.empty_like(new_k)
    new_ks = new_vs = None
    if quantized:
        new_ks = torch.empty((B, W, KV), dtype=torch.float32, device=dev)
        new_vs = torch.empty_like(new_ks)
        a.ks_cache, a.vs_cache = ks_l.data_ptr(), vs_l.data_ptr()
        a.new_ks, a.new_vs = new_ks.data_ptr(), new_vs.data_ptr()
    # scratch of one call (stream-ordered caching allocator); the partial
    # sums of a phase's projections lie side by side in `part`
    cols = max(sum(n for *_, n in mats) for mats in phases)
    abuf = torch.empty((R, max(D, H * hd, M)), dtype=dt, device=dev)
    xres = torch.empty((R, D), dtype=dt, device=dev)
    part = torch.empty((MAX_SPLIT, R, cols), dtype=torch.float32, device=dev)
    a.part_floats = part.numel()
    qf = torch.empty((R, H * hd), dtype=torch.float32, device=dev)
    kw = torch.empty((R, KV * hd), dtype=torch.float32, device=dev)
    vw = torch.empty_like(kw)
    for name, t in (("x", x), ("lengths", lengths), ("k_cache", k_l),
                    ("v_cache", v_l), ("x_out", x_out), ("new_k", new_k),
                    ("new_v", new_v), ("abuf", abuf), ("xres", xres),
                    ("part", part), ("qf", qf), ("kw", kw), ("vw", vw),
                    ("bar", _barrier(dev))):
        setattr(a, name, t.data_ptr())
    if stamps is not None:
        _expect("stamps", stamps, (len(PHASES) + 1,), torch.int64, dev)
        a.stamps = stamps.data_ptr()
    n_ws, n_cnt = attn_workspace(B, W, H, KV, hd, S)
    ws, cnt = build.scratch(dev, n_ws, n_cnt)
    a.attn_ws, a.attn_floats, a.attn_cnt = (ws.data_ptr(), ws.numel(),
                                            cnt.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(ctypes.byref(a), int(dt == torch.bfloat16), int(w_int8),
                    int(quantized), stream)
    build.check(rc, "ds_fused_layer")
    ds_fused_layer.launches += 1
    return x_out, new_k, new_v, new_ks, new_vs


def ds_fused_layer(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec,
                   ks_l=None, vs_l=None, alibi_slopes=None):
    """One decoder layer's fused window step: ``x`` [B, W, D]; ``cw`` the
    canonical weights (``_weight_order``; int8 projections as
    ``QuantizedTensor``); ``k_l``/``v_l`` [B, S, KV, hd] this layer's
    cache (positions < ``lengths`` valid; the window's own K/V are not in
    it yet); ``lengths`` int32 [B]; int8 caches pass ``ks_l``/``vs_l``
    [B, S, KV]; an ``alibi`` spec passes its ``alibi_slopes`` [H] fp32.
    Returns ``(x_out [B, W, D], new_k [B, W, KV, hd], new_v, new_ks,
    new_vs)`` (scales None for a float cache).  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return fused_layer_cuda(x, cw, k_l, v_l, lengths, spec, ks_l, vs_l,
                                alibi_slopes)
    if x.device.type == "cpu":
        return fused_layer_plain(x, cw, k_l, v_l, lengths, spec, ks_l, vs_l,
                                 alibi_slopes)
    raise ValueError(f"ds_fused_layer: unsupported device {x.device}")


#: kernel launches since the count was last set to 0
ds_fused_layer.launches = 0
