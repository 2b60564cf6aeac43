"""Fused per-layer decode step (port of
``deepspeed_tpu/ops/pallas/fused_decode.py`` ``ds_fused_layer``): one
decoder layer's W-token window step in one kernel launch, so a decode
step issues L launches for its layers instead of about six per layer.

    norm1 -> QKV (+bias) -> new K/V (int8 quantize for an int8 cache) ->
    attention over the cache AND the window's own tokens -> attn-out
    (+bias) + residual -> norm2 -> MLP (+biases) + residual

:func:`ds_fused_layer` launches the CUDA kernel in ``csrc/fused_decode.cu``
for CUDA tensors and takes :func:`fused_layer_plain` for CPU tensors.  The
plain version is the reference's ``_ref_fused_layer``: exactly the unfused
per-layer composition (the same LayerNorm, projections, ``quantize_kv``
and decode attention, in plain PyTorch), so fused and unfused decode agree
bitwise on the CPU.

The kernel covers the GPT-2 spec: ``norm="ln"``, ``qkv="fused"`` with
biases, ``mlp`` in gelu_tanh / gelu_exact / relu with biases, the serial
residual, ``num_kv_heads == num_heads``, no rotary and no ALiBi, any
window W >= 1, head_dim <= 128.  Every other spec raises
NotImplementedError (ROADMAP.md Queue B: the other families' variants).
The reference's VMEM-budget fallback is not ported: the kernel streams
each weight once per call and needs no resident layer.

The cache is input-only: the new K/V (int8 codes plus fp32 scales for an
int8 cache) come back as outputs and the caller writes them with
``write_token``, as in the reference.
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
from deepspeed_tpu_torch.ops.kernels.qgemm import qgemm_plain

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
#: K splits per GEMM phase the kernel may use (csrc kMaxSplit)
MAX_SPLIT = 16
_ACTS = {"gelu_tanh": 0, "gelu_exact": 1, "relu": 2}


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
        """Why the port cannot run this spec yet, or None (the GPT-2
        spec)."""
        checks = (
            (self.norm != "ln", f"norm={self.norm!r}"),
            (self.qkv != "fused", f"qkv={self.qkv!r}"),
            (not (self.qkv_bias and self.out_bias and self.mlp_bias),
             "a projection without bias"),
            (self.mlp not in _ACTS, f"mlp={self.mlp!r}"),
            (self.residual != "serial", f"residual={self.residual!r}"),
            (self.num_kv_heads != self.num_heads,
             f"num_kv_heads={self.num_kv_heads} != num_heads="
             f"{self.num_heads}"),
            (self.rotary_dims != 0, f"rotary_dims={self.rotary_dims}"),
            (self.alibi, "alibi"),
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
            f"ds_fused_layer: {why}: only the GPT-2 spec is ported to "
            "deepspeed_tpu_torch (ROADMAP.md Queue B: fused_decode's other "
            "specs — rotary, GQA, RMSNorm, SwiGLU and the MoE "
            "(mlp='none') variant — port slice 6)")


# ------------------------------------------------------------ plain version
def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


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


def fused_layer_plain(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec,
                      ks_l=None, vs_l=None):
    """Plain PyTorch version (the reference's ``_ref_fused_layer``): the
    unfused per-layer body on copies of the cache, window position j
    written at ``lengths + j`` and attending ``lengths + j + 1``
    positions.  Returns ``(x_out, new_k, new_v, new_ks, new_vs)``."""
    _check_spec(spec)
    B, W, D = x.shape
    H, hd = spec.num_heads, spec.head_dim
    dt = x.dtype
    quantized = ks_l is not None
    rows = torch.arange(B, device=x.device)
    h = _layer_norm(x, cw["n1_s"], cw["n1_b"], spec.eps)
    qkv = _dot(h, cw["wqkv"]) + cw["bqkv"].to(dt)
    q, kk, v = (t.unflatten(-1, (H, hd)) for t in qkv.split(H * hd, dim=-1))
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
            spec.sm_scale, ks_l, vs_l))
    attn = torch.stack(cols, dim=1).reshape(B, W, H * hd).to(dt)
    x = x + (_dot(attn, cw["wo"]) + cw["bo"].to(dt))
    h2 = _layer_norm(x, cw["n2_s"], cw["n2_b"], spec.eps)
    m = _act(_dot(h2, cw["w_in"]) + cw["b_in"].to(dt), spec.mlp)
    x_out = x + (_dot(m, cw["w_out"]) + cw["b_out"].to(dt))
    out = (x_out, torch.stack(new_k, 1), torch.stack(new_v, 1))
    if quantized:
        return out + (torch.stack(new_ks, 1), torch.stack(new_vs, 1))
    return out + (None, None)


# ------------------------------------------------------------------ kernel
_PTRS = ("x", "lengths", "n1_s", "n1_b", "bqkv", "bo", "n2_s", "n2_b",
         "b_in", "b_out", "wqkv", "wo", "w_in", "w_out", "sqkv", "so",
         "s_in", "s_out")
_OUT_PTRS = ("k_cache", "v_cache", "ks_cache", "vs_cache", "x_out", "new_k",
             "new_v", "new_ks", "new_vs", "abuf", "xres", "part", "qf", "kw",
             "vw", "bar")


class _FusedArgs(ctypes.Structure):
    """``FusedArgs`` of csrc/fused_decode.cu, field for field."""
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "W", "D", "H", "KV", "HD", "M",
                                     "S_max", "act")]
        + [("eps", ctypes.c_float), ("sm_scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in _PTRS]
        + [(n, ctypes.c_int) for n in ("nb_qkv", "nb_o", "nb_in", "nb_out")]
        + [(n, ctypes.c_void_p) for n in _OUT_PTRS]
        + [(n, ctypes.c_int) for n in ("split_qkv", "split_o", "split_in",
                                       "split_out")]
        + [("stamps", ctypes.c_void_p)])

#: the intervals between the kernel's phase stamps (``stamps`` option of
#: :func:`fused_layer_cuda`); the last is CTA 0's share of the final phase
PHASES = ("ln1", "qkv_gemm", "qkv_epilogue", "attention", "out_proj_gemm",
          "residual", "ln2", "mlp_in_gemm", "mlp_in_epilogue",
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


def _barrier(device):
    bar = _barriers.get(device)
    if bar is None:
        bar = torch.zeros(2, dtype=torch.int32, device=device)
        _barriers[device] = bar
    return bar


def _expect(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"ds_fused_layer: {name} is {tuple(t.shape)} {t.dtype} on "
            f"{t.device} (contiguous: {t.is_contiguous()}); need "
            f"{tuple(shape)} {dtype} contiguous on {device}")


def fused_layer_cuda(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec,
                     ks_l=None, vs_l=None, stamps=None):
    """Launch the CUDA kernel; raises on anything it does not take.
    ``stamps``: an int64 CUDA tensor of ``len(PHASES) + 1`` elements that
    receives the device clock (ns) at each phase boundary (see PHASES)."""
    _check_spec(spec)
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
    mats = {"wqkv": (D, 3 * D), "wo": (D, D)}
    w_in = cw["w_in"]
    M = (w_in.q if isinstance(w_in, QuantizedTensor) else w_in).shape[-1]
    mats.update(w_in=(D, M), w_out=(M, D))
    w_int8 = isinstance(cw["wqkv"], QuantizedTensor)
    a = _FusedArgs(B=B, W=W, D=D, H=H, KV=KV, HD=hd, M=M, S_max=S,
                   act=_ACTS[spec.mlp], eps=float(spec.eps),
                   sm_scale=float(spec.sm_scale if spec.sm_scale is not None
                                  else hd ** -0.5))
    for key, scale_key, nb_key in (("wqkv", "sqkv", "nb_qkv"),
                                   ("wo", "so", "nb_o"),
                                   ("w_in", "s_in", "nb_in"),
                                   ("w_out", "s_out", "nb_out")):
        w = cw[key]
        K, N = mats[key]
        if isinstance(w, QuantizedTensor) != w_int8:
            raise ValueError("ds_fused_layer: the four projection weights "
                             "must be all int8 or all float")
        if w_int8:
            nb = w.s.shape[-1]
            _expect(key, w.q, (K, N), torch.int8, dev)
            _expect(scale_key, w.s, (K, nb), torch.float32, dev)
            if not 1 <= nb <= N:
                raise ValueError(f"ds_fused_layer: {key} has {nb} scale "
                                 f"groups over {N} columns")
            setattr(a, key, w.q.data_ptr())
            setattr(a, scale_key, w.s.data_ptr())
            setattr(a, nb_key, nb)
        else:
            _expect(key, w, (K, N), dt, dev)
            setattr(a, key, w.data_ptr())
    for key, n in (("n1_s", D), ("n1_b", D), ("bqkv", 3 * D), ("bo", D),
                   ("n2_s", D), ("n2_b", D), ("b_in", M), ("b_out", D)):
        _expect(key, cw[key], (n,), dt, dev)
        setattr(a, key, cw[key].data_ptr())
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
    # scratch of one call (stream-ordered caching allocator)
    abuf = torch.empty((R, max(D, M)), dtype=dt, device=dev)
    xres = torch.empty((R, D), dtype=dt, device=dev)
    part = torch.empty((MAX_SPLIT, R, max(3 * D, M)), dtype=torch.float32,
                       device=dev)
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(ctypes.byref(a), int(dt == torch.bfloat16), int(w_int8),
                    int(quantized), stream)
    build.check(rc, "ds_fused_layer")
    ds_fused_layer.launches += 1
    return x_out, new_k, new_v, new_ks, new_vs


def ds_fused_layer(x, cw, k_l, v_l, lengths, spec: FusedLayerSpec,
                   ks_l=None, vs_l=None):
    """One decoder layer's fused window step: ``x`` [B, W, D]; ``cw`` the
    canonical weights (``_weight_order``; int8 projections as
    ``QuantizedTensor``); ``k_l``/``v_l`` [B, S, KV, hd] this layer's
    cache (positions < ``lengths`` valid; the window's own K/V are not in
    it yet); ``lengths`` int32 [B]; int8 caches pass ``ks_l``/``vs_l``
    [B, S, KV].  Returns ``(x_out [B, W, D], new_k [B, W, KV, hd], new_v,
    new_ks, new_vs)`` (scales None for a float cache).  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return fused_layer_cuda(x, cw, k_l, v_l, lengths, spec, ks_l, vs_l)
    if x.device.type == "cpu":
        return fused_layer_plain(x, cw, k_l, v_l, lengths, spec, ks_l, vs_l)
    raise ValueError(f"ds_fused_layer: unsupported device {x.device}")


#: kernel launches since the count was last set to 0
ds_fused_layer.launches = 0

