"""deepspeed_tpu_torch decode weight stream (``csrc/decode_stream.cuh``) and
the fused layer's attention split over the cache, as their
decompositions walked in plain torch.

- ``qgemm.decode_walk`` (K splits by N, K and the SM count; fixed 8-row
  passes; the splits' partials added in split order) against the JAX
  Pallas ``_qgemm_kernel`` in interpret mode and against the plain
  version, fp32 to 1e-5, at M 1 / 8 / 96 / 128 over a ragged N and a K
  with a part-filled last stage.
- A row's bits in the walk whatever M (1, 8, 96, 128), fp32 and bf16.
- The split rule at the served shapes and its invariants.
- ``fused_decode.attention_split_walk`` (chunks of 64 positions at fixed
  boundaries, the window's own tokens where they fall, (m, l, acc)
  partials merged in chunk order) against the JAX Pallas
  ``_decode_kernel`` in interpret mode and the port's plain decode
  attention, fp32 to 1e-5, with lengths at the chunk edges: MHA, GQA with
  two query chunks, ALiBi and an int8 cache, W 1 and 3.
- ``fused_decode.fused_layer_walk`` (every projection by the walk, the
  attention by the split walk) against the JAX Pallas ``_fused_kernel``
  in interpret mode (2e-4, the JAX package's own kernel bound, as
  ``tests/test_torch_fused_decode.py`` holds the plain version) and the
  port's plain fused layer (1e-5).
- The route rule of ``qgemm`` (bf16 stream, fp32 8-row blocks, the tile
  form above 128 rows on its own counter) and the fused wrapper's
  attention workspace, with the launches stubbed: no kernel runs here.
"""
import contextlib
import ctypes
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import deepspeed_tpu.ops.pallas.decode_attention as da_jax
from deepspeed_tpu.models.bloom import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models.model import QuantizedTensor as JaxQuantized
from deepspeed_tpu.ops.pallas.fused_decode import \
    FusedLayerSpec as JaxSpec
from deepspeed_tpu.ops.pallas.fused_decode import _weight_order
from deepspeed_tpu.ops.pallas.fused_decode import \
    ds_fused_layer as jax_fused_layer
from deepspeed_tpu.ops.pallas.qgemm import ds_qgemm as jax_qgemm
from deepspeed_tpu.ops.pallas.quantization import _ref_quantize
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels import decode_attention as da
from deepspeed_tpu_torch.ops.kernels import fused_decode as fd
from deepspeed_tpu_torch.ops.kernels import qgemm as qg

ATOL = 1e-5
ATOL_KERNEL = 2e-4
#: the walks' multiprocessors: few, so that small N still splits K
SMS = 8
#: K 328: six stages of 64 rows, the last 8 (a part-filled stage)
K_WALK = 328


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _quantized(K, N, qblock, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    q, s = (np.array(a) for a in _ref_quantize(jnp.asarray(w), qblock))
    return q, s


# ------------------------------------------------------------- the GEMM
@pytest.mark.parametrize("N", [136, 520])
@pytest.mark.parametrize("M", [1, 8, 96, 128])
def test_decode_walk_matches_pallas_interpret_and_plain(M, N):
    q, s = _quantized(K_WALK, N, 64, seed=M + N)
    x = np.random.default_rng(M).standard_normal((M, K_WALK),
                                                 dtype=np.float32) * 0.1
    ref = np.asarray(jax_qgemm(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                               interpret=True, block_m=8, block_k=128,
                               block_n=128))
    xt, qt, st = (torch.from_numpy(a) for a in (x, q, s))
    got = qg.qgemm_stream_walk(xt, qt, st, SMS)
    assert qg.stream_splits(K_WALK, N, SMS)[0] > 1
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               qg.qgemm_plain(xt, qt, st).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_walk_row_bits_whatever_m(dtype):
    q, s = (torch.from_numpy(a) for a in _quantized(K_WALK, 520, 64, 9))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (128, K_WALK), dtype=np.float32)).to(dtype)
    rows = [qg.qgemm_stream_walk(x[:m], q, s, SMS)[0] for m in (1, 8, 96,
                                                                 128)]
    for r in rows[1:]:
        assert torch.equal(r, rows[0])


def test_stream_splits_rule():
    # the served shapes on an H100's 132 multiprocessors
    assert qg.stream_splits(1536, 4608, 132) == (6, 256)    # GPT-2 QKV
    assert qg.stream_splits(6144, 1536, 132) == (16, 384)   # GPT-2 MLP-out
    assert qg.stream_splits(4096, 4096, 132) == (8, 512)    # Llama wq
    assert qg.stream_splits(11008, 4096, 132) == (8, 1408)  # Llama w_down
    assert qg.stream_splits(4096, 8, 132) == (16, 256)      # Mixtral router
    assert qg.stream_splits(4096, 43008, 132) == (1, 4096)
    rng = np.random.default_rng(0)
    for _ in range(200):
        K, N, sms = (int(v) for v in (rng.integers(1, 20000),
                                      rng.integers(1, 60000),
                                      rng.integers(1, 200)))
        ns, kper = qg.stream_splits(K, N, sms)
        assert 1 <= ns <= qg.ROWS_MAX_SPLIT and kper % qg.STREAM_BK == 0
        assert ns * kper >= K and (ns - 1) * kper < K


def test_stream_ok_and_groups_met():
    assert qg.groups_met(4608, 256) == 1 and qg.groups_met(8, 8) == 1
    assert qg.groups_met(4608, 200) == 3     # [768, 1024): groups 3-5
    assert qg.groups_met(1000, 250) == 2
    assert qg.stream_ok(1536, 4608, 18) and qg.stream_ok(4096, 4096, 16)
    assert not qg.stream_ok(1536, 4600, 18)          # N off 16
    assert not qg.stream_ok(1532, 4608, 18)          # K off 8
    assert not qg.stream_ok(1536, 4608, 18, aligned=False)
    assert not qg.stream_ok(1536, 4608, 4608)        # 256 groups a unit
    assert not qg.stream_ok(1536, 4604, 0, int8=False)   # N off 8
    assert qg.stream_ok(1536, 4616, 0, int8=False)


# ---------------------------------------------------------- the attention
def _attn_case(variant, int8_cache, W, seed=0, hd=16, S=200):
    H, KV = (8, 2) if variant == "gqa" else (4, 4)
    lens = np.asarray([0, 63, 64, 65, 127, 190][:6], np.int32)
    lens = np.minimum(lens, S - W)
    B = len(lens)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    kw = rng.standard_normal((B, W, KV, hd), dtype=np.float32)
    vw = rng.standard_normal((B, W, KV, hd), dtype=np.float32)
    slopes = (np.asarray(jax_alibi_slopes(H), np.float32)
              if variant == "alibi" else None)
    return q, k, v, kw, vw, lens, slopes


def _cache_with_window(k, v, kw, vw, lens, j, ks=None, vs=None, kws=None,
                       vws=None):
    """The cache with window positions 0..j written at lens + i."""
    k, v = k.copy(), v.copy()
    ks = None if ks is None else ks.copy()
    vs = None if vs is None else vs.copy()
    rows = np.arange(len(lens))
    for i in range(j + 1):
        k[rows, lens + i] = kw[:, i]
        v[rows, lens + i] = vw[:, i]
        if ks is not None:
            ks[rows, lens + i] = kws[:, i]
            vs[rows, lens + i] = vws[:, i]
    return k, v, ks, vs


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("variant,int8_cache", [
    ("plain", False), ("gqa", False), ("alibi", False), ("plain", True),
    ("gqa", True)])
def test_attention_split_walk_matches_pallas_and_plain(
        interpret_pallas, variant, int8_cache, W):
    q, k, v, kw, vw, lens, slopes = _attn_case(variant, int8_cache, W)
    B, _, H, hd = q.shape
    sm = hd ** -0.5
    ks = vs = kws = vws = None
    if int8_cache:
        (k, ks), (v, vs) = ((np.asarray(a) for a in da_jax.quantize_kv(
            jnp.asarray(t))) for t in (k, v))
        (kw, kws), (vw, vws) = ((np.asarray(a) for a in da_jax.quantize_kv(
            jnp.asarray(t))) for t in (kw, vw))
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    kwf = T(kw).float() * (1 if kws is None else T(kws)[..., None])
    vwf = T(vw).float() * (1 if vws is None else T(vws)[..., None])
    got = fd.attention_split_walk(T(q), T(k), T(v), T(lens), kwf, vwf, sm,
                                  T(ks), T(vs), T(slopes)).numpy()
    for j in range(W):
        kc, vc, ksc, vsc = _cache_with_window(k, v, kw, vw, lens, j, ks, vs,
                                              kws, vws)
        L = (lens + j + 1).astype(np.int32)
        jx = {} if slopes is None else {"alibi_slopes": jnp.asarray(slopes)}
        if int8_cache:
            jx.update(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
        ref = np.asarray(da_jax.decode_attention(
            jnp.asarray(q[:, j]), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(L), sm_scale=sm, **jx))
        plain = da.decode_attention_plain(
            T(q[:, j].copy()), T(kc), T(vc), T(L), sm, T(ksc), T(vsc),
            T(slopes)).numpy()
        np.testing.assert_allclose(got[:, j], ref, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[:, j], plain, atol=ATOL, rtol=0)


def test_attention_split_walk_row_bits_whatever_batch():
    q, k, v, kw, vw, lens, _ = _attn_case("gqa", False, 3, seed=4)
    T = torch.from_numpy
    full = fd.attention_split_walk(T(q), T(k), T(v), T(lens), T(kw), T(vw),
                                   0.25)
    one = fd.attention_split_walk(T(q[3:4]), T(k[3:4, :150]),
                                  T(v[3:4, :150]), T(lens[3:4]), T(kw[3:4]),
                                  T(vw[3:4]), 0.25)
    assert torch.equal(one[0], full[3])


def test_attn_workspace_sizes():
    # GPT-2 760M at B 8, W 1: one query a (row, head), 17 chunks of 64
    # over 1024 + 1 positions
    assert fd.attn_workspace(8, 1, 16, 16, 96, 1024) == (
        8 * 16 * 17 * 98, 8 * 16)
    # Llama GQA rep 4, W 3: 12 queries, three query chunks of up to 4, 4
    # chunks of 64 over 203 positions
    assert fd.attn_workspace(2, 3, 32, 8, 128, 200) == (
        2 * 8 * 3 * 4 * 4 * 130, 2 * 8 * 3)


@pytest.mark.parametrize("chunk", [64, 128])
def test_attention_split_walk_chunk_sizes_agree(chunk):
    q, k, v, kw, vw, lens, sl = _attn_case("alibi", False, 3, seed=5)
    T = torch.from_numpy
    got = fd.attention_split_walk(T(q), T(k), T(v), T(lens), T(kw), T(vw),
                                  0.25, alibi_slopes=T(sl), chunk=chunk)
    one = fd.attention_split_walk(T(q), T(k), T(v), T(lens), T(kw), T(vw),
                                  0.25, alibi_slopes=T(sl), chunk=1024)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL, rtol=0)


# ----------------------------------------------------- the fused layer walk
FUSED_SPECS = {
    "gpt2": dict(num_heads=4, num_kv_heads=4, head_dim=48, d_model=192),
    "llama_gqa": dict(num_heads=8, num_kv_heads=2, head_dim=24,
                      d_model=192, norm="rms", qkv="split", qkv_bias=False,
                      out_bias=False, mlp="swiglu", mlp_bias=False,
                      rotary_dims=24),
    "neox": dict(num_heads=2, num_kv_heads=2, head_dim=96, d_model=192,
                 qkv="headmajor", mlp="gelu_exact", residual="parallel",
                 rotary_dims=24),
    "bloom": dict(num_heads=4, num_kv_heads=4, head_dim=48, d_model=192,
                  qkv="headmajor", alibi=True),
}
M_FUSED = 128


def _fused_weights(spec, seed):
    D, Hd = spec.d_model, spec.head_dim
    Dq, Dk = spec.num_heads * Hd, spec.num_kv_heads * Hd
    shapes = {"n1_s": (D,), "n1_b": (D,), "n2_s": (D,), "n2_b": (D,),
              "wqkv": (D, Dq + 2 * Dk), "bqkv": (Dq + 2 * Dk,),
              "wq": (D, Dq), "wk": (D, Dk), "wv": (D, Dk), "bq": (Dq,),
              "bk": (Dk,), "bv": (Dk,), "wo": (Dq, D), "bo": (D,),
              "w_in": (D, M_FUSED), "b_in": (M_FUSED,),
              "w_out": (M_FUSED, D), "b_out": (D,),
              "w_gate": (D, M_FUSED), "w_up": (D, M_FUSED),
              "w_down": (M_FUSED, D)}
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(shapes[k], dtype=np.float32) * 0.1 + 1
                if k.endswith("_s") else
                rng.standard_normal(shapes[k], dtype=np.float32) * 0.08)
            for k in _weight_order(spec)}


@pytest.mark.parametrize("name,int8_weights,int8_cache,W", [
    ("gpt2", True, True, 3), ("gpt2", False, False, 1),
    ("llama_gqa", False, True, 3), ("neox", True, False, 1),
    ("bloom", False, False, 3)])
def test_fused_layer_walk_matches_pallas_interpret_and_plain(
        name, int8_weights, int8_cache, W):
    kw_spec = FUSED_SPECS[name]
    spec_j, spec_p = JaxSpec(**kw_spec), fd.FusedLayerSpec(**kw_spec)
    cw = _fused_weights(spec_p, seed=7)
    jw, pw = {}, {}
    for k, v in cw.items():
        if int8_weights and k.startswith("w"):
            q, s = (np.asarray(a) for a in _ref_quantize(jnp.asarray(v), 16))
            jw[k] = JaxQuantized(jnp.asarray(q), jnp.asarray(s), "float32")
            pw[k] = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s),
                                    torch.float32)
        else:
            jw[k], pw[k] = jnp.asarray(v), torch.from_numpy(v.copy())
    B, S = 2, 160
    KV, hd = spec_p.num_kv_heads, spec_p.head_dim
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, W, spec_p.d_model), dtype=np.float32) * 0.5
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    lens = np.asarray([62, 129], np.int32)   # windows across chunk edges
    ks = vs = None
    if int8_cache:
        (k, ks), (v, vs) = ((np.asarray(a) for a in da_jax.quantize_kv(
            jnp.asarray(t))) for t in (k, v))
    sl = (np.asarray(jax_alibi_slopes(spec_p.num_heads), np.float32)
          if spec_p.alibi else None)
    J = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    kern = jax_fused_layer(J(x), jw, J(k), J(v), J(lens), spec_j,
                           ks_l=J(ks), vs_l=J(vs), alibi_slopes=J(sl),
                           interpret=True)
    got = fd.fused_layer_walk(T(x), pw, T(k), T(v), T(lens), spec_p, SMS,
                              T(ks), T(vs), T(sl))
    plain = fd.fused_layer_plain(T(x), pw, T(k), T(v), T(lens), spec_p,
                                 T(ks), T(vs), T(sl))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern[0]),
                               atol=ATOL_KERNEL, rtol=0)
    np.testing.assert_allclose(got.numpy(), plain[0].numpy(), atol=ATOL,
                               rtol=0)


# --------------------------------------------------------------- the routes
class _Calls:
    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __call__(self, device, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def stubbed(monkeypatch):
    calls = _Calls()
    monkeypatch.setattr(qg, "_launch", calls)
    asked = []

    def scratch(device, n_floats, n_counters):
        asked.append((n_floats, n_counters))
        return (torch.zeros(max(n_floats, 1)),
                torch.zeros(max(n_counters, 1), dtype=torch.int32))
    monkeypatch.setattr(build, "scratch", scratch)
    monkeypatch.setattr(qg.qgemm, "launches", 0)
    monkeypatch.setattr(qg.qgemm, "tile_launches", 0)
    calls.asked = asked
    return calls


#: (M, dtype, K, N, nb) -> the form ds_qgemm is asked for
ROUTES = [
    (1, torch.bfloat16, 1536, 4608, 18, "stream"),
    (8, torch.bfloat16, 1536, 4608, 18, "stream"),
    (96, torch.bfloat16, 4096, 1024, 4, "stream"),
    (128, torch.bfloat16, 4096, 4096, 16, "stream"),
    (129, torch.bfloat16, 4096, 4096, 16, "tile"),
    (8, torch.float32, 1536, 4608, 18, "rows"),
    (96, torch.float32, 4096, 8, 1, "rows"),
    (200, torch.float32, 4096, 8, 1, "tile"),
    (8, torch.bfloat16, 700, 1000, 4, "rows"),      # K, N off the stream
    (8, torch.bfloat16, 64, 64, 16, "tile"),        # groups of 4 columns
]


@pytest.mark.parametrize("M,dtype,K,N,nb,route", ROUTES)
def test_qgemm_route_rule(stubbed, M, dtype, K, N, nb, route):
    assert qg.qgemm_route(M, K, N, nb, dtype) == route
    x = torch.zeros(M, K, dtype=dtype)
    q = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(K, nb)
    out = qg.qgemm_cuda(x, q, s)
    assert out.shape == (M, N) and out.dtype == dtype
    (args,) = stubbed.calls
    assert args[6:] == (M, N, K, nb, int(dtype == torch.bfloat16),
                        qg.ROUTES[route])
    assert stubbed.asked == [qg._scratch_sizes(route, M, K, N)]
    assert qg.qgemm.launches == 1
    assert qg.qgemm.tile_launches == int(route == "tile")


def test_qgemm_stream_scratch_covers_the_splits():
    for M, K, N in ((8, 1536, 4608), (96, 4096, 1024), (128, 6144, 1536)):
        ns, _ = qg.stream_splits(K, N, 132)
        floats, counters = qg._scratch_sizes("stream", M, K, N)
        assert floats >= ns * M * N
        assert counters == -(-M // 32) * -(-N // 256)


def test_qgemm_failed_launch_raises(stubbed):
    stubbed.rc = 1
    with pytest.raises(RuntimeError, match="qgemm launch failed"):
        qg.qgemm_cuda(torch.zeros(8, 64, dtype=torch.bfloat16),
                      torch.zeros(64, 64, dtype=torch.int8),
                      torch.ones(64, 1))


def test_fused_wrapper_passes_the_attention_workspace(monkeypatch):
    spec = fd.FusedLayerSpec(num_heads=4, num_kv_heads=4, head_dim=16,
                             d_model=64)
    B, W, S = 2, 3, 100
    rng = np.random.default_rng(0)
    cw = {k: torch.from_numpy(rng.standard_normal(
        _fused_shape(k, spec), dtype=np.float32)).to(torch.bfloat16)
        for k in _weight_order(spec)}
    seen = {}

    class _Fn:
        argtypes = True

        def __call__(self, args, is_bf16, w8, c8, stream):
            a = args._obj
            seen.update(attn_floats=a.attn_floats, B=a.B, W=a.W,
                        attn_ws=a.attn_ws, attn_cnt=a.attn_cnt)
            return 0
    asked = []

    def scratch(device, n_floats, n_counters):
        asked.append((n_floats, n_counters))
        return (torch.zeros(n_floats), torch.zeros(n_counters,
                                                   dtype=torch.int32))
    monkeypatch.setattr(fd, "_lib", lambda: _Fn())
    monkeypatch.setattr(build, "scratch", scratch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fd, "_barrier", lambda d: torch.zeros(2))
    x = torch.zeros(B, W, 64, dtype=torch.bfloat16)
    k = torch.zeros(B, S, 4, 16, dtype=torch.bfloat16)
    fd.fused_layer_cuda(x, cw, k, k.clone(),
                        torch.zeros(B, dtype=torch.int32), spec)
    want = fd.attn_workspace(B, W, 4, 4, 16, S)
    assert asked == [want]
    assert seen["attn_floats"] == want[0] and (seen["B"], seen["W"]) == (B, W)
    assert seen["attn_ws"] and seen["attn_cnt"]
    assert ctypes.sizeof(fd._FusedArgs) % 8 == 0


def test_fused_wrapper_refuses_bf16_off_the_stream():
    spec = fd.FusedLayerSpec(num_heads=4, num_kv_heads=4, head_dim=12,
                             d_model=48)
    cw = {k: torch.zeros(_fused_shape(k, spec), dtype=torch.bfloat16)
          for k in _weight_order(spec)}
    cw["w_in"] = torch.zeros(48, 100, dtype=torch.bfloat16)
    cw["b_in"] = torch.zeros(100, dtype=torch.bfloat16)
    cw["w_out"] = torch.zeros(100, 48, dtype=torch.bfloat16)
    x = torch.zeros(2, 1, 48, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 4, 12, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode weight stream"):
        fd.fused_layer_cuda(x, cw, k, k, torch.zeros(2, dtype=torch.int32),
                            spec)


def _fused_shape(key, spec, M=128):
    D, Hd = spec.d_model, spec.head_dim
    Dq, Dk = spec.num_heads * Hd, spec.num_kv_heads * Hd
    return {"n1_s": (D,), "n1_b": (D,), "n2_s": (D,), "n2_b": (D,),
            "wqkv": (D, Dq + 2 * Dk), "bqkv": (Dq + 2 * Dk,),
            "wo": (Dq, D), "bo": (D,), "w_in": (D, M), "b_in": (M,),
            "w_out": (M, D), "b_out": (D,)}[key]
