"""deepspeed_tpu_torch decode attention: the split-sequence kernel's edges
and its wrapper.

- The plain version (what the wrapper runs for CPU tensors and what
  chip_smoke.py holds the CUDA kernel against) against the JAX Pallas
  ``_decode_kernel`` in interpret mode at the lengths and floors where the
  kernel's chunks of C positions begin and end (C 64, 128 and 256, the
  chunks its instances take): cache_len 0, 1, C - 1, C, C + 1, S_max, and
  floors C - 1, C, C + 1 and at the length, the positions below a floor
  poisoned; the float and int8 caches, MHA, GQA, ALiBi and the window.
  fp32, 1e-5 abs (both sides accumulate in fp32; only the summation
  order differs); a row with nothing to attend exact zeros.
- The CUDA wrapper with its launch stubbed, so that no kernel runs: the
  entry point and its integer arguments, the workspace and counters it
  asks of ``build.scratch`` (sized from B, KV, S_max, rep and
  head_dim), every refusal before anything is loaded, a failed launch
  raising, and each variant counting one launch on its own counter.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import deepspeed_tpu.ops.pallas.decode_attention as da_jax
from deepspeed_tpu.models.bloom import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels import decode_attention as da

ATOL = 1e-5
POISON = 1e3
#: (H, KV) by variant: GQA takes rep 4
HEADS = {"plain": (4, 4), "gqa": (8, 2), "alibi": (4, 4), "windowed": (4, 4)}


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _edge_case(C, variant, int8_cache, hd=64, seed=0):
    """Seeded inputs at chunk C's edges: rows of cache_len 0, 1, C - 1, C,
    C + 1, S_max (2 C + 16), 2 C + 1 and C + 2; the window's floors 0, 0,
    C - 1, C - 1, C, C + 1, C + 1, C + 2 (rows 2 and 7 at their length),
    the positions below each floor poisoned."""
    H, KV = HEADS[variant]
    S = 2 * C + 16
    lens = np.asarray([0, 1, C - 1, C, C + 1, S, 2 * C + 1, C + 2], np.int32)
    B = len(lens)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    extra = {}
    floors = np.zeros(B, np.int32)
    if variant == "alibi":
        extra["alibi_slopes"] = np.asarray(jax_alibi_slopes(H), np.float32)
    if variant == "windowed":
        floors = np.asarray([0, 0, C - 1, C - 1, C, C + 1, C + 1, C + 2],
                            np.int32)
        for b, f in enumerate(floors):
            k[b, :f] = POISON
            v[b, :f] = -POISON
        extra["min_pos"] = floors
    if int8_cache:
        kq, ks = (np.asarray(a) for a in da_jax.quantize_kv(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in da_jax.quantize_kv(jnp.asarray(v)))
        k, v = kq, vq
        extra.update(k_scale=ks, v_scale=vs)
    return q, k, v, lens, extra, np.flatnonzero(floors >= lens)


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("int8_cache", [False, True])
@pytest.mark.parametrize("variant", ["plain", "gqa", "alibi", "windowed"])
def test_plain_matches_pallas_at_chunk_edges(interpret_pallas, variant,
                                             int8_cache, C):
    q, k, v, L, extra, empty = _edge_case(C, variant, int8_cache,
                                          seed=C + len(variant))
    assert set(empty) == ({0} if variant != "windowed" else {0, 2, 7})
    ref = np.asarray(da_jax.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L),
        **{n: jnp.asarray(a) for n, a in extra.items()}))
    out = da.decode_attention(
        *map(torch.from_numpy, (q, k, v, L)),
        **{n: torch.from_numpy(a) for n, a in extra.items()}).numpy()
    assert np.isfinite(out).all()
    for b in empty:
        np.testing.assert_array_equal(out[b], np.zeros_like(out[b]))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# ------------------------------------------------ the wrapper, stubbed
class _Launches:
    """Stands in for the wrapper's launch: records (quantized, pointers,
    integer and float arguments) and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, quantized, device, *args):
        n_ptr = 11 if quantized else 9
        assert len(args) == n_ptr + 7
        self.calls.append((quantized, args[:n_ptr], args[n_ptr:]))
        return self.rc


@pytest.fixture
def launches(monkeypatch):
    stub = _Launches()
    sizes = []
    ws = (torch.zeros(4), torch.zeros(4, dtype=torch.int32))

    def scratch(device, n_floats, n_counters):
        sizes.append((n_floats, n_counters))
        return ws
    monkeypatch.setattr(da, "_call", stub)
    monkeypatch.setattr(build, "scratch", scratch)
    for a in ("launches", "int8_launches", "alibi_launches",
              "windowed_launches"):
        monkeypatch.setattr(da.decode_attention, a, 0)
    stub.sizes = sizes
    stub.ws_ptrs = (ws[0].data_ptr(), ws[1].data_ptr())
    return stub


def _counts():
    f = da.decode_attention
    return {"launches": f.launches, "int8_launches": f.int8_launches,
            "alibi_launches": f.alibi_launches,
            "windowed_launches": f.windowed_launches}


def _operands(dtype, int8_cache, B=3, H=8, KV=2, hd=96, S=200,
              variant="plain"):
    q = torch.zeros(B, H, hd, dtype=dtype)
    cache_dtype = torch.int8 if int8_cache else dtype
    k = torch.zeros(B, S, KV, hd, dtype=cache_dtype)
    v = torch.zeros(B, S, KV, hd, dtype=cache_dtype)
    kw = {}
    if int8_cache:
        kw.update(k_scale=torch.ones(B, S, KV), v_scale=torch.ones(B, S, KV))
    if variant in ("alibi", "alibi_windowed"):
        kw["alibi_slopes"] = torch.ones(H)
    if variant in ("windowed", "alibi_windowed"):
        kw["min_pos"] = torch.zeros(B, dtype=torch.int32)
    return q, k, v, torch.full((B,), 7, dtype=torch.int32), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8_cache", [False, True])
@pytest.mark.parametrize("variant",
                         ["plain", "alibi", "windowed", "alibi_windowed"])
def test_one_launch_its_arguments_and_its_counter(launches, variant,
                                                   int8_cache, dtype):
    B, H, KV, hd, S = 3, 8, 2, 96, 200
    q, k, v, L, kw = _operands(dtype, int8_cache, B, H, KV, hd, S, variant)
    out = da.decode_attention_cuda(q, k, v, L, sm_scale=0.5, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert len(launches.calls) == 1
    quantized, ptrs, rest = launches.calls[0]
    assert quantized == int8_cache
    assert rest == (B, H, KV, S, hd, int(dtype == torch.bfloat16), 0.5)
    # q, k, v[, scales], cache_len, slopes, floor, out, workspace, counters
    assert ptrs[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    extra = (kw["alibi_slopes"].data_ptr() if "alibi_slopes" in kw else 0,
             kw["min_pos"].data_ptr() if "min_pos" in kw else 0)
    assert ptrs[-6:] == (L.data_ptr(), *extra, out.data_ptr(),
                         *launches.ws_ptrs)
    if int8_cache:
        assert ptrs[3:5] == (kw["k_scale"].data_ptr(),
                             kw["v_scale"].data_ptr())
    # one (m, l, acc[hd]) partial per (row, kv head, 64-position chunk)
    # and query head of the group, one counter per (row, kv head)
    assert launches.sizes == [(B * KV * -(-S // 64) * (H // KV) * (hd + 2),
                               B * KV)]
    want = {"launches": 0, "int8_launches": 0, "alibi_launches": 0,
            "windowed_launches": 0}
    if "alibi" in variant:
        want["alibi_launches"] = 1
    if "windowed" in variant:
        want["windowed_launches"] = 1
    if variant == "plain":
        want["int8_launches" if int8_cache else "launches"] = 1
    assert _counts() == want


def test_default_scale_and_workspace_at_other_shapes(launches):
    q, k, v, L, _ = _operands(torch.bfloat16, False, B=5, H=32, KV=4,
                              hd=128, S=1000)
    da.decode_attention_cuda(q, k, v, L)
    assert launches.calls[0][2][-1] == pytest.approx(128 ** -0.5)
    assert launches.sizes == [(5 * 4 * 16 * 8 * 130, 5 * 4)]
    assert da.workspace_sizes(5, 32, 4, 1000, 128) == launches.sizes[0]


def _unaligned(t):
    """A contiguous copy of ``t`` whose base is 2 bytes past a 16-byte
    boundary (the allocator's bases are aligned)."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    off = ((16 - flat.data_ptr() % 16) % 16 + 2) // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def _refused(case):
    """(arguments, keyword arguments, message) of one input the wrapper
    must refuse."""
    q, k, v, L, kw = _operands(torch.bfloat16, False)
    if case == "head_dim":
        q, k, v = q[..., :40].contiguous(), k[..., :40].contiguous(), \
            v[..., :40].contiguous()
        return (q, k, v, L), {}, "head_dim"
    if case == "rep":
        return (torch.zeros(3, 18, 96, dtype=torch.bfloat16), k, v, L), {}, \
            "query heads"
    if case == "cache_dtype":
        return (q, k.float(), v.float(), L), {}, "dtypes"
    if case == "cache_shape":
        return (q, k, v[:, :100], L), {}, "cache shapes"
    if case == "cache_len":
        return (q, k, v, L.long()), {}, "cache_len"
    if case == "scales":
        q8, k8, v8, L8, kw8 = _operands(torch.bfloat16, True)
        kw8["v_scale"] = kw8["v_scale"][:, :10]
        return (q8, k8, v8, L8), kw8, "int8 scales"
    if case == "slopes":
        return (q, k, v, L), {"alibi_slopes": torch.ones(3)}, "alibi_slopes"
    if case == "min_pos":
        return (q, k, v, L), {"min_pos": torch.zeros(3, dtype=torch.int64)}, \
            "min_pos"
    if case == "contiguous":
        kt = k.transpose(1, 2).contiguous().transpose(1, 2)
        return (q, kt, kt, L), {}, "contiguous"
    if case == "unaligned":
        return (q, _unaligned(k), v, L), {}, "16-byte aligned"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "head_dim", "rep", "cache_dtype", "cache_shape", "cache_len", "scales",
    "slopes", "min_pos", "contiguous", "unaligned"])
def test_refusals_come_before_any_load(monkeypatch, case):
    def never(*_a, **_k):
        raise AssertionError("loaded or launched before refusing")
    monkeypatch.setattr(da, "_call", never)
    monkeypatch.setattr(build, "load", never)
    monkeypatch.setattr(build, "scratch", never)
    args, kw, msg = _refused(case)
    with pytest.raises(ValueError, match=msg):
        da.decode_attention_cuda(*args, **kw)


@pytest.mark.parametrize("int8_cache", [False, True])
def test_a_failed_launch_raises_and_counts_nothing(launches, int8_cache):
    launches.rc = 1
    q, k, v, L, kw = _operands(torch.bfloat16, int8_cache)
    with pytest.raises(RuntimeError, match="decode_attention launch failed"):
        da.decode_attention_cuda(q, k, v, L, **kw)
    assert len(launches.calls) == 1
    assert not any(_counts().values())
