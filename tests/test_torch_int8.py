"""deepspeed_tpu_torch int8 serving vs the JAX package: the block
quantizer, the fused-dequant qgemm, the int8-cache decode attention and
its helpers, the int8 inference engine and the int8 continuous-batching
scheduler (fused and unfused).

The port's plain versions (what its wrappers run for CPU tensors; the
CUDA kernels are held against them on the card by chip_smoke.py) are
compared with the JAX Pallas kernels in interpret mode and with the JAX
references, on the same seeded numpy inputs.

Tolerances:
- quantization: exact against ``_ref_quantize`` (int8 codes and fp32
  scales bit for bit: both divide in fp32 and round half to even); the
  Pallas kernel in interpret mode gives the same codes and scales within
  one ulp (its CPU build multiplies by 1/127 instead of dividing);
- qgemm fp32: 1e-5 abs (outputs of magnitude ~1; only the summation
  order differs); bf16: 1e-2 of the output's max (one bf16 rounding of
  the output, products accumulated in fp32 on both sides);
- int8 decode fp32: 1e-5 abs against the Pallas kernel and against
  ``decode_attention_xla``.  For a bf16 query the two references differ:
  the XLA one rounds the dequantized cache to bf16, the Pallas kernel
  (and the port) keeps it in fp32; that gap is checked to be within bf16
  rounding (2e-2 of max);
- scheduler: greedy fp32, token identity (no tolerance).
"""
import argparse
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import deepspeed_tpu
import deepspeed_tpu.ops.pallas.decode_attention as da_jax
import deepspeed_tpu_torch
from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.ops.pallas.fused_decode import set_fused_decode_override
from deepspeed_tpu.ops.pallas.qgemm import ds_qgemm
from deepspeed_tpu.ops.pallas.quantization import (_pallas_quantize_2d,
                                                   _ref_dequantize,
                                                   _ref_quantize)
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import gpt2_model
from deepspeed_tpu_torch.models.model import (QuantizedTensor, maybe_stream,
                                              qdot)
from deepspeed_tpu_torch.ops.kernels import decode_attention as da
from deepspeed_tpu_torch.ops.kernels import qgemm as qg
from deepspeed_tpu_torch.ops.kernels import quantization as qz
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                         RequestState, SamplingParams)
from deepspeed_tpu_torch.serving.server import (build_parser,
                                                build_scheduler)
from tests.util import tiny_gpt2


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(autouse=True)
def _debug_invariant(monkeypatch):
    monkeypatch.setenv("DS_SERVE_DEBUG", "1")


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


# ------------------------------------------------------------ quantizer
@pytest.mark.parametrize("R,C,block", [(16, 512, 256), (8, 256, 128),
                                       (24, 1024, 256)])
def test_quantize_matches_pallas_interpret(interpret_pallas, R, C, block):
    rng = np.random.default_rng(R * C)
    x = rng.standard_normal((R, C), dtype=np.float32)
    x[3, :block] = 0.0                      # an all-zero group: scale 1.0
    q_ref, s_ref = _pallas_quantize_2d(jnp.asarray(x), block, row_tile=8)
    q, s = qz.block_quantize_int8(torch.from_numpy(x), block)
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    # XLA's CPU build of the interpreted kernel computes amax / 127 as
    # amax * (1 / 127): its scales may sit one ulp from the true quotient
    # that _ref_quantize, the port and its CUDA kernel compute
    ulps = np.abs(_np(s).view(np.int32)
                  - np.asarray(s_ref).view(np.int32)).max()
    assert ulps <= 1, ulps
    np.testing.assert_array_equal(
        _np(s), np.asarray(_ref_quantize(jnp.asarray(x), block)[1]))
    assert float(s[3, 0]) == 1.0


@pytest.mark.parametrize("shape,block", [
    ((2, 3, 300), 256),      # ragged: 2 groups of 150
    ((5, 1000), 256),        # ragged: 4 groups of 250
    ((4, 130), 64),          # ragged: 3 groups of 44, the last 42
    ((2, 4, 512), 256),      # whole groups, leading dims
    ((3, 100), 256),         # one group narrower than the block
])
def test_quantize_matches_jax_reference_exactly(shape, block):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, dtype=np.float32) * 3
    q_ref, s_ref = _ref_quantize(jnp.asarray(x), block)
    q, s = qz.block_quantize_int8(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    np.testing.assert_array_equal(_np(s), np.asarray(s_ref))
    np.testing.assert_array_equal(
        _np(qz.block_dequantize_int8(q, s)),
        np.asarray(_ref_dequantize(q_ref, s_ref)))


def test_quantize_bf16_values_exactly():
    """The engine quantizes the compute-dtype (bf16) values; both
    packages round fp32 -> bf16 to nearest even, then quantize alike."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 768), dtype=np.float32)
    q_ref, s_ref = _ref_quantize(jnp.asarray(x).astype(jnp.bfloat16))
    q, s = qz.block_quantize_int8(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    np.testing.assert_array_equal(_np(s), np.asarray(s_ref))


# ---------------------------------------------------------------- qgemm
@pytest.mark.parametrize("M,K,N,qblock", [
    (4, 256, 512, 128), (9, 384, 640, 128), (3, 100, 300, 128),
    (17, 512, 768, 256), (2, 64, 130, 64), (8, 128, 96, 256)])
def test_qgemm_fp32_matches_pallas_interpret(M, K, N, qblock):
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K), dtype=np.float32) * 0.1
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    q, s = _ref_quantize(jnp.asarray(w), qblock)
    ref = np.asarray(ds_qgemm(jnp.asarray(x), q, s, interpret=True,
                              block_m=8, block_k=128, block_n=128))
    got = qg.qgemm(torch.from_numpy(x), torch.from_numpy(np.asarray(q)),
                   torch.from_numpy(np.asarray(s)))
    np.testing.assert_allclose(_np(got), ref, atol=1e-5, rtol=0)


def test_qgemm_bf16_and_leading_dims_match_pallas_interpret():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 256), dtype=np.float32)
    w = rng.standard_normal((256, 384), dtype=np.float32)
    q, s = _ref_quantize(jnp.asarray(w), 128)
    ref = np.asarray(ds_qgemm(jnp.asarray(x).astype(jnp.bfloat16), q, s,
                              interpret=True, block_m=16, block_k=128,
                              block_n=128).astype(jnp.float32))
    got = qg.qgemm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(np.asarray(q)),
                   torch.from_numpy(np.asarray(s)))
    assert got.shape == (2, 3, 384) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref,
                               atol=1e-2 * np.abs(ref).max(), rtol=0)


def test_qdot_and_maybe_stream_route_like_the_reference():
    """QuantizedTensor leaves: ``maybe_stream`` dequantizes to the compute
    dtype, ``keep_quantized`` keeps the 2-D (layer-sliced) ones for qgemm;
    qdot of a kept weight equals the dequantized matmul."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((2, 64, 96), dtype=np.float32))
    qt = QuantizedTensor(*qz.block_quantize_int8(w), torch.float32)
    layer = {"w": qt[1], "b": torch.ones(96)}
    kept = maybe_stream(layer, keep_quantized=True)
    assert isinstance(kept["w"], QuantizedTensor)
    dense = maybe_stream(layer)
    assert not isinstance(dense["w"], QuantizedTensor)
    x = torch.from_numpy(rng.standard_normal((5, 64), dtype=np.float32))
    torch.testing.assert_close(qdot(x, kept["w"]), x @ dense["w"],
                               atol=0, rtol=0)


# ------------------------------------------------------ int8 decode
def _int8_cache(B, S, KV, hd, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    kq, ks = da_jax.quantize_kv(jnp.asarray(k))
    vq, vs = da_jax.quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks, vs)], (k, v)


@pytest.mark.parametrize("B,H,KV,hd,S,lens", [
    (2, 4, 4, 64, 64, [64, 33]), (3, 8, 2, 32, 40, [1, 40, 17]),
    (2, 4, 2, 24, 37, [0, 29])])
def test_int8_decode_matches_pallas_and_xla(interpret_pallas, B, H, KV, hd,
                                            S, lens):
    (kq, vq, ks, vs), _ = _int8_cache(B, S, KV, hd, seed=B * S + hd)
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    L = np.asarray(lens, np.int32)
    jargs = [jnp.asarray(a) for a in (q, kq, vq, L)]
    ref_p = np.asarray(da_jax.decode_attention_pallas(
        *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    ref_x = np.asarray(da_jax.decode_attention_xla(
        *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = _np(da.decode_attention(
        *[torch.from_numpy(a) for a in (q, kq, vq, L)],
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))
    np.testing.assert_allclose(got, ref_p, atol=1e-5, rtol=0)
    # an empty row: the kernels give zeros, the XLA reference a softmax
    # over the masked positions
    live = L > 0
    np.testing.assert_allclose(got[live], ref_x[live], atol=1e-5, rtol=0)
    assert not got[~live].any()


def test_int8_decode_bf16_query_gap_to_xla_reference(interpret_pallas):
    """bf16 query: the port follows the Pallas kernel (fp32 dequant); the
    XLA reference rounds the dequantized cache to bf16 first."""
    (kq, vq, ks, vs), _ = _int8_cache(2, 64, 4, 64, seed=11)
    q = np.random.default_rng(12).standard_normal((2, 4, 64),
                                                  dtype=np.float32)
    L = np.asarray([64, 20], np.int32)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    sc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref_p = np.asarray(da_jax.decode_attention_pallas(
        qj, jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(L),
        **sc).astype(jnp.float32))
    ref_x = np.asarray(da_jax.decode_attention_xla(
        qj, jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(L),
        **sc).astype(jnp.float32))
    got = _np(da.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(L),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))
    tol = 2e-2 * np.abs(ref_p).max()
    np.testing.assert_allclose(got, ref_p, atol=tol, rtol=0)
    np.testing.assert_allclose(got, ref_x, atol=tol, rtol=0)


def test_kv_quantize_helpers_match_jax_exactly():
    (kq, vq, ks, vs), (k, v) = _int8_cache(2, 8, 3, 16, seed=4)
    got_q, got_s = da.quantize_kv(torch.from_numpy(k))
    np.testing.assert_array_equal(_np(got_q), kq)
    np.testing.assert_array_equal(_np(got_s), ks)
    np.testing.assert_array_equal(
        _np(da.dequantize_kv(got_q, got_s)),
        np.asarray(da_jax.dequantize_kv(jnp.asarray(kq), jnp.asarray(ks))))
    # prefill: [L, B, S, KV, hd] into positions [0, S) of a longer cache
    L_, B, S, KV, hd = 2, 2, 5, 3, 16
    rng = np.random.default_rng(6)
    kk = rng.standard_normal((L_, B, S, KV, hd), dtype=np.float32)
    vv = rng.standard_normal((L_, B, S, KV, hd), dtype=np.float32)

    shape = (L_, B, 12, KV, hd)
    zeros = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
             "k_s": np.ones(shape[:-1], np.float32),
             "v_s": np.ones(shape[:-1], np.float32)}
    ref = da_jax.quantize_prefill_into_cache(
        {n: jnp.asarray(a) for n, a in zeros.items()}, jnp.asarray(kk),
        jnp.asarray(vv))
    got = da.quantize_prefill_into_cache(
        {n: torch.from_numpy(a.copy()) for n, a in zeros.items()},
        torch.from_numpy(kk), torch.from_numpy(vv))
    for name in ("k", "v", "k_s", "v_s"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(ref[name]))


# ------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def jax_tiny():
    jm = tiny_gpt2(num_layers=2, d_model=64, num_heads=2)
    params = jax.device_get(deepspeed_tpu.init_inference(
        model=jm, config={"dtype": "float32"}).params)
    return jm, params


def _port_model(jm, dtype="float32"):
    c = jm.config
    return gpt2_model("custom", vocab_size=c.vocab_size,
                      max_seq_len=c.max_seq_len, num_layers=c.num_layers,
                      num_heads=c.num_heads, d_model=c.d_model, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_engine_stores_the_jax_engines_bytes(jax_tiny, dtype):
    jm, params = jax_tiny
    jeng = JaxEngine(jm, JaxInferenceConfig(dtype=dtype,
                                            quant={"enabled": True}),
                     model_parameters=params)
    peng = InferenceEngine(_port_model(jm, dtype), DeepSpeedInferenceConfig(
        dtype=dtype, quant={"enabled": True}), model_parameters=params,
        device="cpu")
    jb, pb = jax.device_get(jeng.params["blocks"]), peng.params["blocks"]
    n_quant = 0
    for key, leaf in pb.items():
        if isinstance(leaf, QuantizedTensor):
            n_quant += 1
            # exact: the reference's quantizer on the compute-dtype values
            w = jnp.asarray(params["blocks"][key]).astype(dtype)
            q_ref, s_ref = _ref_quantize(w)
            np.testing.assert_array_equal(_np(leaf.q), np.asarray(q_ref))
            np.testing.assert_array_equal(_np(leaf.s), np.asarray(s_ref))
            # the JAX engine jit-compiles that quantizer, and XLA's CPU
            # build turns amax / 127 into amax * (1 / 127): its scales sit
            # within one ulp, and a code can round one step apart where
            # the quotient falls on a rounding boundary
            ulps = np.abs(_np(leaf.s).view(np.int32)
                          - np.asarray(jb[key].s).view(np.int32))
            assert ulps.max() <= 1
            dq = np.abs(_np(leaf.q).astype(np.int32)
                        - np.asarray(jb[key].q).astype(np.int32))
            assert dq.max() <= 1 and dq.mean() < 1e-3
            assert leaf.dtype == getattr(torch, dtype)
        else:
            assert leaf.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(
                _np(leaf), np.asarray(jb[key]).astype(np.float32))
    assert n_quant == 4                  # qkv, proj, mlp_in, mlp_out
    assert peng.params["wte"].dtype == getattr(torch, dtype)
    # a JAX int8 engine's blocks carry across with their bytes
    carried = InferenceEngine(
        _port_model(jm, dtype), DeepSpeedInferenceConfig(
            dtype=dtype, quant={"enabled": True}),
        model_parameters=jax.device_get(jeng.params), device="cpu")
    for key, leaf in carried.params["blocks"].items():
        if isinstance(leaf, QuantizedTensor):
            np.testing.assert_array_equal(_np(leaf.q), np.asarray(jb[key].q))
            np.testing.assert_array_equal(_np(leaf.s), np.asarray(jb[key].s))


def test_int8_static_generate_matches_jax(jax_tiny):
    """fp32 int8 weights + int8 cache: the port's static generate is
    token-identical to the JAX engine's."""
    jm, params = jax_tiny
    cfg = dict(dtype="float32", quant={"enabled": True},
               kv_cache_dtype="int8")
    jeng = JaxEngine(jm, JaxInferenceConfig(**cfg), model_parameters=params)
    peng = InferenceEngine(_port_model(jm), DeepSpeedInferenceConfig(**cfg),
                           model_parameters=params, device="cpu")
    prompt = np.random.default_rng(0).integers(1, 128, (2, 9)).astype(
        np.int32)
    ref = np.asarray(jeng.generate(prompt, max_new_tokens=8))
    got = peng.generate(prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------- scheduler
def _prompts(n, seed, lo=5, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, (int(L),)).astype(np.int32)
            for L in rng.integers(lo, hi, n)]


@pytest.mark.parametrize("fused", [False, True])
def test_int8_scheduler_matches_jax_and_static(jax_tiny, fused):
    """int8 weights + int8 KV pool, fp32: the port's scheduler is token-
    identical to the JAX int8 scheduler and to its own static generate,
    across a forced preemption, with fused decode off and on."""
    jm, params = jax_tiny
    cfg = dict(dtype="float32", quant={"enabled": True},
               kv_cache_dtype="int8")
    jeng = JaxEngine(jm, JaxInferenceConfig(**cfg), model_parameters=params)
    peng = InferenceEngine(_port_model(jm), DeepSpeedInferenceConfig(**cfg),
                           model_parameters=params, device="cpu")
    scfg = dict(block_size=4, num_blocks=10, max_num_seqs=2,
                max_num_batched_tokens=64, fused_decode=fused)
    prompts = _prompts(2, seed=6, lo=6, hi=7)
    try:
        js = JaxScheduler(jm, jeng.params, JaxServingConfig(**scfg),
                          kv_cache_dtype="int8")
        jr = [js.submit(p, JaxSampling(max_new_tokens=12), priority=pr)
              for p, pr in zip(prompts, (1, 0))]
        js.run_until_idle()
    finally:
        set_fused_decode_override(None)
    ps = ContinuousBatchingScheduler(peng.model, peng.params,
                                     ServingConfig(**scfg),
                                     kv_cache_dtype="int8")
    assert set(ps.pool) == {"k", "v", "k_s", "v_s"}
    assert ps.pool["k"].dtype == torch.int8
    pr_ = [ps.submit(p, SamplingParams(max_new_tokens=12), priority=pr)
           for p, pr in zip(prompts, (1, 0))]
    ps.run_until_idle()
    assert ps.metrics.counters["preemptions"] >= 1
    assert ps.metrics.counters["preemptions"] == \
        js.metrics.counters["preemptions"]
    for p, a, b in zip(prompts, jr, pr_):
        assert b.state == RequestState.FINISHED
        assert b.output_ids == a.output_ids
        static = peng.generate(p[None], max_new_tokens=12,
                               fused_decode=fused)[0, p.size:]
        assert b.output_ids == list(static)
    assert ps.block_mgr.num_allocated_blocks == 0


def test_int8_scheduler_metrics_list_the_new_kernels(jax_tiny):
    jm, params = jax_tiny
    peng = InferenceEngine(_port_model(jm), DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": True}), model_parameters=params,
        device="cpu")
    ps = ContinuousBatchingScheduler(peng.model, peng.params,
                                     ServingConfig(fused_decode=True),
                                     kv_cache_dtype="int8")
    text = ps.render_metrics()
    for k in ("decode_attention", "decode_attention_int8", "ds_flash_fwd",
              "qgemm", "ds_fused_layer", "block_quantize_int8"):
        assert f'kernel_launches{{kernel="{k}"}}' in text
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ContinuousBatchingScheduler(peng.model, peng.params, ServingConfig(),
                                    kv_cache_dtype="bfloat16")


# ----------------------------------------------------------------- CLI
def test_cli_flags_parse_and_build_an_int8_fused_scheduler(jax_tiny):
    args = build_parser().parse_args(
        ["--model", "gpt2:760m", "--int8-weights", "--kv-cache-dtype",
         "int8", "--fused-decode", "on", "--dtype", "float32", "--device",
         "cpu"])
    assert isinstance(args, argparse.Namespace)
    assert args.int8_weights and args.kv_cache_dtype == "int8"
    assert args.fused_decode == "on"
    off = build_parser().parse_args(["--fused-decode", "off"])
    assert off.fused_decode == "off" and not off.int8_weights
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--kv-cache-dtype", "fp8"])
    sched = build_scheduler(args, model=_port_model(jax_tiny[0]))
    assert sched.fused_decode and sched.cfg.fused_decode is True
    assert sched.kv_cache_dtype == "int8"
    assert isinstance(sched.params["blocks"]["mlp_in_w"], QuantizedTensor)
    req = sched.submit(np.arange(1, 6, dtype=np.int32),
                       SamplingParams(max_new_tokens=4))
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED and req.num_generated == 4


def test_init_inference_passes_quant_and_kv_cache_dtype():
    pm = gpt2_model("custom", vocab_size=32, max_seq_len=16, num_layers=1,
                    num_heads=2, d_model=32, dtype="float32")
    eng = deepspeed_tpu_torch.init_inference(
        pm, {"dtype": "float32"}, device="cpu", quant={"enabled": True},
        kv_cache_dtype="int8")
    assert eng.cache_dtype == "int8"
    assert isinstance(eng.params["blocks"]["proj_w"], QuantizedTensor)
    assert not isinstance(eng.params["blocks"]["proj_b"], QuantizedTensor)
