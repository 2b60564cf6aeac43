"""deepspeed_tpu_torch Llama against the JAX package on ``llama:tiny`` (GQA
rep 2; fp32, the JAX weights carried across as numpy): the full forward
(logits 1e-5, with and without the InternLM biases), the params' round
trip, the parameter counts of every preset, prefill and decode against
the JAX serving functions (logits 1e-5), the scheduler token-identical to
the JAX scheduler and to the port's static generate across a preemption,
fused decode off and on, bf16 / int8 weights x float / int8 cache, and
fused decode bitwise equal to unfused on the CPU with each path's kernel
calls counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import sharding_pin_scope
from deepspeed_tpu.models import llama as jll
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.checkpoint.jax_params import (
    llama_params_from_numpy, llama_params_to_numpy)
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import llama as pll
from deepspeed_tpu_torch.models import serving as pserving
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import fused_decode as fd
from deepspeed_tpu_torch.ops.kernels import qgemm as qg
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                         RequestState, SamplingParams)
from deepspeed_tpu_torch.serving.server import (build_parser,
                                                build_scheduler,
                                                model_from_spec)

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t)


def _engines(kv=None, **overrides):
    jm = jll.llama_model("tiny", attention_impl="xla", dtype="float32",
                         **overrides)
    cfg = {"dtype": "float32", "kv_cache_dtype": kv}
    jeng = deepspeed_tpu.init_inference(model=jm, config=cfg)
    pm = pll.llama_model("tiny", dtype="float32", **overrides)
    peng = InferenceEngine(pm, DeepSpeedInferenceConfig(**cfg),
                           model_parameters=jax.device_get(jeng.params),
                           device="cpu")
    return jm, jeng, pm, peng


@pytest.fixture(scope="module")
def served():
    return _engines()


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("attn_bias", [False, True])
def test_full_forward_matches_jax(attn_bias):
    cfg = jll.LlamaConfig(**jll.LLAMA_SIZES["tiny"], dtype="float32",
                          attention_impl="xla", attn_bias=attn_bias)
    tree = jll.numpy_init_params(cfg, 1)
    if attn_bias:     # zeros at init: give the biases values to carry
        rng = np.random.default_rng(2)
        for k in ("wq_b", "wk_b", "wv_b", "wo_b"):
            tree["blocks"][k] = rng.standard_normal(
                tree["blocks"][k].shape, dtype=np.float32) * 0.1
    ids = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    ref = jll.forward(jax.tree.map(jnp.asarray, tree),
                      {"input_ids": jnp.asarray(ids)}, cfg)
    pm = pll.llama_model("tiny", dtype="float32", attn_bias=attn_bias)
    got = pm.apply(llama_params_from_numpy(tree, "cpu", torch.float32),
                   {"input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=0)


def test_numpy_init_is_the_references():
    for bias in (False, True):
        kw = dict(jll.LLAMA_SIZES["tiny"], attn_bias=bias)
        ref = jll.numpy_init_params(jll.LlamaConfig(**kw), 5)
        got = pll.numpy_init_params(pll.LlamaConfig(**kw), 5)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_params_carry_across_and_back(served):
    _, jeng, _, _ = served
    tree = jax.device_get(jeng.params)
    got = llama_params_to_numpy(llama_params_from_numpy(tree, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == 12
    for path, leaf in flat:
        mine = got
        for k in path:
            mine = mine[k.key]
        np.testing.assert_array_equal(mine, np.asarray(leaf))
    with pytest.raises(ValueError, match="blocks keys"):
        bad = dict(tree, blocks=dict(tree["blocks"], extra=0))
        llama_params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("size", sorted(pll.LLAMA_SIZES))
def test_count_params_match_the_reference(size):
    want = jll.count_params(jll.LlamaConfig(**jll.LLAMA_SIZES[size]))
    assert pll.count_params(pll.LlamaConfig(**pll.LLAMA_SIZES[size])) == want
    m = model_from_spec(f"llama:{size}")
    assert m.meta["n_params"] == want


def test_device_init_is_seeded_and_quantizes_as_drawn():
    cfg = pll.LlamaConfig(**pll.LLAMA_SIZES["tiny"], attn_bias=True)
    a = pll.init_params(cfg, 3, "cpu", torch.bfloat16)
    b = pll.init_params(cfg, 3, "cpu", torch.bfloat16)
    q = pll.init_quantized_params(cfg, 3, "cpu", torch.bfloat16)
    ref = jll.numpy_init_params(jll.LlamaConfig(**jll.LLAMA_SIZES["tiny"],
                                                attn_bias=True), 0)
    from deepspeed_tpu_torch.ops.kernels.quantization import \
        block_quantize_int8
    for k, v in a["blocks"].items():
        assert tuple(v.shape) == ref["blocks"][k].shape, k
        assert torch.equal(v, b["blocks"][k])
        if k in PROJECTIONS:
            assert isinstance(q["blocks"][k], QuantizedTensor)
            for l in range(cfg.num_layers):
                codes, scales = block_quantize_int8(v[l])
                assert torch.equal(q["blocks"][k].q[l], codes), k
                assert torch.equal(q["blocks"][k].s[l], scales), k
        elif k.endswith("_b"):
            assert torch.all(v == 0)
        else:
            assert torch.all(v == 1)
    assert torch.equal(q["wte"], a["wte"])


def test_refusals_name_their_queue():
    with pytest.raises(NotImplementedError, match="remat policies"):
        pll.LlamaConfig(remat=True, remat_policy="save_attn")
    pm = pll.llama_model("tiny", dtype="float32")
    with pytest.raises(NotImplementedError, match="serving extensions"):
        pm.prefill_fn({}, {"input_ids": torch.zeros(1, 4)}, {}, lora={})


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_and_decode_match_jax(kv):
    jm, jeng, pm, peng = _engines(kv)
    B, S, size = 3, 24, 64
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 256, (B, S)).astype(np.int32)
    lens = np.array([24, 9, 17], np.int32)
    cdt = "int8" if kv else None
    with sharding_pin_scope(False):
        jl, jc = jm.prefill_fn(jeng.params, {"input_ids": jnp.asarray(ids)},
                               jm.init_cache_fn(B, size, cdt))
    pc = pm.init_cache_fn(B, size, "int8" if kv else torch.float32, "cpu")
    pl, pc = pm.prefill_fn(peng.params, {"input_ids": torch.from_numpy(ids)},
                           pc)
    np.testing.assert_allclose(_np(pl), _np(jl), atol=1e-5, rtol=0)
    tok = ids[np.arange(B), lens - 1]
    for step in range(3):
        L = lens + step
        with sharding_pin_scope(False):
            jl, jc = jm.decode_fn(jeng.params, jnp.asarray(tok), jc,
                                  jnp.asarray(L))
        for fused in (False, True):
            c = {k: v.clone() for k, v in pc.items()}
            out, c = pm.decode_fn(peng.params, torch.from_numpy(tok), c,
                                  torch.from_numpy(L), fused=fused)
            np.testing.assert_allclose(_np(out), _np(jl), atol=1e-5, rtol=0)
        pl, pc = out, c
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


class _Count:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


def _params(model, dtype, int8_weights):
    return InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype=dtype, quant={"enabled": int8_weights}), device="cpu").params


@pytest.mark.parametrize("int8_weights,int8_cache",
                         [(w8, c8) for w8 in (False, True)
                          for c8 in (False, True)])
def test_fused_decode_step_matches_unfused(monkeypatch, int8_weights,
                                           int8_cache):
    """Teacher-forced decode, bf16: the fused step's logits and cache
    equal the unfused step's bitwise (the plain fused layer is the
    unfused composition), and each path calls what it should: fused = L
    fused layers and no decode attention or qgemm; unfused = 7 L qgemm
    (int8 weights) and L decode attentions per step; prefill L flash
    forwards and no qgemm."""
    model = pll.llama_model("tiny", dtype="bfloat16")
    params = _params(model, "bfloat16", int8_weights)
    L_ = model.config.num_layers
    cdt = "int8" if int8_cache else None
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(1, 256, (2, 12)).astype(np.int32))
    counts = {"fused": _Count(fd.ds_fused_layer),
              "decode": _Count(pserving.decode_attention),
              "qgemm": _Count(qg.qgemm),
              "flash": _Count(fa.flash_attention_fwd)}
    monkeypatch.setattr(fd, "ds_fused_layer", counts["fused"])
    monkeypatch.setattr(pserving, "decode_attention", counts["decode"])
    monkeypatch.setattr(qg, "qgemm", counts["qgemm"])
    monkeypatch.setattr(fa, "flash_attention_fwd", counts["flash"])
    runs = {}
    for fused in (False, True):
        cache = model.init_cache_fn(2, 64, cdt, "cpu")
        _, cache = model.prefill_fn(params, {"input_ids": toks[:, :6]},
                                    cache)
        assert counts["qgemm"].n == 0 and counts["flash"].n == L_
        before = {k: c.n for k, c in counts.items()}
        logits = []
        for pos in range(6, 12):
            lg, cache = model.decode_fn(
                params, toks[:, pos], cache,
                torch.full((2,), pos, dtype=torch.int32), fused=fused)
            logits.append(lg)
        steps = 6
        got = {k: c.n - before[k] for k, c in counts.items()}
        if fused:
            assert got == {"fused": L_ * steps, "decode": 0, "qgemm": 0,
                           "flash": 0}
        else:
            assert got == {"fused": 0, "decode": L_ * steps, "flash": 0,
                           "qgemm": 7 * L_ * steps if int8_weights else 0}
        for c in counts.values():
            c.n = 0
        runs[fused] = (torch.stack(logits), cache)
    (lu, cu), (lf, cf) = runs[False], runs[True]
    assert torch.equal(lf, lu)
    for name in cu:
        assert torch.equal(cf[name], cu[name]), name


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 256, (n,)).astype(np.int32)
            for n in (9, 70, 17, 5)]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_scheduler_matches_jax_scheduler_across_preemption(kv):
    """Greedy, fp32: the port's scheduler, fused decode off and on, gives
    the JAX scheduler's tokens, with a pool small enough that a request is
    preempted and resumed."""
    jm, jeng, pm, peng = _engines(kv)
    scfg = dict(block_size=8, num_blocks=14, max_num_seqs=3,
                max_num_batched_tokens=256)
    prompts, max_new = _prompts(), (8, 6, 10, 7)
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**scfg),
                      kv_cache_dtype=kv)
    jr = [js.submit(p, JaxSampling(max_new_tokens=n), priority=i % 2)
          for i, (p, n) in enumerate(zip(prompts, max_new))]
    js.run_until_idle()
    for fused in (False, True):
        ps = ContinuousBatchingScheduler(
            pm, peng.params, ServingConfig(**scfg, fused_decode=fused),
            kv_cache_dtype=kv)
        pr = [ps.submit(p, SamplingParams(max_new_tokens=n), priority=i % 2)
              for i, (p, n) in enumerate(zip(prompts, max_new))]
        ps.run_until_idle()
        assert ps.fused_decode is fused
        assert ps.metrics.counters["preemptions"] >= 1
        for a, b in zip(jr, pr):
            assert b.state == RequestState.FINISHED
            assert b.output_ids == a.output_ids
        assert ps.block_mgr.num_allocated_blocks == 0


ARMS = [(dt, w8, kv, fused) for dt, w8 in (("bfloat16", False),
                                           ("float32", True))
        for kv in (None, "int8") for fused in (False, True)]


@pytest.mark.parametrize("dtype,int8_weights,kv,fused", ARMS)
def test_scheduler_matches_static_generate(dtype, int8_weights, kv, fused):
    """The scheduler (a pool that forces a preemption) token-identical to
    the port's static generate with the same fused setting: bf16 weights
    and fp32 int8 weights, each with a float and an int8 cache."""
    model = pll.llama_model("tiny", dtype=dtype)
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype=dtype, kv_cache_dtype=kv, quant={"enabled": int8_weights}),
        device="cpu")
    if int8_weights:
        assert all(isinstance(eng.params["blocks"][k], QuantizedTensor)
                   for k in PROJECTIONS)
    sched = ContinuousBatchingScheduler(
        model, eng.params, ServingConfig(block_size=8, num_blocks=14,
                                         max_num_seqs=3, fused_decode=fused),
        kv_cache_dtype=kv)
    prompts, max_new = _prompts(), (8, 6, 10, 7)
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=n), priority=i % 2)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    sched.run_until_idle()
    assert sched.metrics.counters["preemptions"] >= 1
    for p, n, r in zip(prompts, max_new, reqs):
        ref = eng.generate(p, max_new_tokens=n, fused_decode=fused)
        assert r.output_ids == list(ref[0, p.size:])


def test_generate_prefills_at_the_schedulers_bucket(served, monkeypatch):
    """The static generate and the scheduler run prefill at the same
    padded lengths (the scheduler's 16-token bucket), so their prefill
    GEMMs see the same shapes."""
    _, _, pm, peng = served
    shapes = []
    real = pm.prefill_fn

    def spy(p, b, c):
        shapes.append(tuple(b["input_ids"].shape))
        return real(p, b, c)
    monkeypatch.setattr(pm, "prefill_fn", spy)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (5, 16, 17, 40)]
    for p in prompts:
        peng.generate(p, max_new_tokens=2)
    gen, shapes[:] = list(shapes), []
    sched = ContinuousBatchingScheduler(pm, peng.params, ServingConfig())
    for p in prompts:
        sched.submit(p, SamplingParams(max_new_tokens=2))
    sched.run_until_idle()
    assert gen == shapes == [(1, 16), (1, 16), (1, 32), (1, 48)]
    assert ContinuousBatchingScheduler.PROMPT_BUCKET == 16


def test_server_cli_builds_a_fused_llama_scheduler():
    """``--model llama:tiny --int8-weights --kv-cache-dtype int8
    --fused-decode on``: the quantizing device init, an int8 pool, the
    fused path, a request served and the kernels on /metrics."""
    argv = ["--model", "llama:tiny", "--int8-weights", "--dtype",
            "float32", "--device", "cpu", "--kv-cache-dtype", "int8",
            "--fused-decode", "on"]
    sched = build_scheduler(build_parser().parse_args(argv))
    assert sched.fused_decode
    assert all(isinstance(sched.params["blocks"][k], QuantizedTensor)
               for k in PROJECTIONS)
    assert sched.pool["k"].dtype == torch.int8
    assert sched.pool["k"].shape[-2] == 2           # the compact GQA pool
    req = sched.submit(np.arange(1, 9, dtype=np.int32),
                       SamplingParams(max_new_tokens=4))
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED and req.num_generated == 4
    assert 'kernel_launches{kernel="ds_fused_layer"}' in \
        sched.render_metrics()
