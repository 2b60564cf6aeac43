"""deepspeed_tpu_torch serving: block manager, ServingConfig round-trip
against the JAX package, and the continuous-batching scheduler held
token-for-token against the port's static generate and against the JAX
``ContinuousBatchingScheduler`` on the same weights (fp32, greedy:
token identity, no tolerance).
"""
import time

import numpy as np
import jax
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.inference.sampling import (apply_top_k,
                                                    apply_top_p,
                                                    process_sampling_logits)
from deepspeed_tpu_torch.models.gpt2 import gpt2_model
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (BlockManager,
                                         ContinuousBatchingScheduler,
                                         QueueFullError, RequestState,
                                         RequestTooLongError, SamplingParams)
from tests.util import tiny_gpt2


@pytest.fixture(autouse=True)
def _debug_invariant(monkeypatch):
    """Every scheduler built here checks the block-accounting invariant
    after every step."""
    monkeypatch.setenv("DS_SERVE_DEBUG", "1")


@pytest.fixture(scope="module")
def served():
    """JAX model + engine and the port's model + engine on the JAX
    engine's weights (carried across as numpy)."""
    jm = tiny_gpt2()
    jeng = deepspeed_tpu.init_inference(model=jm, config={"dtype":
                                                          "float32"})
    cfg = jm.config
    pm = gpt2_model("custom", vocab_size=cfg.vocab_size,
                    max_seq_len=cfg.max_seq_len, num_layers=cfg.num_layers,
                    num_heads=cfg.num_heads, d_model=cfg.d_model,
                    dtype="float32")
    peng = deepspeed_tpu_torch.inference.engine.InferenceEngine(
        pm, deepspeed_tpu_torch.inference.config.DeepSpeedInferenceConfig(
            dtype="float32"),
        model_parameters=jax.device_get(jeng.params), device="cpu")
    return jm, jeng, pm, peng


def _mixed_prompts(n=3, seed=0, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, (int(L),)).astype(np.int32)
            for L in rng.integers(lo, hi, n)]


def _static(peng, prompt, max_new):
    return list(peng.generate(prompt[None], max_new_tokens=max_new)
                [0, prompt.size:])


# --------------------------------------------------------------- block mgr
def test_block_manager_allocate_free_exhaust():
    bm = BlockManager(num_blocks=5, block_size=4)
    assert bm.num_usable_blocks == 4          # block 0 reserved (trash)
    got = bm.allocate(1, 3)
    assert got is not None and len(got) == 3
    assert BlockManager.TRASH_BLOCK not in got
    assert bm.num_free_blocks == 1
    assert bm.allocate(2, 2) is None          # no partial allocation
    assert bm.num_free_blocks == 1
    bm.free(1)
    assert bm.num_free_blocks == 4
    assert bm.block_table(1) == []
    bm.allocate(3, 2)
    t = bm.block_table(3)
    assert bm.position_index(3, 0) == t[0] * 4
    assert bm.position_index(3, 5) == t[1] * 4 + 1
    assert bm.check_invariant()
    bm.free(3)
    bm.free(3)                                # idempotent, no double free
    assert bm.check_invariant() and bm.num_free_blocks == 4


def test_block_manager_validation_and_invariant():
    with pytest.raises(ValueError, match="num_blocks"):
        BlockManager(num_blocks=1, block_size=4)
    with pytest.raises(ValueError, match="block_size"):
        BlockManager(num_blocks=4, block_size=0)
    bm = BlockManager(num_blocks=6, block_size=2)
    bm.allocate(1, 2)
    bm._free.append(bm.block_table(1)[0])     # corrupt: live AND free
    with pytest.raises(AssertionError, match="both live and free"):
        bm.check_invariant()


# ---------------------------------------------------------- config parity
VALID = [
    {},
    {"block_size": 8, "num_blocks": 64, "max_num_seqs": 4},
    {"max_fused_steps": 1, "max_queued": 3, "request_timeout_s": 2.5},
    {"slo": {"classes": {"gold": {"priority": 2, "ttft_ms": 50}}}},
    {"moe_dispatch": "einsum", "fused_decode": False},
    {"fused_decode": True},
]
INVALID = [
    {"block_size": 0},
    {"num_blocks": 1},
    {"max_num_seqs": 0},
    {"max_fused_steps": 3},
    {"max_blocks_per_seq": -1},
    {"moe_dispatch": "bogus"},
    {"spec": {"mode": "bogus"}},
    {"kv_tiering": {"enabled": True}},
    {"slo": {"window": 0}},
    {"fleet": {"num_replicas": 0}},
]
UNPORTED = [
    {"spec": {"mode": "ngram"}},
    {"prefix_cache": {"enabled": True}},
    {"chunked_prefill": {"enabled": True}},
    {"adapters": {"enabled": True}},
    {"fleet": {"num_replicas": 2}},
    {"prefix_cache": {"enabled": True}, "kv_tiering": {"enabled": True}},
    {"chunked_prefill": {"enabled": True, "chunk_tokens": 64}},
    {"slo": {"enabled": True}},
]


def _resolved(cfg):
    out = {}
    for name in JaxServingConfig.model_fields:
        v = getattr(cfg, name)
        out[name] = v.model_dump() if hasattr(v, "model_dump") else v
    out["slo"]["classes"] = {k: c.model_dump()
                             for k, c in cfg.slo.classes.items()}
    return out


@pytest.mark.parametrize("raw", VALID)
def test_serving_config_round_trip(raw):
    assert _resolved(ServingConfig(**raw)) == \
        _resolved(JaxServingConfig(**raw))


@pytest.mark.parametrize("raw", INVALID)
def test_serving_config_same_errors(raw):
    with pytest.raises(ValueError) as ref:
        JaxServingConfig(**raw)
    with pytest.raises(ValueError) as got:
        ServingConfig(**raw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("raw", UNPORTED)
def test_unported_features_refused(raw):
    JaxServingConfig(**raw)                   # valid in the reference
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingConfig(**raw)


def test_unported_inference_settings_refused():
    """Tensor parallelism and a float cache in another dtype stay
    refused; int8 weights and the int8 KV cache are served now."""
    from deepspeed_tpu_torch.models.model import QuantizedTensor
    pm = gpt2_model("custom", vocab_size=32, max_seq_len=16, num_layers=1,
                    num_heads=2, d_model=16, dtype="float32")
    for cfg in ({"tensor_parallel": {"tp_size": 2}},
                {"kv_cache_dtype": "bfloat16"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            deepspeed_tpu_torch.init_inference(
                pm, {"dtype": "float32", **cfg}, device="cpu")
    eng = deepspeed_tpu_torch.init_inference(
        pm, {"dtype": "float32", "quant": {"enabled": True},
             "kv_cache_dtype": "int8"}, device="cpu")
    assert isinstance(eng.params["blocks"]["qkv_w"], QuantizedTensor)
    assert eng.cache_dtype == "int8"
    out = eng.generate(np.array([[1, 2, 3]], np.int32), max_new_tokens=3)
    assert out.shape == (1, 6)


# ----------------------------------------------------------------- parity
def test_scheduler_matches_static_generate(served):
    _, _, pm, peng = served
    cfg = ServingConfig(block_size=8, num_blocks=32, max_num_seqs=4,
                        max_num_batched_tokens=256)
    sched = ContinuousBatchingScheduler(pm, peng.params, cfg)
    prompts = _mixed_prompts(5, seed=1)
    max_new = [6, 3, 8, 5, 4]
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=mn))
            for p, mn in zip(prompts, max_new)]
    sched.run_until_idle()
    for p, mn, r in zip(prompts, max_new, reqs):
        assert r.state == RequestState.FINISHED
        assert r.output_ids == _static(peng, p, mn)
    assert sched.block_mgr.num_allocated_blocks == 0


def test_static_generate_matches_recompute_oracle(served):
    _, _, _, peng = served
    for p in _mixed_prompts(2, seed=9):
        cached = peng.generate(p[None], max_new_tokens=6)
        oracle = peng.generate(p[None], max_new_tokens=6, use_cache=False)
        np.testing.assert_array_equal(cached, oracle)


def _run_both(served, scfg, prompts, max_new, priorities=None):
    jm, jeng, pm, peng = served
    priorities = priorities or [0] * len(prompts)
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**scfg))
    ps = ContinuousBatchingScheduler(pm, peng.params, ServingConfig(**scfg))
    jr = [js.submit(p, JaxSampling(max_new_tokens=mn), priority=pr)
          for p, mn, pr in zip(prompts, max_new, priorities)]
    pr_ = [ps.submit(p, SamplingParams(max_new_tokens=mn), priority=pr)
           for p, mn, pr in zip(prompts, max_new, priorities)]
    js.run_until_idle()
    ps.run_until_idle()
    return js, jr, ps, pr_


@pytest.mark.parametrize("fused", [1, 8])
def test_scheduler_matches_jax_scheduler(served, fused):
    prompts = _mixed_prompts(5, seed=2)
    max_new = [7, 3, 12, 5, 9]
    js, jr, ps, pr_ = _run_both(
        served, dict(block_size=8, num_blocks=32, max_num_seqs=3,
                     max_num_batched_tokens=256, max_fused_steps=fused),
        prompts, max_new)
    for a, b in zip(jr, pr_):
        assert b.state == RequestState.FINISHED
        assert b.output_ids == a.output_ids
    assert ps.metrics.counters["decode_steps"] == \
        js.metrics.counters["decode_steps"]


def test_preemption_matches_jax_scheduler(served):
    """Pool exhaustion evicts the lowest-priority request in both
    packages; the resumed stream is token-identical to the JAX one and to
    the port's static generate."""
    prompts = _mixed_prompts(2, seed=6, lo=6, hi=7)
    js, jr, ps, pr_ = _run_both(
        served, dict(block_size=4, num_blocks=8, max_num_seqs=2,
                     max_num_batched_tokens=64),
        prompts, [10, 10], priorities=[1, 0])
    assert ps.metrics.counters["preemptions"] >= 1
    assert ps.metrics.counters["resumed"] >= 1
    assert pr_[1].num_preemptions >= 1 and pr_[0].num_preemptions == 0
    assert ps.metrics.counters["preemptions"] == \
        js.metrics.counters["preemptions"]
    for p, a, b in zip(prompts, jr, pr_):
        assert b.output_ids == a.output_ids
        assert b.output_ids == _static(served[3], p, 10)
    assert ps.block_mgr.num_allocated_blocks == 0


# ------------------------------------------------------ admission control
def test_admission_rejections(served):
    _, _, pm, peng = served
    cfg = ServingConfig(block_size=4, num_blocks=8, max_num_seqs=1,
                        max_queued=2)
    sched = ContinuousBatchingScheduler(pm, peng.params, cfg)
    prompt = _mixed_prompts(1, seed=7)[0]
    with pytest.raises(RequestTooLongError):
        sched.submit(np.arange(1, 20, dtype=np.int32),
                     SamplingParams(max_new_tokens=30))
    sched.submit(prompt, SamplingParams(max_new_tokens=2))
    sched.submit(prompt, SamplingParams(max_new_tokens=2))
    with pytest.raises(QueueFullError):       # 429, not a crash
        sched.submit(prompt, SamplingParams(max_new_tokens=2))
    assert sched.metrics.counters["rejected_queue_full"] == 1
    assert sched.metrics.counters["rejected_too_long"] == 1
    sched.run_until_idle()


def test_queued_timeout_rejects(served):
    _, _, pm, peng = served
    cfg = ServingConfig(block_size=4, num_blocks=16, max_num_seqs=1)
    sched = ContinuousBatchingScheduler(pm, peng.params, cfg)
    prompt = _mixed_prompts(1, seed=8)[0]
    blocker = sched.submit(prompt, SamplingParams(max_new_tokens=6))
    doomed = sched.submit(prompt, SamplingParams(max_new_tokens=2),
                          timeout_s=0.01)
    sched.step()                               # blocker takes the only slot
    time.sleep(0.05)
    sched.run_until_idle()
    assert blocker.state == RequestState.FINISHED
    assert doomed.state == RequestState.REJECTED
    assert "timed out" in doomed.reject_reason
    assert sched.metrics.counters["rejected_timeout"] == 1


# --------------------------------------------------------------- sampling
def _sampled_run(served, num_blocks, seeds, max_new=10):
    _, _, pm, peng = served
    cfg = ServingConfig(block_size=4, num_blocks=num_blocks, max_num_seqs=2,
                        max_num_batched_tokens=64)
    sched = ContinuousBatchingScheduler(pm, peng.params, cfg)
    prompts = _mixed_prompts(2, seed=6, lo=6, hi=7)
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=max_new,
                                           do_sample=True, seed=s,
                                           temperature=1.5, top_k=40,
                                           top_p=0.95),
                         priority=pr)
            for p, s, pr in zip(prompts, seeds, (1, 0))]
    sched.run_until_idle()
    return sched, [r.output_ids for r in reqs]


def test_sampling_deterministic_and_preemption_stable(served):
    roomy, a = _sampled_run(served, 64, seeds=(11, 12))
    again_sched, again = _sampled_run(served, 64, seeds=(11, 12))
    tight, b = _sampled_run(served, 8, seeds=(11, 12))
    assert roomy.metrics.counters["preemptions"] == 0
    assert tight.metrics.counters["preemptions"] >= 1
    assert a == again                 # same seeds -> same streams
    assert a == b                     # ... with or without preemption
    _, c = _sampled_run(served, 64, seeds=(13, 14))
    assert c != a                     # the seed matters


def test_sampling_filters_match_jax():
    """Top-k / top-p / per-row processing produce the reference's masks
    on the same logits (fp32, values <= 1e-6 where kept)."""
    import jax.numpy as jnp
    import torch
    from deepspeed_tpu.inference import sampling as js
    from deepspeed_tpu.serving.spec.verifier import \
        process_sampling_logits as jax_process
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 50), dtype=np.float32) * 3
    xt = torch.from_numpy(x)
    pairs = [(apply_top_k(xt, 7), js.apply_top_k(jnp.asarray(x), 7)),
             (apply_top_p(xt, 0.8), js.apply_top_p(jnp.asarray(x), 0.8))]
    temps = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    ks = np.array([0, 5, 10, 50], np.int32)
    ps = np.array([1.0, 0.9, 0.5, 0.99], np.float32)
    pairs.append((process_sampling_logits(
        xt, torch.from_numpy(temps), torch.from_numpy(ks),
        torch.from_numpy(ps)),
        jax_process(jnp.asarray(x), jnp.asarray(temps), jnp.asarray(ks),
                    jnp.asarray(ps))))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)
