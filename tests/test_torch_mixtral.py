"""deepspeed_tpu_torch Mixtral against the JAX package on ``mixtral:tiny``
(fp32, the JAX engine's weights carried across as numpy): rotary and
RMSNorm (1e-6), the full forward (logits 1e-4), prefill and decode
(logits 1e-4, caches 1e-5), and the continuous-batching scheduler
token-identical to the JAX scheduler across a preemption, with a float
and an int8 KV cache.  The JAX side runs its Pallas grouped-GEMM kernels
in interpret mode (``DS_GGEMM_INTERPRET=1``), so both packages take the
slot branch at T * top_k <= 128 and the group-padded one above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import sharding_pin_scope
from deepspeed_tpu.models import mixtral as jmix
from deepspeed_tpu.models.llama import _rms_norm as jax_rms_norm
from deepspeed_tpu.models.llama import rope as jax_rope
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.checkpoint.jax_params import (
    mixtral_params_from_numpy, mixtral_params_to_numpy)
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import mixtral as pmix
from deepspeed_tpu_torch.models.llama import _rms_norm, rope
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                         RequestState, SamplingParams)
from deepspeed_tpu_torch.serving.server import (build_parser,
                                                build_scheduler,
                                                model_from_spec)


@pytest.fixture(scope="module", autouse=True)
def _interpret_grouped_gemm():
    """The JAX package runs its grouped-GEMM kernels (interpret mode) for
    every program this module traces, and its schedulers check the
    block-accounting invariant each step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_GGEMM_INTERPRET", "1")
        mp.setenv("DS_SERVE_DEBUG", "1")
        yield


def _engines(kv_cache_dtype=None):
    jm = jmix.mixtral_model("tiny", attention_impl="xla", dtype="float32")
    cfg = {"dtype": "float32", "kv_cache_dtype": kv_cache_dtype}
    jeng = deepspeed_tpu.init_inference(model=jm, config=cfg)
    pm = pmix.mixtral_model("tiny", dtype="float32")
    peng = InferenceEngine(pm, DeepSpeedInferenceConfig(**cfg),
                           model_parameters=jax.device_get(jeng.params),
                           device="cpu")
    return jm, jeng, pm, peng


@pytest.fixture(scope="module")
def served():
    return _engines()


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ----------------------------------------------------------- the helpers
@pytest.mark.parametrize("pos", ["none", "shared", "per_row"])
def test_rope_and_rms_norm_match_jax(pos):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 8), dtype=np.float32)
    p = {"none": None, "shared": np.arange(60, 66, dtype=np.int32),
         "per_row": np.array([[0, 1, 2, 3, 4, 5], [90, 91, 92, 93, 94, 95]],
                             np.int32)}[pos]
    ref = jax_rope(jnp.asarray(x), 1e6, None if p is None else jnp.asarray(p))
    got = rope(torch.from_numpy(x), 1e6,
               None if p is None else torch.from_numpy(p))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6, rtol=0)
    s = rng.standard_normal((8,), dtype=np.float32)
    np.testing.assert_allclose(
        _np(_rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)),
        _np(jax_rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)), atol=1e-6,
        rtol=0)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("S", [24, 72])
def test_full_forward_matches_jax(served, S):
    """B 2: T * k = 96 (slot branch) and 288 (group-padded branch)."""
    jm, jeng, pm, peng = served
    ids = np.random.default_rng(S).integers(1, 256, (2, S)).astype(np.int32)
    with sharding_pin_scope(False):
        ref, ref_aux = jmix.forward_with_aux(
            jeng.params, {"input_ids": jnp.asarray(ids)}, jm.config,
            train=False)
    gg.ds_ggemm.launches = gg.ds_ggemm_slots.launches = 0
    got, aux = pmix.forward_with_aux(
        peng.params, {"input_ids": torch.from_numpy(ids)}, pm.config)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6)
    assert gg.ds_ggemm.launches == gg.ds_ggemm_slots.launches == 0


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_and_decode_match_jax(kv):
    """Prompts of 40 tokens (T * k = 240, group branch) then three decode
    steps at per-row positions (slot branch)."""
    jm, jeng, pm, peng = _engines(kv)
    B, S, size = 3, 40, 64
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 256, (B, S)).astype(np.int32)
    lens = np.array([40, 13, 27], np.int32)       # right-padded rows
    cdt = "int8" if kv else None
    with sharding_pin_scope(False):
        jl, jc = jm.prefill_fn(jeng.params, {"input_ids": jnp.asarray(ids)},
                               jm.init_cache_fn(B, size, cdt))
    pc = pm.init_cache_fn(B, size, "int8" if kv else torch.float32, "cpu")
    pl, pc = pm.prefill_fn(peng.params, {"input_ids": torch.from_numpy(ids)},
                           pc)
    np.testing.assert_allclose(_np(pl), _np(jl), atol=1e-4, rtol=0)

    def caches_close(jc, pc):
        if kv:   # codes may round one step apart; compare the values
            for n in ("k", "v"):
                deq = _np(pc[n]).astype(np.float32) * _np(pc[n + "_s"])[
                    ..., None]
                ref = _np(jc[n]).astype(np.float32) * _np(jc[n + "_s"])[
                    ..., None]
                np.testing.assert_allclose(
                    deq, ref, rtol=0,
                    atol=1e-5 + float(_np(jc[n + "_s"]).max()))
        else:
            for n in ("k", "v"):
                np.testing.assert_allclose(_np(pc[n]), _np(jc[n]),
                                           atol=1e-5, rtol=0)
    caches_close(jc, pc)
    tok = ids[np.arange(B), lens - 1]
    for step in range(3):
        L = lens + step
        with sharding_pin_scope(False):
            jl, jc = jm.decode_fn(jeng.params, jnp.asarray(tok), jc,
                                  jnp.asarray(L))
        pl, pc = pm.decode_fn(peng.params, torch.from_numpy(tok), pc,
                              torch.from_numpy(L))
        np.testing.assert_allclose(_np(pl), _np(jl), atol=1e-4, rtol=0)
        caches_close(jc, pc)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


# ------------------------------------------------------------ the server
def _prompts():
    rng = np.random.default_rng(3)
    # 70 tokens: a prefill of T * k = 160 rows takes the group branch
    return [rng.integers(1, 256, (n,)).astype(np.int32)
            for n in (9, 70, 17, 5)]


def _run_both(jm, jeng, pm, peng, scfg, kv=None, max_new=(8, 6, 10, 7),
              priorities=(1, 0, 0, 1)):
    prompts = _prompts()
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**scfg),
                      kv_cache_dtype=kv)
    ps = ContinuousBatchingScheduler(pm, peng.params, ServingConfig(**scfg),
                                     kv_cache_dtype=kv)
    jr = [js.submit(p, JaxSampling(max_new_tokens=n), priority=pr)
          for p, n, pr in zip(prompts, max_new, priorities)]
    pr_ = [ps.submit(p, SamplingParams(max_new_tokens=n), priority=pr)
           for p, n, pr in zip(prompts, max_new, priorities)]
    js.run_until_idle()
    ps.run_until_idle()
    return prompts, js, jr, ps, pr_


@pytest.mark.parametrize("kv", [None, "int8"])
def test_scheduler_matches_jax_scheduler_across_preemption(kv):
    """Greedy, fp32: the port's scheduler gives the JAX scheduler's tokens
    and its own static generate's, with a pool small enough that a
    request is preempted and resumed (its prompt + generated tail
    re-prefilled)."""
    jm, jeng, pm, peng = _engines(kv)
    prompts, js, jr, ps, pr_ = _run_both(
        jm, jeng, pm, peng, dict(block_size=8, num_blocks=14,
                                 max_num_seqs=3,
                                 max_num_batched_tokens=256), kv)
    assert ps.metrics.counters["preemptions"] >= 1
    assert ps.metrics.counters["preemptions"] == \
        js.metrics.counters["preemptions"]
    for p, a, b in zip(prompts, jr, pr_):
        assert b.state == RequestState.FINISHED
        assert b.output_ids == a.output_ids
        ref = peng.generate(p[None], max_new_tokens=len(b.output_ids))
        assert b.output_ids == list(ref[0, p.size:])
    assert ps.block_mgr.num_allocated_blocks == 0


def test_model_from_spec_and_counts():
    m = model_from_spec("mixtral:tiny", dtype="float32")
    assert isinstance(m.config, pmix.MixtralConfig)
    assert m.config.num_experts == 4 and m.meta["name"] == "mixtral-tiny"
    for size, kw in (("tiny", {}), ("1b-moe", {}),
                     ("8x7b", {"num_layers": 16})):
        assert pmix.count_params(pmix.MixtralConfig(
            **{**pmix.MIXTRAL_SIZES[size], **kw})) == \
            jmix.count_params(jmix.MixtralConfig(
                **{**jmix.MIXTRAL_SIZES[size], **kw}))
    assert pmix.count_params(pmix.MixtralConfig(num_layers=16)) == \
        23_482_470_400
    # Llama is ported: llama:7b builds with the reference's count
    from deepspeed_tpu.models import llama as jll
    llama = model_from_spec("llama:7b")
    assert llama.meta["n_params"] == jll.count_params(jll.LlamaConfig(
        **jll.LLAMA_SIZES["7b"])) == 6_738_415_616


def test_server_cli_builds_a_mixtral_scheduler():
    """``--model mixtral:tiny --num-layers 1``: the CLI's depth override,
    an int8 pool, a request served; with ``--fused-decode on`` the fused
    scheduler serves the same tokens."""
    argv = ["--model", "mixtral:tiny", "--num-layers", "1", "--dtype",
            "float32", "--device", "cpu", "--kv-cache-dtype", "int8"]
    outs = {}
    for fused in ("off", "on"):
        sched = build_scheduler(build_parser().parse_args(
            argv + ["--fused-decode", fused]))
        assert sched.fused_decode is (fused == "on")
        assert sched.model.config.num_layers == 1
        assert sched.pool["k"].dtype == torch.int8
        assert sched.pool["k"].shape[0] == 1
        req = sched.submit(np.arange(1, 9, dtype=np.int32),
                           SamplingParams(max_new_tokens=4))
        sched.run_until_idle()
        assert req.state == RequestState.FINISHED and req.num_generated == 4
        outs[fused] = req.output_ids
    assert outs["on"] == outs["off"]


def test_params_carry_across_and_back(served):
    jm, jeng, _, _ = served
    tree = jax.device_get(jeng.params)
    got = mixtral_params_to_numpy(mixtral_params_from_numpy(tree, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == 13
    for path, leaf in flat:
        mine = got
        for k in path:
            mine = mine[k.key]
        np.testing.assert_array_equal(mine, np.asarray(leaf))
    with pytest.raises(ValueError, match="blocks.moe keys"):
        bad = dict(tree, blocks=dict(tree["blocks"], moe={"router": 0}))
        mixtral_params_from_numpy(bad, "cpu")


def test_device_init_is_seeded_and_shaped():
    cfg = pmix.MixtralConfig(**pmix.MIXTRAL_SIZES["tiny"])
    a = pmix.init_params(cfg, 3, "cpu", torch.bfloat16)
    b = pmix.init_params(cfg, 3, "cpu", torch.bfloat16)
    c = pmix.init_params(cfg, 4, "cpu", torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jmix.init_params(jmix.MixtralConfig(
        **jmix.MIXTRAL_SIZES["tiny"]), k), jax.random.PRNGKey(0))
    for (path, ref), x, y, z in zip(
            jax.tree_util.tree_leaves_with_path(shapes),
            *(jax.tree_util.tree_leaves(t) for t in (a, b, c))):
        assert tuple(x.shape) == ref.shape, path
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y)
        name = path[-1].key
        if name.endswith("norm"):
            assert torch.all(x == 1)
        else:
            assert not torch.equal(x, z)
            want = 0.02 / (2 * cfg.num_layers) ** 0.5 \
                if name in ("wo", "w_out") else 0.02
            assert abs(float(x.float().std()) / want - 1) < 0.15, name
    m = pmix.mixtral_model("tiny", dtype="float32")
    p = m.init(0, "cpu", torch.float32)
    assert p["blocks"]["moe"]["w_gate"].dtype == torch.float32


# --------------------------------------------------------------- refusals
def test_explicit_fused_decode_raises_never_falls_back(served):
    """Mixtral's fused arm (the attention half in the fused layer, the
    experts after it on the grouped kernels) serves: its scheduler is
    token-identical to the unfused one across a preemption, float and
    int8 cache, and its decode logits equal the unfused step's bitwise on
    the CPU.  A spec the kernel does not cover still raises."""
    jm, jeng, pm, peng = served
    for kv in (None, "int8"):
        out = {}
        for fused in (False, True):
            ps = ContinuousBatchingScheduler(
                pm, peng.params, ServingConfig(
                    block_size=8, num_blocks=14, max_num_seqs=3,
                    max_num_batched_tokens=256, fused_decode=fused),
                kv_cache_dtype=kv)
            reqs = [ps.submit(p, SamplingParams(max_new_tokens=n),
                              priority=pr)
                    for p, n, pr in zip(_prompts(), (8, 6, 10, 7),
                                        (1, 0, 0, 1))]
            ps.run_until_idle()
            assert ps.fused_decode is fused
            assert ps.metrics.counters["preemptions"] >= 1
            out[fused] = [r.output_ids for r in reqs]
        assert out[True] == out[False]
    cache = pm.init_cache_fn(1, 64, torch.float32, "cpu")
    args = (peng.params, torch.tensor([5]), cache,
            torch.tensor([0], dtype=torch.int32))
    fused = pm.decode_fn(*args, fused=True)[0]
    assert torch.equal(fused, pm.decode_fn(*args, fused=False)[0])
    for off in (None, False):       # None and False are the unfused path
        assert not ContinuousBatchingScheduler(
            pm, peng.params, ServingConfig(fused_decode=off)).fused_decode
    from dataclasses import replace
    gptj = replace(pm, fused_spec=replace(pm.fused_spec,
                                          rotary_interleaved=True))
    with pytest.raises(NotImplementedError,
                       match="rotary_interleaved.*as the reference's kernel"):
        ContinuousBatchingScheduler(gptj, peng.params,
                                    ServingConfig(fused_decode=True))


def test_unported_settings_raise(served):
    _, jeng, pm, peng = served
    tree = jax.device_get(jeng.params)
    # int8 weights on the stacked experts are served (the int8 grouped
    # GEMMs): the engine quantizes the expert stacks, router included
    int8 = InferenceEngine(pm, DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": True}),
        model_parameters=tree, device="cpu")
    moe = int8.params["blocks"]["moe"]
    assert all(isinstance(moe[k], QuantizedTensor)
               for k in ("router", "w_gate", "w_in", "w_out"))
    with pytest.raises(NotImplementedError, match="moe.ep_size=2"):
        InferenceEngine(pm, DeepSpeedInferenceConfig(
            dtype="float32", moe={"ep_size": 2}), model_parameters=tree,
            device="cpu")
    with pytest.raises(NotImplementedError, match="einsum"):
        ContinuousBatchingScheduler(pm, peng.params,
                                    ServingConfig(moe_dispatch="einsum"))
    for mode in ("auto", "grouped"):
        ContinuousBatchingScheduler(pm, peng.params,
                                    ServingConfig(moe_dispatch=mode))
