"""deepspeed_tpu_torch GPT-NeoX against the JAX package (fp32, the same
weights in both): the full forward (logits 1e-4) on ``neox:tiny`` with
the parallel and the serial residual, at NeoX-20B's head_dim 96 with its
24 rotary dims, and with GPT-J's interleaved rotary and head bias; the
params' keys, shapes and round trip; the parameter counts of every
preset; the seeded device init; prefill and decode against the JAX
serving functions (fused decode off and on, float and int8 cache); the
scheduler token-identical to the JAX scheduler across a preemption and
to the port's static generate; the plain path's kernel calls counted per
prefill and per decode step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import sharding_pin_scope
from deepspeed_tpu.models import neox as jnx
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.checkpoint.jax_params import (
    neox_params_from_numpy, neox_params_to_numpy)
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import neox as pnx
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

PROJECTIONS = ("qkv_w", "dense_w", "mlp_in_w", "mlp_out_w")
#: neox:tiny variants: the serial residual; NeoX-20B's head_dim 96 and
#: 24 rotary dims (12 pairs) on a narrow model; GPT-J (interleaved
#: rotary, a biased head)
VARIANTS = {
    "tiny": {},
    "serial": dict(use_parallel_residual=False, gelu_approximate=True),
    "hd96_rot24": dict(num_heads=2, d_model=192),
    "gptj": dict(rotary_interleaved=True, head_bias=True),
}


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t)


def _engines(kv=None, **overrides):
    jm = jnx.neox_model("tiny", attention_impl="xla", dtype="float32",
                        **overrides)
    cfg = {"dtype": "float32", "kv_cache_dtype": kv}
    jeng = deepspeed_tpu.init_inference(model=jm, config=cfg)
    pm = pnx.neox_model("tiny", dtype="float32", **overrides)
    peng = InferenceEngine(pm, DeepSpeedInferenceConfig(**cfg),
                           model_parameters=jax.device_get(jeng.params),
                           device="cpu")
    return jm, jeng, pm, peng


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_full_forward_matches_jax(variant):
    kw = dict(jnx.NEOX_SIZES["tiny"], **VARIANTS[variant])
    cfg = jnx.NeoXConfig(**kw, dtype="float32", attention_impl="xla")
    tree = pnx.numpy_init_params(pnx.NeoXConfig(**kw), 1)
    rng = np.random.default_rng(2)     # biases are zeros at init
    for k in ("qkv_b", "dense_b", "mlp_in_b", "mlp_out_b"):
        tree["blocks"][k] = rng.standard_normal(
            tree["blocks"][k].shape, dtype=np.float32) * 0.1
    ids = rng.integers(0, 256, (2, 40)).astype(np.int32)
    ref = jnx.forward(jax.tree.map(jnp.asarray, tree),
                      {"input_ids": jnp.asarray(ids)}, cfg)
    pm = pnx.neox_model("tiny", dtype="float32", **VARIANTS[variant])
    got = pm.apply(neox_params_from_numpy(tree, "cpu", torch.float32),
                   {"input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("head_bias", [False, True])
def test_params_keys_shapes_and_round_trip(head_bias):
    """The JAX engine's params carry across leaf for leaf and back; the
    port's init trees have the reference's keys and shapes."""
    _, jeng, _, _ = _engines(head_bias=head_bias)
    tree = jax.device_get(jeng.params)
    cfg = pnx.NeoXConfig(**pnx.NEOX_SIZES["tiny"], head_bias=head_bias)
    mine = pnx.numpy_init_params(cfg, 0)
    dev = pnx.init_params(cfg, 0, "cpu")
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == (17 if head_bias else 16)
    back = neox_params_to_numpy(neox_params_from_numpy(tree, "cpu"))
    for path, leaf in flat:
        got, host, drawn = back, mine, dev
        for k in path:
            got, host, drawn = got[k.key], host[k.key], drawn[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))
        assert host.shape == tuple(drawn.shape) == np.shape(leaf), path
    with pytest.raises(ValueError, match="blocks keys"):
        bad = dict(tree, blocks=dict(tree["blocks"], extra=0))
        neox_params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("size", sorted(pnx.NEOX_SIZES))
def test_count_params_match_the_reference(size):
    want = jnx.count_params(jnx.NeoXConfig(**jnx.NEOX_SIZES[size]))
    assert pnx.count_params(pnx.NeoXConfig(**pnx.NEOX_SIZES[size])) == want
    assert model_from_spec(f"neox:{size}").meta["n_params"] == want


def test_device_init_is_seeded_and_quantizes_as_drawn():
    from deepspeed_tpu_torch.ops.kernels.quantization import \
        block_quantize_int8
    cfg = pnx.NeoXConfig(**pnx.NEOX_SIZES["tiny"])
    a = pnx.init_params(cfg, 3, "cpu", torch.bfloat16)
    b = pnx.init_params(cfg, 3, "cpu", torch.bfloat16)
    q = pnx.init_quantized_params(cfg, 3, "cpu", torch.bfloat16)
    for k, v in a["blocks"].items():
        assert torch.equal(v, b["blocks"][k])
        if k in PROJECTIONS:
            for l in range(cfg.num_layers):
                codes, scales = block_quantize_int8(v[l])
                assert torch.equal(q["blocks"][k].q[l], codes), k
                assert torch.equal(q["blocks"][k].s[l], scales), k
        else:
            assert torch.all(v == (1 if k.endswith("scale") else 0)), k
    assert torch.equal(q["embed_out"], a["embed_out"])


def test_spec_and_refusals():
    """The fused spec is the reference's; GPT-J's interleaved rotary is a
    spec the fused kernel refuses, and asking for fused decode on it
    raises (the reference quietly runs it unfused)."""
    pm = pnx.neox_model("20b")
    s = pm.fused_spec
    assert (s.qkv, s.residual, s.mlp, s.rotary_dims, s.head_dim) == \
        ("headmajor", "parallel", "gelu_exact", 24, 96) and s.supported()
    gptj = pnx.neox_model("tiny", dtype="float32", rotary_interleaved=True)
    params = pnx.init_params(gptj.config, 0, "cpu")
    with pytest.raises(NotImplementedError, match="rotary_interleaved"):
        ContinuousBatchingScheduler(gptj, params,
                                    ServingConfig(fused_decode=True))
    with pytest.raises(NotImplementedError, match="remat policies"):
        pnx.NeoXConfig(remat=True, remat_policy="dots")


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_and_decode_match_jax(kv):
    jm, jeng, pm, peng = _engines(kv)
    B, S, size = 3, 24, 64
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 256, (B, S)).astype(np.int32)
    lens = np.array([24, 9, 17], np.int32)
    with sharding_pin_scope(False):
        jl, jc = jm.prefill_fn(jeng.params, {"input_ids": jnp.asarray(ids)},
                               jm.init_cache_fn(B, size, kv))
    pc = pm.init_cache_fn(B, size, kv or torch.float32, "cpu")
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
        pc = c
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


class _Count:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("int8_weights,int8_cache",
                         [(w8, c8) for w8 in (False, True)
                          for c8 in (False, True)])
def test_fused_decode_step_matches_unfused(monkeypatch, int8_weights,
                                           int8_cache):
    """Teacher-forced decode, bf16: the fused step's logits and cache
    equal the unfused step's bitwise, and each path calls what it
    should: per prefill L flash forwards and no qgemm; per decode step
    fused L fused layers and nothing else, unfused L decode attentions
    and 4 L qgemm with int8 weights."""
    model = pnx.neox_model("tiny", dtype="bfloat16")
    params = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="bfloat16", quant={"enabled": int8_weights}),
        device="cpu").params
    L_ = model.config.num_layers
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
        cache = model.init_cache_fn(2, 64, "int8" if int8_cache else None,
                                    "cpu")
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
        got = {k: c.n - before[k] for k, c in counts.items()}
        want = ({"fused": L_ * 6, "decode": 0, "qgemm": 0, "flash": 0}
                if fused else
                {"fused": 0, "decode": L_ * 6, "flash": 0,
                 "qgemm": 4 * L_ * 6 if int8_weights else 0})
        assert got == want
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
            for n in (9, 40, 17, 5)]


SCHED = dict(block_size=8, num_blocks=10, max_num_seqs=3,
             max_num_batched_tokens=256)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_scheduler_matches_jax_scheduler_and_static_generate(kv):
    """Greedy, fp32: the port's scheduler, fused decode off and on, gives
    the JAX scheduler's tokens and its own static generate's, with a
    pool small enough that a request is preempted and resumed."""
    jm, jeng, pm, peng = _engines(kv)
    prompts, max_new = _prompts(), (8, 6, 10, 7)
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**SCHED),
                      kv_cache_dtype=kv)
    jr = [js.submit(p, JaxSampling(max_new_tokens=n), priority=i % 2)
          for i, (p, n) in enumerate(zip(prompts, max_new))]
    js.run_until_idle()
    for fused in (False, True):
        ps = ContinuousBatchingScheduler(
            pm, peng.params, ServingConfig(**SCHED, fused_decode=fused),
            kv_cache_dtype=kv)
        pr = [ps.submit(p, SamplingParams(max_new_tokens=n), priority=i % 2)
              for i, (p, n) in enumerate(zip(prompts, max_new))]
        ps.run_until_idle()
        assert ps.fused_decode is fused
        assert ps.metrics.counters["preemptions"] >= 1
        for p, n, a, b in zip(prompts, max_new, jr, pr):
            assert b.state == RequestState.FINISHED
            assert b.output_ids == a.output_ids
            ref = peng.generate(p, max_new_tokens=n, fused_decode=fused)
            assert b.output_ids == list(ref[0, p.size:])
        assert ps.block_mgr.num_allocated_blocks == 0


def test_server_cli_builds_a_fused_int8_neox_scheduler():
    """``--model neox:tiny --int8-weights --kv-cache-dtype int8
    --fused-decode on``: the quantizing device init, an int8 pool, the
    fused path, a request served."""
    argv = ["--model", "neox:tiny", "--int8-weights", "--dtype", "float32",
            "--device", "cpu", "--kv-cache-dtype", "int8", "--fused-decode",
            "on"]
    sched = build_scheduler(build_parser().parse_args(argv))
    assert sched.fused_decode and sched.pool["k"].dtype == torch.int8
    assert all(isinstance(sched.params["blocks"][k], QuantizedTensor)
               for k in PROJECTIONS)
    req = sched.submit(np.arange(1, 9, dtype=np.int32),
                       SamplingParams(max_new_tokens=4))
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED and req.num_generated == 4
