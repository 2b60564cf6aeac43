"""deepspeed_tpu_torch GPT-Neo against the JAX package (fp32, the same
weights in both): the full forward (logits 1e-4) on ``gptneo:tiny``
(alternating global / local layers, window 16), at GPT-Neo 2.7B's
head_dim 128, and with every layer local; the parameter counts of every
preset and the device init's tree; prefill and decode against the JAX
serving functions past the window (float and int8 cache); the scheduler
token-identical to the JAX scheduler across a preemption and to the
port's static generate, with prompts longer than the window so the floor
bites; the plain path's kernel calls counted (no flash at prefill, the
decode kernel's windowed form on every layer); fused decode refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import sharding_pin_scope
from deepspeed_tpu.models import gptneo as jgn
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.checkpoint.jax_params import gpt2_params_from_numpy
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import gpt2 as pgpt2
from deepspeed_tpu_torch.models import gptneo as pgn
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import qgemm as qg
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                         RequestState, SamplingParams)
from deepspeed_tpu_torch.serving.server import (build_parser,
                                                build_scheduler,
                                                model_from_spec)

#: gptneo:tiny variants: GPT-Neo 2.7B's head_dim 128 on a narrow model;
#: every layer local
VARIANTS = {
    "tiny": {},
    "hd128": dict(num_heads=2, d_model=256),
    "all_local": dict(attention_layers=("local", "local")),
}


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t)


def _engines(kv=None):
    jm = jgn.gptneo_model("tiny", dtype="float32")
    cfg = {"dtype": "float32", "kv_cache_dtype": kv}
    jeng = deepspeed_tpu.init_inference(model=jm, config=cfg)
    pm = pgn.gptneo_model("tiny", dtype="float32")
    peng = InferenceEngine(pm, DeepSpeedInferenceConfig(**cfg),
                           model_parameters=jax.device_get(jeng.params),
                           device="cpu")
    return jm, jeng, pm, peng


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_full_forward_matches_jax(variant):
    kw = dict(jgn.GPTNEO_SIZES["tiny"], **VARIANTS[variant])
    cfg = jgn.GPTNeoConfig(**kw, dtype="float32")
    tree = pgpt2.numpy_init_params(pgn._gpt2_cfg(pgn.GPTNeoConfig(**kw)), 1)
    ids = np.random.default_rng(2).integers(0, 256, (2, 40)).astype(np.int32)
    ref = jgn.forward(jax.tree.map(jnp.asarray, tree),
                      {"input_ids": jnp.asarray(ids)}, cfg)
    pm = pgn.gptneo_model("tiny", dtype="float32", **VARIANTS[variant])
    got = pm.apply(gpt2_params_from_numpy(tree, "cpu", torch.float32),
                   {"input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", sorted(pgn.GPTNEO_SIZES))
def test_count_params_match_the_reference(size):
    want = jgn.count_params(jgn.GPTNeoConfig(**jgn.GPTNEO_SIZES[size]))
    cfg = pgn.GPTNeoConfig(**pgn.GPTNEO_SIZES[size])
    assert pgn.count_params(cfg) == want
    assert model_from_spec(f"gptneo:{size}").meta["n_params"] == want
    assert cfg.layer_kinds == jgn.GPTNeoConfig(
        **jgn.GPTNEO_SIZES[size]).layer_kinds


def test_device_init_has_the_gpt2_layout():
    """The device init (2.7B is drawn on the card) gives the tree of the
    JAX engine's params, leaf for leaf in shape."""
    _, jeng, pm, _ = _engines()
    tree = jax.device_get(jeng.params)
    dev = pm.init(0, "cpu")
    q = pm.quantized_init_fn(0, "cpu", torch.float32)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        mine, mq = dev, q
        for k in path:
            mine, mq = mine[k.key], mq[k.key]
        assert tuple(mine.shape) == np.shape(leaf), path
        assert isinstance(mq, QuantizedTensor) == (np.ndim(leaf) == 3)


def test_fused_decode_and_training_refused():
    """No fused spec takes a window: asking for fused decode raises (the
    reference quietly runs GPT-Neo unfused); so does an unported remat
    policy (training itself: tests/test_torch_family_train.py)."""
    _, _, pm, peng = _engines()
    assert pm.fused_spec is None
    with pytest.raises(NotImplementedError, match="wires no fused-layer"):
        ContinuousBatchingScheduler(pm, peng.params,
                                    ServingConfig(fused_decode=True))
    cache = pm.init_cache_fn(1, 64, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="wires no fused-layer"):
        pm.decode_fn(peng.params, torch.tensor([3]), cache,
                     torch.tensor([4], dtype=torch.int32), fused=True)
    with pytest.raises(NotImplementedError, match="remat policies"):
        pgn.GPTNeoConfig(remat=True, remat_policy="save_attn")


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_and_decode_match_jax(kv):
    """Rows past the window (window 16): the local layers' floors bite."""
    jm, jeng, pm, peng = _engines(kv)
    B, S, size = 3, 40, 64
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 256, (B, S)).astype(np.int32)
    lens = np.array([40, 9, 23], np.int32)
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
        pl, pc = pm.decode_fn(peng.params, torch.from_numpy(tok), pc,
                              torch.from_numpy(L))
        np.testing.assert_allclose(_np(pl), _np(jl), atol=1e-5, rtol=0)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


class _Count:
    """Calls of ``fn``; ``floors``: the ``min_pos`` each was given."""

    def __init__(self, fn):
        self.fn, self.n, self.floors = fn, 0, []

    def __call__(self, *a, **kw):
        self.n += 1
        if kw.get("min_pos") is not None:
            self.floors.append(kw["min_pos"].tolist())
        return self.fn(*a, **kw)


@pytest.mark.parametrize("int8_weights,int8_cache",
                         [(False, False), (True, True)])
def test_decode_runs_the_windowed_kernel_on_every_layer(
        monkeypatch, int8_weights, int8_cache):
    """Per prefill no flash (the banded einsum) and no qgemm; per decode
    step L decode attentions, each with a window floor (0 on the global
    layer, max(length + 1 - 16, 0) on the local one), and 4 L qgemm with
    int8 weights."""
    model = pgn.gptneo_model("tiny", dtype="float32")
    params = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": int8_weights}),
        device="cpu").params
    counts = {"decode": _Count(pgpt2.decode_attention),
              "qgemm": _Count(qg.qgemm),
              "flash": _Count(fa.flash_attention_fwd)}
    monkeypatch.setattr(pgpt2, "decode_attention", counts["decode"])
    monkeypatch.setattr(qg, "qgemm", counts["qgemm"])
    monkeypatch.setattr(fa, "flash_attention_fwd", counts["flash"])
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, 256, (2, 30)).astype(np.int32))
    cache = model.init_cache_fn(2, 64, "int8" if int8_cache else None, "cpu")
    _, cache = model.prefill_fn(params, {"input_ids": toks[:, :20]}, cache)
    assert counts["qgemm"].n == counts["flash"].n == 0
    for pos in range(20, 30):
        _, cache = model.decode_fn(params, toks[:, pos], cache,
                                   torch.tensor([pos, 5], dtype=torch.int32))
    L_ = model.config.num_layers
    assert counts["decode"].n == L_ * 10 == len(counts["decode"].floors)
    assert counts["qgemm"].n == (4 * L_ * 10 if int8_weights else 0)
    assert counts["decode"].floors[:2] == [[0, 0], [5, 0]]
    assert counts["decode"].floors[-1] == [14, 0]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 256, (n,)).astype(np.int32)
            for n in (20, 37, 17, 25)]


SCHED = dict(block_size=8, num_blocks=10, max_num_seqs=3,
             max_num_batched_tokens=256)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_scheduler_matches_jax_scheduler_and_static_generate(kv):
    """Greedy, fp32, prompts longer than the window: the port's scheduler
    gives the JAX scheduler's tokens and its own static generate's, with
    a pool small enough that a request is preempted and resumed."""
    jm, jeng, pm, peng = _engines(kv)
    prompts, max_new = _prompts(), (8, 6, 10, 7)
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**SCHED),
                      kv_cache_dtype=kv)
    jr = [js.submit(p, JaxSampling(max_new_tokens=n), priority=i % 2)
          for i, (p, n) in enumerate(zip(prompts, max_new))]
    js.run_until_idle()
    ps = ContinuousBatchingScheduler(pm, peng.params, ServingConfig(**SCHED),
                                     kv_cache_dtype=kv)
    pr = [ps.submit(p, SamplingParams(max_new_tokens=n), priority=i % 2)
          for i, (p, n) in enumerate(zip(prompts, max_new))]
    ps.run_until_idle()
    assert ps.metrics.counters["preemptions"] >= 1
    for p, n, a, b in zip(prompts, max_new, jr, pr):
        assert b.state == RequestState.FINISHED
        assert b.output_ids == a.output_ids
        ref = peng.generate(p, max_new_tokens=n)
        assert b.output_ids == list(ref[0, p.size:])
    assert ps.block_mgr.num_allocated_blocks == 0


def test_server_cli_builds_an_int8_gptneo_scheduler():
    """``--model gptneo:tiny --int8-weights --kv-cache-dtype int8``: the
    quantizing device init, an int8 pool, a request served; ``--fused-
    decode on`` is refused."""
    argv = ["--model", "gptneo:tiny", "--int8-weights", "--dtype",
            "float32", "--device", "cpu", "--kv-cache-dtype", "int8"]
    sched = build_scheduler(build_parser().parse_args(argv))
    assert sched.pool["k"].dtype == torch.int8 and not sched.fused_decode
    req = sched.submit(np.arange(1, 30, dtype=np.int32),
                       SamplingParams(max_new_tokens=4))
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED and req.num_generated == 4
    with pytest.raises(NotImplementedError, match="wires no fused-layer"):
        build_scheduler(build_parser().parse_args(argv + ["--fused-decode",
                                                          "on"]))
