"""deepspeed_tpu_torch int8 Mixtral serving against the JAX package on
``mixtral:tiny`` (fp32): int8 weights on every >= 3-dim block leaf (the
projections, the router and the 4-D expert stacks), a float or int8 KV
cache.

- the quantizing device init equals ``block_quantize_int8`` of the float
  device init bit for bit, and the port's quantizer equals the JAX
  package's ``_ref_quantize`` on Mixtral's leaves;
- the int8 engine quantizes the nested tree leaf by leaf (expert stacks
  by [layer, expert] slice) and carries a JAX int8 engine's bytes across;
- ``maybe_stream``'s keep flags keep exactly the leaves the JAX package's
  ``_maybe_dequant`` keeps;
- prefill and decode logits within 1e-4 of the JAX int8 engine's, caches
  within 1e-5 (float) or one code (int8);
- the continuous-batching scheduler token-identical to the JAX int8
  scheduler and to the port's static generate across a preemption, in the
  slot arm (small ``max_num_seqs``, float and int8 cache) and the
  group-padded arm (``max_num_seqs`` 66: R = 132 rows a decode step), each
  arm's plain grouped form counted.

Parity tests carry the JAX engine's ``QuantizedTensor``s across, so both
sides serve identical codes (the JAX engine jit-compiles its quantizer,
and XLA's CPU build can round a code one step away from the reference's).
The JAX side runs its Pallas int8 grouped-GEMM kernels in interpret mode
(``DS_GGEMM_INTERPRET=1``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import sharding_pin_scope
from deepspeed_tpu.models import mixtral as jmix
from deepspeed_tpu.models.model import QuantizedTensor as JaxQuantized
from deepspeed_tpu.models.model import _maybe_dequant
from deepspeed_tpu.ops.pallas.quantization import _ref_quantize
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import (ContinuousBatchingScheduler as
                                   JaxScheduler)
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.checkpoint.jax_params import (
    mixtral_params_from_numpy, mixtral_params_to_numpy)
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import mixtral as pmix
from deepspeed_tpu_torch.models.model import (QuantizedTensor, layer_params,
                                              maybe_stream)
from deepspeed_tpu_torch.models.serving import qgemm_active
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
from deepspeed_tpu_torch.ops.kernels import qgemm as qg
from deepspeed_tpu_torch.ops.kernels import quantization as qz
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                         RequestState, SamplingParams)
from deepspeed_tpu_torch.serving.server import (build_parser,
                                                build_scheduler)

QUANTIZED = {("wq",), ("wk",), ("wv",), ("wo",), ("moe", "router"),
             ("moe", "w_gate"), ("moe", "w_in"), ("moe", "w_out")}


@pytest.fixture(scope="module", autouse=True)
def _interpret_grouped_gemm():
    """The JAX package runs its grouped-GEMM kernels (interpret mode) for
    every program this module traces, and its schedulers check the
    block-accounting invariant each step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_GGEMM_INTERPRET", "1")
        mp.setenv("DS_SERVE_DEBUG", "1")
        yield


def _jax_model():
    return jmix.mixtral_model("tiny", attention_impl="xla", dtype="float32")


def _engines(kv_cache_dtype=None):
    """The JAX int8 engine and the port's engine on its params (the same
    codes and scales)."""
    jm = _jax_model()
    cfg = {"dtype": "float32", "quant": {"enabled": True},
           "kv_cache_dtype": kv_cache_dtype}
    jeng = deepspeed_tpu.init_inference(model=jm, config=cfg)
    pm = pmix.mixtral_model("tiny", dtype="float32")
    peng = InferenceEngine(pm, DeepSpeedInferenceConfig(**cfg),
                           model_parameters=jax.device_get(jeng.params),
                           device="cpu")
    return jm, jeng, pm, peng


@pytest.fixture(scope="module")
def float_tree():
    """The JAX package's seeded fp32 Mixtral init, as numpy."""
    return jax.device_get(deepspeed_tpu.init_inference(
        model=_jax_model(), config={"dtype": "float32"}).params)


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


def _leaves(tree, path=()):
    """(path, leaf) of a nested params dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------- the load
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_device_init_is_the_quantized_float_init(dtype):
    """Bit for bit: codes and scales of every >= 3-dim block leaf are
    ``block_quantize_int8`` of ``init_params``' leaf; the rest equal."""
    cfg = pmix.MixtralConfig(**pmix.MIXTRAL_SIZES["tiny"])
    plain = pmix.init_params(cfg, 5, "cpu", dtype)
    quant = pmix.init_quantized_params(cfg, 5, "cpu", dtype)
    blocks = dict(_leaves(quant["blocks"]))
    assert {p for p, v in blocks.items()
            if isinstance(v, QuantizedTensor)} == QUANTIZED
    for path, leaf in _leaves(plain["blocks"]):
        got = blocks[path]
        if path in QUANTIZED:
            q, s = qz.block_quantize_int8(leaf)
            assert torch.equal(got.q, q) and torch.equal(got.s, s), path
            assert got.dtype == dtype and got.q.dtype == torch.int8
        else:
            assert torch.equal(got, leaf), path
    for key in ("wte", "final_norm", "lm_head"):
        assert torch.equal(quant[key], plain[key])
    model = pmix.mixtral_model("tiny", dtype="float32")
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": True}), device="cpu")
    want = pmix.init_quantized_params(model.config, 0, "cpu", torch.float32)
    for path, leaf in _leaves(want["blocks"]):
        if path in QUANTIZED:
            assert torch.equal(_at(eng.params["blocks"], path).q, leaf.q)


def test_port_quantizer_matches_ref_quantize_on_mixtral_leaves(float_tree):
    """The port's quantizer (its plain version, as the CPU runs it) gives
    the JAX package's ``_ref_quantize`` codes and scales exactly, on the
    4-D expert stacks, the 3-D projections and the [D, E] router."""
    for path, leaf in _leaves(float_tree["blocks"]):
        if path not in QUANTIZED:
            continue
        for dt in ("float32", "bfloat16"):
            w = jnp.asarray(leaf).astype(dt)
            q_ref, s_ref = _ref_quantize(w)
            q, s = qz.block_quantize_int8(
                torch.from_numpy(np.array(leaf)).to(getattr(torch, dt)))
            np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
            np.testing.assert_array_equal(_np(s), np.asarray(s_ref))


def test_int8_engine_quantizes_the_nested_tree(float_tree):
    """The engine's leaf-by-leaf load of a float tree: every >= 3-dim
    block leaf int8 (the 4-D stacks one [layer, expert] slice a launch on
    the card), the codes ``_ref_quantize`` gives; a JAX int8 engine's tree
    carries across with its bytes, and back with ``mixtral_params_to_
    numpy``."""
    pm = pmix.mixtral_model("tiny", dtype="float32")
    cfg = DeepSpeedInferenceConfig(dtype="float32", quant={"enabled": True})
    peng = InferenceEngine(pm, cfg, model_parameters=float_tree,
                           device="cpu")
    for path, leaf in _leaves(peng.params["blocks"]):
        if path in QUANTIZED:
            q_ref, s_ref = _ref_quantize(jnp.asarray(
                _at(float_tree["blocks"], path)))
            np.testing.assert_array_equal(_np(leaf.q), np.asarray(q_ref))
            np.testing.assert_array_equal(_np(leaf.s), np.asarray(s_ref))
        else:
            assert not isinstance(leaf, QuantizedTensor)
    jeng = deepspeed_tpu.init_inference(
        model=_jax_model(), config={"dtype": "float32",
                                    "quant": {"enabled": True}})
    jtree = jax.device_get(jeng.params)
    carried = InferenceEngine(pm, cfg, model_parameters=jtree, device="cpu")
    back = mixtral_params_to_numpy(carried.params)
    direct = mixtral_params_from_numpy(jtree, "cpu", torch.float32)
    for path, leaf in _leaves(carried.params["blocks"]):
        jl = _at(jtree["blocks"], path)
        if path in QUANTIZED:
            assert isinstance(jl, JaxQuantized)
            for got in (leaf, _at(direct["blocks"], path)):
                np.testing.assert_array_equal(_np(got.q), np.asarray(jl.q))
                np.testing.assert_array_equal(_np(got.s), np.asarray(jl.s))
            q, s = _at(back["blocks"], path)
            np.testing.assert_array_equal(q, np.asarray(jl.q))
            np.testing.assert_array_equal(s, np.asarray(jl.s))
        else:
            np.testing.assert_array_equal(_np(leaf), np.asarray(jl))


@pytest.mark.parametrize("keep_q", [False, True])
def test_maybe_stream_keeps_what_the_reference_keeps(keep_q):
    """Layer 1 of the int8 params: the leaves that stay quantized, and the
    values of those that dequantize, match ``_maybe_dequant`` with both
    keep flags set as the port's one flag is (decode keeps projections,
    router and experts quantized; prefill dequantizes everything)."""
    _, jeng, _, peng = _engines()
    jl = jax.tree.map(lambda a: a[1], jeng.params["blocks"])
    ref = _maybe_dequant(jl, keep_gemm_weights=keep_q,
                         keep_moe_weights=keep_q)
    got = maybe_stream(layer_params(peng.params["blocks"], 1),
                       keep_quantized=keep_q)
    kept = set()
    for path, leaf in _leaves(got):
        r = _at(ref, path)
        assert isinstance(leaf, QuantizedTensor) == isinstance(
            r, JaxQuantized), path
        if isinstance(leaf, QuantizedTensor):
            kept.add(path)
            np.testing.assert_array_equal(_np(leaf.q), np.asarray(r.q))
        else:
            np.testing.assert_array_equal(_np(leaf), np.asarray(r))
    assert kept == (set(QUANTIZED) if keep_q else set())
    assert qgemm_active(peng.params["blocks"])
    assert not qgemm_active(pmix.init_params(
        pmix.MixtralConfig(**pmix.MIXTRAL_SIZES["tiny"]), 0, "cpu")["blocks"])


# ------------------------------------------------------- prefill / decode
class _Counts:
    """Calls of the plain int8 forms (what the CPU runs in place of the
    kernels) while the block is active."""

    def __init__(self, monkeypatch):
        self.n = {"slot_q": 0, "group_q": 0, "qgemm": 0, "slot": 0,
                  "group": 0}
        for key, mod, name in (("slot_q", gg, "ggemm_slots_q_plain"),
                               ("group_q", gg, "ggemm_q_plain"),
                               ("qgemm", qg, "qgemm_plain"),
                               ("slot", gg, "ggemm_slots_plain"),
                               ("group", gg, "ggemm_plain")):
            monkeypatch.setattr(mod, name, self._count(key, getattr(mod,
                                                                    name)))

    def _count(self, key, fn):
        def counted(*a, **kw):
            self.n[key] += 1
            return fn(*a, **kw)
        return counted

    def take(self):
        """The counts since the last take; ``slot`` / ``group`` count the
        float forms' own calls (each int8 form runs its float form on the
        dequantized experts)."""
        n, self.n = self.n, dict.fromkeys(self.n, 0)
        n["slot"] -= n["slot_q"]
        n["group"] -= n["group_q"]
        return n


@pytest.mark.parametrize("kv", [None, "int8"])
def test_int8_prefill_and_decode_match_jax(kv, monkeypatch):
    """Prompts of 40 tokens (T * k = 240: the layer dequantized whole,
    the float group-padded form) then three decode steps (the experts
    quantized into the int8 slot form, the projections and router into
    qgemm)."""
    jm, jeng, pm, peng = _engines(kv)
    B, S, size = 3, 40, 64
    L = pm.config.num_layers
    rng = np.random.default_rng(17)
    ids = rng.integers(1, 256, (B, S)).astype(np.int32)
    lens = np.array([40, 11, 29], np.int32)
    counts = _Counts(monkeypatch)
    with sharding_pin_scope(False):
        jl, jc = jm.prefill_fn(jeng.params, {"input_ids": jnp.asarray(ids)},
                               jm.init_cache_fn(B, size, kv))
    pc = pm.init_cache_fn(B, size, "int8" if kv else torch.float32, "cpu")
    pl, pc = pm.prefill_fn(peng.params, {"input_ids": torch.from_numpy(ids)},
                           pc)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=1e-4, rtol=0)
    assert counts.take() == {"slot_q": 0, "group_q": 0, "qgemm": 0,
                             "slot": 0, "group": 3 * L}

    def caches_close(jc, pc):
        for n in ("k", "v"):
            if kv:
                dq = np.abs(_np(pc[n]).astype(np.int32)
                            - np.asarray(jc[n]).astype(np.int32))
                assert dq.max() <= 1, n
                np.testing.assert_allclose(_np(pc[n + "_s"]),
                                           np.asarray(jc[n + "_s"]),
                                           rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(_np(pc[n]), np.asarray(jc[n]),
                                           atol=1e-5, rtol=0)
    caches_close(jc, pc)
    tok = ids[np.arange(B), lens - 1]
    for step in range(3):
        pos = lens + step
        with sharding_pin_scope(False):
            jl, jc = jm.decode_fn(jeng.params, jnp.asarray(tok), jc,
                                  jnp.asarray(pos))
        pl, pc = pm.decode_fn(peng.params, torch.from_numpy(tok), pc,
                              torch.from_numpy(pos))
        np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        caches_close(jc, pc)
        # per layer: 3 expert products, wq / wk / wv / wo and the router
        assert counts.take() == {"slot_q": 3 * L, "group_q": 0,
                                 "qgemm": 5 * L, "slot": 0, "group": 0}
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


# ------------------------------------------------------------ the server
def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 256, (n,)).astype(np.int32)
            for n in (9, 70, 17, 5)]


#: arm -> (max_num_seqs, KV cache): the slot arm at R = 2 * 3 rows, the
#: group-padded arm at R = 2 * 66 = 132 > SLOT_MAX_ROWS
ARMS = {"slot-float": (3, None), "slot-int8": (3, "int8"),
        "group-int8": (66, "int8")}


@pytest.mark.parametrize("arm", list(ARMS))
def test_int8_scheduler_matches_jax_and_static(arm, monkeypatch):
    """Greedy, fp32, int8 weights: the port's scheduler gives the JAX int8
    scheduler's tokens and its own static generate's, with a pool small
    enough that a request is preempted and resumed; every decode step of
    the arm takes its int8 grouped form."""
    max_seqs, kv = ARMS[arm]
    jm, jeng, pm, peng = _engines(kv)
    L = pm.config.num_layers
    scfg = dict(block_size=8, num_blocks=14, max_num_seqs=max_seqs,
                max_num_batched_tokens=256)
    prompts, max_new, prio = _prompts(), (8, 6, 10, 7), (1, 0, 0, 1)
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**scfg),
                      kv_cache_dtype=kv)
    jr = [js.submit(p, JaxSampling(max_new_tokens=n), priority=pr)
          for p, n, pr in zip(prompts, max_new, prio)]
    js.run_until_idle()
    counts = _Counts(monkeypatch)
    ps = ContinuousBatchingScheduler(pm, peng.params, ServingConfig(**scfg),
                                     kv_cache_dtype=kv)
    pr_ = [ps.submit(p, SamplingParams(max_new_tokens=n), priority=pr)
           for p, n, pr in zip(prompts, max_new, prio)]
    ps.run_until_idle()
    n = counts.take()
    c = ps.metrics.counters
    assert c["preemptions"] >= 1
    assert c["preemptions"] == js.metrics.counters["preemptions"]
    # decode: every step's 3 L expert products in the arm's int8 form, 5 L
    # qgemm; prefill dequantizes the layer (the float forms), no qgemm
    slot_arm = 2 * max_seqs <= gg.SLOT_MAX_ROWS
    steps, prefills = c["decode_steps"], c["prefills"]
    assert n["slot_q"] == (3 * L * steps if slot_arm else 0)
    assert n["group_q"] == (0 if slot_arm else 3 * L * steps)
    assert n["qgemm"] == 5 * L * steps
    assert n["slot"] + n["group"] == 3 * L * prefills
    for p, a, b in zip(prompts, jr, pr_):
        assert b.state == RequestState.FINISHED
        assert b.output_ids == a.output_ids
        ref = peng.generate(p[None], max_new_tokens=len(b.output_ids))
        assert b.output_ids == list(ref[0, p.size:])
    assert ps.block_mgr.num_allocated_blocks == 0


def test_server_cli_builds_an_int8_mixtral_scheduler():
    """``--model mixtral:tiny --int8-weights``: the quantizing device init
    at the preset's depth, an int8 pool, a request served through the int8
    grouped form, and the new kernels on /metrics."""
    argv = ["--model", "mixtral:tiny", "--int8-weights", "--dtype",
            "float32", "--device", "cpu", "--kv-cache-dtype", "int8"]
    sched = build_scheduler(build_parser().parse_args(argv))
    blocks = sched.params["blocks"]
    assert sched.model.config.num_layers == 2
    assert {p for p, v in _leaves(blocks)
            if isinstance(v, QuantizedTensor)} == QUANTIZED
    assert blocks["moe"]["w_in"].q.shape == (2, 4, 32, 64)
    assert sched.pool["k"].dtype == torch.int8
    req = sched.submit(np.arange(1, 9, dtype=np.int32),
                       SamplingParams(max_new_tokens=4))
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED and req.num_generated == 4
    text = sched.render_metrics()
    for k in ("ds_ggemm_q", "ds_ggemm_slots_q"):
        assert f'kernel_launches{{kernel="{k}"}}' in text
