"""deepspeed_tpu_torch training vs the JAX package.

- Model level, in-process (no donated train step): a tiny GPT-2 (2
  layers, d 64, vocab 128, S 32) gives the reference's loss and gradients
  (``jax.value_and_grad(model.loss)``) for plain, ``attention_mask`` and
  ``segment_ids`` batches; remat on and off agree.
- Engine level: ``initialize`` -> ``train_batch`` over 4 steps with gas 2,
  WarmupLR and gradient clipping, in fp32 and in the bf16 byte diet
  (Kahan bf16 masters, bf16 moments, bf16 gradient accumulation), against
  the JAX engine run in a subprocess of its own (the JAX engine's donated
  train steps and torch in one process have corrupted the heap before;
  see tests/conftest.py), which writes its losses and final params to an
  .npz:  ``python tests/test_torch_train.py --ref out.npz``.
- The micro API, the data loader paths, the refusals of every unported
  config section and the device rules of the entry points.

Tolerances: model loss <= 1e-6 relative and grads <= 1e-5 abs (fp32, summation
order only).  Engine fp32: losses <= 1e-5 relative and params <= 1e-5
abs after 4 steps — Adam normalises each update to ~lr, so gradient
differences of 1e-6 relative move params by far less than lr = 1e-3.
Engine bf16 diet: limits set between readings of the port and of two
faulty controls (tiny GPT-2 above, CPU):

=====================  ==================  ==============================
run                    loss, max rel err   max |port - JAX| / |JAX - init|
=====================  ==================  ==============================
the port's diet        2.9e-5              0.22 (lnf_scale), <= 0.037 else
Kahan residual zeroed  3.3e-5              1.0 (every LayerNorm scale)
micro-batch dropped    1.1e-3              >= 0.85 on every leaf
=====================  ==================  ==============================

so losses <= 1e-4 relative and each leaf's difference <= 0.5 of its
movement from the init (the LayerNorm scales move less than one bf16
ulp in 4 steps and live on their Kahan residual; one ulp flipped on a
few elements is the port's 0.22).  ``test_diet_limits_catch_faults``
runs both controls and holds them outside the limits.  The key bias,
whose gradient is rounding noise, is held only to Adam's bound of
2 x the summed learning rates.
"""
import os
import subprocess
import sys

import numpy as np

MODEL = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=4,
             d_model=64)
MICRO, GAS, STEPS, S = 2, 2, 4, 32
LR = 1e-3
MODES = {
    "fp32": dict(dtype="float32", extra={}),
    "diet": dict(dtype="bfloat16", extra={
        "bf16": {"enabled": True, "master_weights_dtype": "bfloat16",
                 "optimizer_states_dtype": "bfloat16"},
        "data_types": {"grad_accum_dtype": "bf16"}}),
}


def engine_config(mode: str) -> dict:
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": LR, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 3}},
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": 2},
           "steps_per_print": 0}
    cfg.update(MODES[mode]["extra"])
    return cfg


def step_batches(seed: int = 7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, MODEL["vocab_size"],
                                       (GAS, MICRO, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _jax_reference(out_path: str) -> int:
    """The JAX engine's trajectories for every mode -> ``out_path``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import gpt2_model, numpy_init_params
    res = {}
    for mode, spec in MODES.items():
        jm = gpt2_model("custom", dtype=spec["dtype"], remat=True,
                        attention_impl="xla", **MODEL)
        eng, *_ = deepspeed_tpu.initialize(
            model=jm, config=engine_config(mode),
            model_parameters=numpy_init_params(jm.config, seed=0))
        losses, norms = [], []
        for b in step_batches():
            losses.append(float(eng.train_batch(batch=b)))
            norms.append(eng.get_global_grad_norm())
        res[f"{mode}/loss"] = np.array(losses)
        res[f"{mode}/grad_norm"] = np.array(norms)
        params = jax.device_get(eng.state["params"])
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            name = "/".join(p.key for p in path)
            res[f"{mode}/param/{name}"] = np.asarray(leaf, np.float32)
    np.savez(out_path, **res)
    return 0


if __name__ == "__main__":
    # the reference run, in a process without torch
    if sys.argv[1:2] != ["--ref"] or len(sys.argv) != 3:
        sys.exit("usage: python tests/test_torch_train.py --ref out.npz")
    sys.exit(_jax_reference(sys.argv[2]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import gpt2 as gpt2_jax  # noqa: E402
from deepspeed_tpu_torch.checkpoint.jax_params import (  # noqa: E402
    gpt2_params_from_numpy, gpt2_params_to_numpy)
from deepspeed_tpu_torch.models import gpt2 as gpt2_port  # noqa: E402
from deepspeed_tpu_torch.utils.tree import (  # noqa: E402
    tree_leaves, tree_map)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_model(dtype="float32", **over):
    return gpt2_port.gpt2_model("custom", dtype=dtype, **{**MODEL, **over})


def _init_np(seed=0):
    return gpt2_port.numpy_init_params(gpt2_port.GPT2Config(**MODEL), seed)


def _port_engine(mode, **kw):
    pm = _port_model(MODES[mode]["dtype"], remat=True)
    eng, *_ = dt.initialize(model=pm, config=engine_config(mode),
                            model_parameters=_init_np(), device="cpu", **kw)
    return eng


# ------------------------------------------------------------------ model
def _model_batch(kind, seed=3):
    rng = np.random.default_rng(seed)
    b = {"input_ids": rng.integers(0, MODEL["vocab_size"],
                                   (2, S)).astype(np.int32)}
    if kind == "mask":
        m = np.ones((2, S), np.int32)
        m[0, 20:] = 0
        m[1, 9:] = 0
        b["attention_mask"] = m
    if kind == "segments":
        seg = np.zeros((2, S), np.int32)
        seg[:, :12] = 1
        seg[:, 12:25] = 2
        b["segment_ids"] = seg
    return b


@pytest.mark.parametrize("kind", ["plain", "mask", "segments"])
def test_model_loss_and_grads_match_jax(kind):
    batch = _model_batch(kind)
    jm = gpt2_jax.gpt2_model("custom", dtype="float32",
                             attention_impl="xla", **MODEL)
    params = _init_np()
    loss_j, grads_j = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    pm = _port_model()
    pt = gpt2_params_from_numpy(params, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_(True)
    loss = pm.loss(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(pt))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-6)
    ref = gpt2_params_to_numpy(zip_tree(pt, grads))
    for path, g in jax.tree_util.tree_leaves_with_path(grads_j):
        node = ref
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(g), atol=1e-5, rtol=0,
                                   err_msg=str(path))


def zip_tree(params, flat):
    """The params tree's structure with ``flat`` as its leaves."""
    it = iter(flat)
    return {k: ({kk: next(it) for kk in v} if isinstance(v, dict)
                else next(it)) for k, v in params.items()}


def test_remat_matches_no_remat_and_counts_params():
    batch = {k: torch.from_numpy(v)
             for k, v in _model_batch("segments").items()}
    out = []
    for remat in (False, True):
        pt = gpt2_params_from_numpy(_init_np(), "cpu")
        for p in tree_leaves(pt):
            p.requires_grad_(True)
        loss = _port_model(remat=remat).loss(pt, batch)
        out.append([loss] + list(torch.autograd.grad(loss,
                                                     tree_leaves(pt))))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for size in ("760m", "125m"):
        ref = gpt2_jax.gpt2_model(size)
        got = gpt2_port.gpt2_model(size)
        assert got.meta["n_params"] == ref.meta["n_params"]
        assert got.flops_per_token == ref.flops_per_token
    assert gpt2_port.gpt2_model("760m").meta["n_params"] == 758_727_168


def test_unported_remat_policies_are_refused():
    with pytest.raises(NotImplementedError, match="remat policies"):
        _port_model(remat=True, remat_policy="save_attn")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _port_model(remat=True, remat_policy="sometimes")
    _port_model(remat=False, remat_policy="dots")   # unused without remat


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    # one device: the test harness's flags give every process eight
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "tests/test_torch_train.py",
                           "--ref", str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


#: bf16 diet limits (readings in the module docstring)
DIET_LOSS_RTOL = 1e-4
DIET_PARAM_RATIO = 0.5


def _train(mode, control=None):
    """The port's trajectory over ``step_batches``; ``control`` injects a
    fault: "no_kahan" zeroes the Kahan residual after every step,
    "drop_micro" loses the second micro-batch's gradients."""
    eng = _port_engine(mode)
    if control == "drop_micro":
        eng._add = lambda acc, g: g if acc is None else acc
    losses, norms = [], []
    for b in step_batches():
        losses.append(float(eng.train_batch(batch=b)))
        norms.append(eng.get_global_grad_norm())
        if control == "no_kahan":
            clip, adam = eng.opt_state
            eng.opt_state = (clip, adam._replace(
                comp=tree_map(torch.zeros_like, adam.comp)))
    return eng, np.array(losses), norms


def _leaf_gaps(reference, mode, params):
    """{leaf: |port - JAX| / |JAX - init|}, the key bias left out, and
    the key bias's largest absolute difference."""
    init, d = _init_np(), MODEL["d_model"]
    keep = [*range(d), *range(2 * d, 3 * d)]
    gaps, kbias = {}, None
    for key, want in reference.items():
        if not key.startswith(f"{mode}/param/"):
            continue
        path = key.split("/")[2:]
        node, p0 = params, init
        for p in path:
            node, p0 = node[p], p0[p]
        node, want, p0 = (np.asarray(x, np.float64) for x in (node, want,
                                                              p0))
        if path[-1] == "qkv_b":
            kbias = np.abs(node[:, d:2 * d] - want[:, d:2 * d]).max()
            node, want, p0 = node[:, keep], want[:, keep], p0[:, keep]
        gaps["/".join(path)] = (np.linalg.norm(node - want)
                                / np.linalg.norm(want - p0))
    return gaps, kbias


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_trajectory_matches_jax_engine(reference, mode):
    eng, losses, norms = _train(mode)
    assert eng.global_steps == STEPS
    ref_loss = reference[f"{mode}/loss"]
    params = gpt2_params_to_numpy(eng.params)
    assert params["wte"].shape == reference[f"{mode}/param/wte"].shape
    if mode == "diet":
        np.testing.assert_allclose(losses, ref_loss, rtol=DIET_LOSS_RTOL)
        gaps, kbias = _leaf_gaps(reference, mode, params)
        assert max(gaps.values()) <= DIET_PARAM_RATIO, gaps
        # the key bias has an analytically zero gradient (a shift of
        # every key's score by a per-query constant): in bf16 its
        # gradient is rounding noise on both sides and Adam turns noise
        # into +-lr steps, so only Adam's own bound holds there
        assert kbias <= 2 * sum(eng.lr_schedule(t)
                                for t in range(STEPS)) * 1.01
        return
    np.testing.assert_allclose(losses, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(norms, reference[f"{mode}/grad_norm"],
                               rtol=1e-4)
    for key, want in reference.items():
        if not key.startswith(f"{mode}/param/"):
            continue
        node = params
        for p in key.split("/")[2:]:
            node = node[p]
        np.testing.assert_allclose(node, want, atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("control", ["no_kahan", "drop_micro"])
def test_diet_limits_catch_faults(reference, control):
    """The bf16-diet limits reject a trajectory with the Kahan residual
    dropped or with one micro-batch's gradients lost."""
    eng, losses, _ = _train("diet", control)
    gaps, _ = _leaf_gaps(reference, "diet",
                         gpt2_params_to_numpy(eng.params))
    loss_err = np.max(np.abs(losses - reference["diet/loss"])
                      / np.abs(reference["diet/loss"]))
    assert max(gaps.values()) > DIET_PARAM_RATIO, gaps
    if control == "drop_micro":
        assert loss_err > DIET_LOSS_RTOL


def test_micro_api_equals_train_batch():
    a, b = _port_engine("fp32"), _port_engine("fp32")
    for batch in step_batches()[:2]:
        la = a.train_batch(batch=batch)
        for i in range(GAS):
            lb = b.forward({k: v[i] for k, v in batch.items()})
            b.backward(lb)
            b.step()
        assert a.global_steps == b.global_steps
        # the micro API reports the last micro-batch's loss, train_batch
        # the mean over the step (as the reference)
        assert float(b.last_metrics["loss"]) == float(lb)
        assert np.isfinite(float(la))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.get_lr() == b.get_lr()
    assert a.get_global_grad_norm() == pytest.approx(
        b.get_global_grad_norm(), rel=1e-6)


def test_data_loader_paths_match_explicit_batches():
    batches = step_batches()[:2]
    micro = [{k: v[i] for k, v in b.items()} for b in batches
             for i in range(GAS)]
    dataset = [{"input_ids": row} for mb in micro for row in mb["input_ids"]]
    ref = _port_engine("fp32")
    want = [float(ref.train_batch(batch=b)) for b in batches]
    eng = _port_engine("fp32", training_data=dataset)
    assert eng.training_dataloader is not None
    assert len(eng.training_dataloader) == len(dataset) // MICRO
    assert [float(eng.train_batch()) for _ in batches] == want
    it_eng = _port_engine("fp32")
    assert [float(it_eng.train_batch(data_iter=micro))
            for _ in batches] == want
    with pytest.raises(ValueError, match="lead with gas"):
        it_eng.train_batch(batch={"input_ids": micro[0]["input_ids"][None]})


@pytest.mark.parametrize("section", [
    # fp16 trains since the fp16 slice; fault injection is still refused
    {"resilience": {"faults": "ckpt.save:deny@0"}},
    {"zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
    {"zero_optimization": {"stage": 1, "cpu_offload": True}},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
    {"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
    {"mesh": {"model_parallel_size": 2}},
    {"mesh": {"data_parallel_size": 2}},
    {"compression_training": {"weight_quantization": {
        "shared_parameters": {"enabled": True}}}},
    {"curriculum_learning": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True}},
    {"data_efficiency": {"enabled": True}},
    {"optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}},
])
def test_unported_sections_are_refused(section):
    cfg = {**engine_config("fp32"), **section}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dt.initialize(model=_port_model(), config=cfg, device="cpu")


def test_config_rules_and_entry_points():
    base = engine_config("fp32")
    # the reference's precision rules
    for extra in ({"bf16": {"master_weights_dtype": "bfloat16"}},
                  {"bf16": {"optimizer_states_dtype": "bfloat16"}},
                  {"data_types": {"grad_accum_dtype": "bf16"}},
                  {"data_types": {"grad_accum_dtype": "fp16"}},
                  {"train_batch_size": 5}):
        with pytest.raises(ValueError):
            dt.initialize(model=_port_model(), config={**base, **extra},
                          device="cpu")
    from deepspeed_tpu_torch.runtime.bf16_optimizer import mp_adamw
    with pytest.raises(ValueError, match="user-provided optimizer"):
        dt.initialize(model=_port_model(), optimizer=mp_adamw(1e-3),
                      config={**base, **MODES["diet"]["extra"]},
                      device="cpu")
    for kw in ({"mesh": object()}, {"mpu": object()},
               {"dist_init_required": True}):
        with pytest.raises(NotImplementedError, match="one device"):
            dt.initialize(model=_port_model(), config=base, device="cpu",
                          **kw)
    eng, opt, loader, sched = dt.initialize(
        model=_port_model(), config=base, optimizer=mp_adamw(1e-3),
        model_parameters=gpt2_params_from_numpy(_init_np(), "cpu"),
        device="cpu")
    assert loader is None and sched is not None and opt is eng.optimizer
    assert eng.train_batch_size() == MICRO * GAS
    assert eng.train_micro_batch_size_per_gpu() == MICRO
    assert eng.gradient_accumulation_steps() == GAS
    assert eng.get_lr() == [pytest.approx(LR * np.log(1 / 3 * (np.e - 1)
                                                      + 1))]
    mb = {k: v[0] for k, v in step_batches()[0].items()}
    assert float(eng.eval_batch(mb)) == pytest.approx(
        float(eng.forward(mb)), rel=1e-6)


def test_entry_points_refuse_cpu_unless_asked():
    """No GPU here: ``initialize``, ``Model.init`` and
    ``gpt2_params_from_numpy`` raise unless ``device="cpu"`` is given
    (``t.to(None)`` would silently keep CPU tensors on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    pm = _port_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.initialize(model=pm, config=engine_config("fp32"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt2_params_from_numpy(_init_np())
    assert pm.init(0, "cpu")["wte"].device.type == "cpu"
    assert gpt2_params_from_numpy(_init_np(), "cpu")["wte"].device.type \
        == "cpu"
    eng, *_ = dt.initialize(model=pm, config=engine_config("fp32"),
                            device="cpu")
    assert eng.params["wte"].device.type == "cpu"


def test_training_leaves_the_callers_arrays_alone():
    """The engine updates its params in place; params built from the
    caller's numpy tree must not alias it (on the CPU ``torch.from_numpy``
    would share the memory)."""
    tree = _init_np()
    before = {k: v.copy() for k, v in tree["blocks"].items()}
    eng, *_ = dt.initialize(model=_port_model(), config=engine_config(
        "fp32"), model_parameters=tree, device="cpu")
    eng.train_batch(batch=step_batches()[0])
    for k, v in tree["blocks"].items():
        np.testing.assert_array_equal(v, before[k])
    assert not np.array_equal(
        gpt2_params_to_numpy(eng.params)["blocks"]["qkv_w"],
        before["qkv_w"])


def test_params_round_trip_through_numpy():
    tree = _init_np(3)
    back = gpt2_params_to_numpy(gpt2_params_from_numpy(tree, "cpu"))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
