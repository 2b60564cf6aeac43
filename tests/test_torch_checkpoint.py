"""Checkpoints and fp16 loss scaling in the port's training engine,
against the JAX package.

- Resume identity (port alone, CPU): fp32, fp16 and the bf16 byte diet;
  ``save_checkpoint`` after 2 steps (async in the diet run), a fresh
  engine ``load_checkpoint``s it and takes 2 more steps: losses, loss
  scales, skipped steps and params bit-identical to the uninterrupted
  run.
- The crash-safe protocol: a torn ``latest`` and a truncated newest tag
  fall back to the previous valid tag; a requested tag that fails
  verification raises; ``resilience.verify_checkpoint="full"`` catches a
  same-size bit flip; ``keep_last_k`` retention; ``load_module_only``;
  nothing to restore gives ``(None, {})``; ``zero_to_fp32``'s output
  equals the saved params.
- Across packages, the JAX engine run in a subprocess of its own (its
  donated train steps and torch in one process have corrupted the heap
  before; tests/conftest.py):
  ``python tests/test_torch_checkpoint.py --ref out.npz <port_ckpt>
  <jax_ckpt_root>``.  The JAX engine with ``NpzCheckpointEngine`` saves
  an fp32 and a bf16-diet run after 2 steps and continues 2; the port
  loads each tag and continues on the same batches.  The port saves its
  fp32 run; the JAX engine loads it and continues.  And the fp16 engine
  against the JAX fp16 engine over 4 steps at ``initial_scale_power`` 20
  with hysteresis 1, which overflows the first two steps.

A loaded tag puts every leaf of the saved state into the engine as it
was saved: the port's state, flattened by the JAX keys, equals the JAX
package's npz leaf for leaf (dtype, shape and bytes).

Tolerances (tiny GPT-2, CPU; each limit beside the reading it was set
from): fp32 continuations <= 1e-5 relative on losses and 1e-5 abs on
params (summation order only, as tests/test_torch_train.py).  The
diet's continuation: losses <= 1e-4 relative; each leaf within
``DIET_ULPS`` bf16 ulps at the leaf's largest |value| of the JAX
continuation (reading: at most 6, mlp_in_b); the LayerNorm scales, which
at this learning rate move only through the Kahan compensation (an
update of ~1e-3 is below half a bf16 ulp at 1.0), with at most
``DIET_SCALE_SHARE`` of their elements apart (reading: none).  Both
limits are shown to bite: with the compensation zeroed after the load
16-31 % of the scales' elements part, and with the moments zeroed the
biases part by up to 178 ulps.  fp16: skipped steps, overflow flags and
loss scales exact, losses <= 2e-3 relative (fp16 compute on both
sides); params: every element within Adam's bound, 2 x the two applied
steps' learning rates; at most 0.1 % of a leaf's elements beyond 2e-4
abs (an element whose true gradient is near zero gets fp16 rounding
noise for a gradient on either side, and Adam normalises that noise to
a step of ~lr: 10 of qkv_w's 24,576 elements moved 9e-4 apart in the
reading); and a leaf's 99.9th percentile within ``FP16_P999`` (reading:
at most 4.8e-5, qkv_w).  The key bias's K third, whose gradient is
analytically zero (noise on either side), is held to Adam's bound
alone, as in tests/test_torch_train.py.
"""
import json
import os
import subprocess
import sys

import numpy as np

MODEL = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=4,
             d_model=64)
MICRO, GAS, S, LR = 2, 2, 32, 1e-3
MODES = {
    "fp32": dict(dtype="float32", extra={}),
    "fp16": dict(dtype="float16", extra={
        "fp16": {"enabled": True, "initial_scale_power": 20,
                 "hysteresis": 1}}),
    "diet": dict(dtype="bfloat16", extra={
        "bf16": {"enabled": True, "master_weights_dtype": "bfloat16",
                 "optimizer_states_dtype": "bfloat16"},
        "data_types": {"grad_accum_dtype": "bf16"}}),
}
#: the JAX runs that save a checkpoint after SAVE_AT steps
SAVED = ("fp32", "diet")
SAVE_AT, STEPS = 2, 4
#: the diet's continuation: bf16 ulps at a leaf's largest |value|, and
#: the share of a LayerNorm scale's elements that may differ (module
#: docstring: the readings)
DIET_ULPS, DIET_SCALE_SHARE = 8, 0.02
#: the fp16 run's params: a leaf's 99.9th percentile of |port - JAX|
FP16_P999 = 1e-4


def engine_config(mode: str, **extra) -> dict:
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": LR, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 3}},
           "gradient_clipping": 1.0,
           "steps_per_print": 0}
    cfg.update(MODES[mode]["extra"])
    cfg.update(extra)
    return cfg


def step_batches(seed: int = 7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, MODEL["vocab_size"],
                                       (GAS, MICRO, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _jax_reference(out_path: str, port_ckpt: str, jax_root: str) -> int:
    """The JAX engine's runs -> ``out_path``; its checkpoints under
    ``jax_root/<mode>``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    # the suite's persistent compilation cache (tests/conftest.py): the
    # four engines compile the same few programs
    jax.config.update("jax_compilation_cache_dir",
                      "/tmp/ds_tpu_test_jax_cache")
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import gpt2_model, numpy_init_params
    from deepspeed_tpu.runtime.checkpoint_engine.engine import \
        NpzCheckpointEngine
    res = {}

    def engine(mode):
        jm = gpt2_model("custom", dtype=MODES[mode]["dtype"], remat=True,
                        attention_impl="xla", **MODEL)
        eng, *_ = deepspeed_tpu.initialize(
            model=jm, config=engine_config(mode),
            model_parameters=numpy_init_params(jm.config, seed=0))
        eng.checkpoint_engine = NpzCheckpointEngine()
        return eng

    def record(eng, tag, batches):
        losses, scales, flags = [], [], []
        for b in batches:
            losses.append(float(eng.train_batch(batch=b)))
            scales.append(eng.loss_scale)
            flags.append(bool(np.asarray(eng.last_metrics.get("overflow",
                                                              False))))
        res[f"{tag}/loss"] = np.array(losses)
        res[f"{tag}/scale"] = np.array(scales)
        res[f"{tag}/overflow"] = np.array(flags)
        res[f"{tag}/skipped"] = np.array(eng.skipped_steps)
        params = jax.device_get(eng.state["params"])
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            name = "/".join(p.key for p in path)
            res[f"{tag}/param/{name}"] = np.asarray(leaf, np.float32)

    batches = step_batches()
    record(engine("fp16"), "fp16", batches)
    for mode in SAVED:
        eng = engine(mode)
        for b in batches[:SAVE_AT]:
            eng.train_batch(batch=b)
        eng.save_checkpoint(os.path.join(jax_root, mode))
        record(eng, f"{mode}/continued", batches[SAVE_AT:])
    eng = engine("fp32")
    path, _ = eng.load_checkpoint(port_ckpt)
    assert path is not None, "the JAX engine found no tag to load"
    record(eng, "from_port", batches[SAVE_AT:])
    np.savez(out_path, **res)
    return 0


if __name__ == "__main__":
    # the reference run, in a process without torch
    if sys.argv[1:2] != ["--ref"] or len(sys.argv) != 5:
        sys.exit("usage: python tests/test_torch_checkpoint.py --ref "
                 "out.npz <port_ckpt> <jax_ckpt_root>")
    sys.exit(_jax_reference(*sys.argv[2:]))

import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.checkpoint.jax_params import (  # noqa: E402
    gpt2_params_to_numpy, train_state_from_numpy, train_state_to_numpy)
from deepspeed_tpu_torch.models.gpt2 import gpt2_model  # noqa: E402
from deepspeed_tpu_torch.resilience import ckpt as rckpt  # noqa: E402
from deepspeed_tpu_torch.utils import zero_to_fp32  # noqa: E402
from deepspeed_tpu_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(mode, **extra):
    pm = gpt2_model("custom", dtype=MODES[mode]["dtype"], remat=True,
                    **MODEL)
    eng, *_ = dt.initialize(model=pm, config=engine_config(mode, **extra),
                            model_parameters=pm.numpy_init_fn(0),
                            device="cpu")
    return eng


def _run(eng, batches):
    out = {"loss": [], "scale": [], "skipped": None}
    for b in batches:
        out["loss"].append(float(eng.train_batch(batch=b)))
        out["scale"].append(eng.loss_scale)
    out["skipped"] = eng.skipped_steps
    return out


def _params(eng):
    return [p.detach().clone() for p in tree_leaves(eng.params)]


def _flat_params(eng):
    out = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                out[pre + k] = np.asarray(v, np.float32)
    walk(gpt2_params_to_numpy(eng.params), "")
    return out


# ------------------------------------------------------ resume identity
@pytest.mark.parametrize("mode", ["fp32", "fp16", "diet"])
def test_resume_is_bit_identical(mode, tmp_path):
    batches = step_batches()
    extra = {"checkpoint": {"async_save": True}} if mode == "diet" else {}
    a = _engine(mode, **extra)
    _run(a, batches[:SAVE_AT])
    a.save_checkpoint(str(tmp_path))
    tail = _run(a, batches[SAVE_AT:])
    a.wait_pending_checkpoint()
    b = _engine(mode, **extra)
    path, client = b.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / f"global_step{SAVE_AT}") and client == {}
    assert b.global_steps == SAVE_AT
    resumed = _run(b, batches[SAVE_AT:])
    assert resumed == tail
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(b)))
    if mode == "fp16":   # the scaler crossed: its first steps overflowed
        assert tail["skipped"] == b.skipped_steps and b.skipped_steps >= 1
    assert sorted(os.listdir(tmp_path)) == [f"global_step{SAVE_AT}",
                                            "latest"]


def test_fallback_retention_and_module_only(tmp_path):
    batches = step_batches()
    eng = _engine("fp32", resilience={"keep_last_k": 2})
    saved = {}
    for i, b in enumerate(batches):
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(tmp_path), client_state={"i": i})
        saved[eng.global_steps] = _params(eng)
    # keep_last_k: only the two newest valid tags stay
    assert rckpt.list_tags(str(tmp_path)) == ["global_step3",
                                              "global_step4"]
    # a torn `latest` and a truncated newest tag: the previous tag loads
    (tmp_path / "latest").write_bytes(b"glob")
    npz = tmp_path / "global_step4" / "state.npz"
    npz.write_bytes(npz.read_bytes()[:100])
    fresh = _engine("fp32")
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {"i": 2}
    assert fresh.global_steps == 3
    assert all(torch.equal(x, y) for x, y in zip(_params(fresh),
                                                 saved[3]))
    # asking for the broken tag by name raises
    with pytest.raises(rckpt.CheckpointCorruptError, match="global_step4"):
        _engine("fp32").load_checkpoint(str(tmp_path), tag="global_step4")
    # load_module_only: the params, not the optimizer state
    mod = _engine("fp32")
    mod.load_checkpoint(str(tmp_path), load_module_only=True)
    assert all(torch.equal(x, y) for x, y in zip(_params(mod), saved[3]))
    assert mod.opt_state[1].count == 0 and mod.global_steps == 3
    # an empty root: nothing to restore
    assert _engine("fp32").load_checkpoint(str(tmp_path / "none")) == \
        (None, {})


def test_full_verification_catches_a_bit_flip(tmp_path):
    eng = _engine("fp32", resilience={"verify_checkpoint": "full"})
    eng.train_batch(batch=step_batches()[0])
    eng.save_checkpoint(str(tmp_path))
    npz = tmp_path / "global_step1" / "state.npz"
    size = npz.stat().st_size
    # one element changed and the file written again: a valid npz of the
    # same size, so the manifest's structural check holds
    with np.load(npz) as z:
        flat = dict(z)
    flat["params/wte"] = flat["params/wte"].copy()
    flat["params/wte"][0, 0] += 1.0
    np.savez(npz, **flat)
    assert npz.stat().st_size == size
    assert rckpt.verify_tag(str(tmp_path / "global_step1"))[0]
    with pytest.raises(rckpt.CheckpointCorruptError, match="checksum"):
        _engine("fp32", resilience={"verify_checkpoint": "full"}) \
            .load_checkpoint(str(tmp_path))
    # a flipped byte inside the file: the zip's own CRC refuses it
    data = bytearray(npz.read_bytes())
    data[size // 2] ^= 0x40
    npz.write_bytes(bytes(data))
    with pytest.raises(rckpt.CheckpointCorruptError, match="unreadable"):
        _engine("fp32").load_checkpoint(str(tmp_path))


@pytest.mark.parametrize("mode", ["fp32", "diet"])
def test_zero_to_fp32_matches_saved_params(mode, tmp_path):
    eng = _engine(mode)
    eng.train_batch(batch=step_batches()[0])
    eng.save_checkpoint(str(tmp_path / "ck"))
    out = tmp_path / "fp32.npz"
    assert zero_to_fp32.main([str(tmp_path / "ck"), str(out)]) == 0
    got = dict(np.load(out))
    want = _flat_params(eng)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_state_layout_round_trips_through_numpy():
    """train_state_to_numpy / train_state_from_numpy carry params,
    moments, counts and the scaler exactly, bf16 leaves as V2 words."""
    a = _engine("diet")
    a.train_batch(batch=step_batches()[0])
    flat = train_state_to_numpy(a)
    assert flat["opt_state/[1]/.count"] == 1 and flat["step"] == 1
    assert flat["params/wte"].dtype == np.dtype("V2")
    b = _engine("diet")
    train_state_from_numpy(b, flat)
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(b)))
    assert b.opt_state[1].count == 1
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a.opt_state[1].comp), tree_leaves(b.opt_state[1].comp)))


# ------------------------------------------------------- across packages
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    base = tmp_path_factory.mktemp("xpkg")
    batches = step_batches()
    port = _engine("fp32")
    _run(port, batches[:SAVE_AT])
    port.save_checkpoint(str(base / "port"))
    cont = _run(port, batches[SAVE_AT:])
    out = base / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run(
        [sys.executable, "tests/test_torch_checkpoint.py", "--ref", str(out),
         str(base / "port"), str(base / "jax")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"ref": dict(np.load(out)), "jax_root": base / "jax",
            "port_continued": cont, "port_params": _flat_params(port)}


def _assert_params(ref, tag, got, atol):
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[f"{tag}/param/{k}"], atol=atol,
                                   rtol=0, err_msg=k)


def _no_key_bias(k, a):
    """``a`` without the key bias's K third (its gradient is zero)."""
    if k != "blocks/qkv_b":
        return a
    D = MODEL["d_model"]
    return np.concatenate([a[..., :D], a[..., 2 * D:]], -1)


def _diet_apart(ref, got):
    """The diet's leaves beyond its limits against the JAX continuation:
    {leaf: (ulps at its largest |value|, share of elements apart)}."""
    out = {}
    for k, v in got.items():
        want = _no_key_bias(k, ref[f"diet/continued/param/{k}"])
        v = _no_key_bias(k, v)
        ulp = np.spacing(np.abs(want).max().astype(np.float32)) * 2.0 ** 16
        ulps = float(np.abs(v - want).max() / ulp)
        share = float(np.mean(v != want))
        if ulps > DIET_ULPS or ("scale" in k and share > DIET_SCALE_SHARE):
            out[k] = (ulps, share)
    return out


def _continue_jax_tag(reference, mode, fault=None):
    """A fresh port engine loads the JAX engine's tag and takes the
    remaining steps.  ``fault``: a planted one, the Kahan compensation
    ("comp") or the moments ("moments") zeroed after the load."""
    root = reference["jax_root"] / mode
    eng = _engine(mode)
    path, _ = eng.load_checkpoint(str(root))
    assert path is not None
    st = eng.opt_state[1]
    planted = {None: [], "comp": tree_leaves(st.comp),
               "moments": tree_leaves(st.mu) + tree_leaves(st.nu)}[fault]
    for t in planted:
        t.zero_()
    return eng, _run(eng, step_batches()[SAVE_AT:])


def test_fp16_engine_matches_jax(reference):
    ref = reference["ref"]
    eng = _engine("fp16")
    got = _run(eng, step_batches())
    flags = [bool(x) for x in ref["fp16/overflow"]]
    assert flags == [True, True, False, False]      # the case overflows
    assert got["skipped"] == int(ref["fp16/skipped"]) == 2
    assert got["scale"] == [float(x) for x in ref["fp16/scale"]]
    np.testing.assert_allclose(got["loss"], ref["fp16/loss"], rtol=2e-3)
    D = MODEL["d_model"]
    for k, v in _flat_params(eng).items():
        diff = np.abs(v - ref[f"fp16/param/{k}"])
        assert diff.max() <= 2 * 2 * LR, k
        diff = _no_key_bias(k, diff)    # the key bias: Adam's bound only
        assert np.mean(diff > 2e-4) <= 1e-3, (k, np.mean(diff > 2e-4))
        assert np.percentile(diff, 99.9) <= FP16_P999, k


@pytest.mark.parametrize("mode", SAVED)
def test_jax_checkpoint_continues_in_port(reference, mode):
    ref = reference["ref"]
    tag = reference["jax_root"] / mode / f"global_step{SAVE_AT}"
    meta = json.loads((tag / "ds_metadata.json").read_text())
    # every saved leaf lands as the JAX package wrote it
    eng = _engine(mode)
    eng.load_checkpoint(str(tag.parent))
    assert eng.global_steps == meta["global_steps"]
    with np.load(tag / "state.npz") as z:
        saved = dict(z)
    loaded = train_state_to_numpy(eng)
    assert sorted(loaded) == sorted(saved)
    for k, v in saved.items():
        assert (loaded[k].dtype, loaded[k].shape) == (v.dtype, v.shape), k
        assert loaded[k].tobytes() == v.tobytes(), k
    eng, got = _continue_jax_tag(reference, mode)
    rtol = 1e-5 if mode == "fp32" else 1e-4
    np.testing.assert_allclose(got["loss"], ref[f"{mode}/continued/loss"],
                               rtol=rtol)
    if mode == "fp32":
        _assert_params(ref, "fp32/continued", _flat_params(eng), atol=1e-5)
        return
    assert _diet_apart(ref, _flat_params(eng)) == {}
    # the limits catch a load that dropped the compensation or the moments
    for fault in ("comp", "moments"):
        eng, _ = _continue_jax_tag(reference, mode, fault)
        assert _diet_apart(ref, _flat_params(eng)), fault


def test_port_checkpoint_continues_in_jax(reference):
    ref = reference["ref"]
    np.testing.assert_allclose(ref["from_port/loss"],
                               reference["port_continued"]["loss"],
                               rtol=1e-5)
    _assert_params(ref, "from_port", reference["port_params"], atol=1e-5)
