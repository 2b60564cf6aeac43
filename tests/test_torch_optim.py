"""deepspeed_tpu_torch optimizers and LR schedules vs the JAX package.

The port's ``mp_adamw`` (fp32 masters and states, bf16 moments, Kahan
bf16 masters), ``build_optimizer``'s Adam family (the same ``mp_adamw``,
held to optax's ``adam`` / ``adamw``), ``clip_by_global_norm`` and the
five LR schedules run on the same seeded numpy leaves / steps as the JAX
package's.

Tolerances: fp32 paths <= 1e-6 relative (the same formulas; scalar powers
and schedule values are taken in a different order or precision); bf16
states and Kahan masters <= 1 bf16 ulp (2^-7 relative: an fp32 value one
ulp apart on the two sides may round to neighbouring bf16 values).
Schedules: 1e-6 relative or 1e-9 absolute — the reference evaluates them
in fp32, a few fp32 ulps of the 1e-2 peak learning rate.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from deepspeed_tpu.runtime import bf16_optimizer as bo_jax
from deepspeed_tpu.runtime import lr_schedules as lrs_jax
from deepspeed_tpu.runtime import optimizers as opt_jax
from deepspeed_tpu_torch.runtime import bf16_optimizer as bo
from deepspeed_tpu_torch.runtime import lr_schedules as lrs
from deepspeed_tpu_torch.runtime import optimizers as opt
from deepspeed_tpu_torch.utils.tree import tree_map

BF16_RTOL = 2.0 ** -7
STEPS = 5


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": draw((8, 16)), "b": draw((16,)),
            "blocks": {"s": draw((3, 5))}}


def _run_jax(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        g = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, params)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _run_port(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        g = tree_map(lambda a, p: torch.from_numpy(a).to(p.dtype), g, params)
        upd, state = tx.update(g, state, params)
        params = tree_map(lambda p, u: (p + u).to(p.dtype), params, upd)
    return params, state


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_tree_close(got, want, rtol, atol=0.0):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol,
                                   err_msg=str(path))


MP_MODES = {
    "fp32": dict(),
    "bf16_moments": dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
    "kahan_bf16_master": dict(mu_dtype="bfloat16", nu_dtype="bfloat16",
                              master_dtype="bfloat16"),
}


@pytest.mark.parametrize("mode", sorted(MP_MODES))
@pytest.mark.parametrize("scheduled", [False, True])
def test_mp_adamw_matches_reference(mode, scheduled):
    kw = MP_MODES[mode]
    master = kw.get("master_dtype", "float32")
    sched = dict(warmup_max_lr=1e-2, warmup_num_steps=3)
    lr_j = lrs_jax.warmup_lr(**sched) if scheduled else 1e-2
    lr_t = lrs.warmup_lr(**sched) if scheduled else 1e-2
    p0 = _leaves(0)
    grads = [_leaves(10 + i, scale=0.1) for i in range(STEPS)]
    pj, sj = _run_jax(bo_jax.mp_adamw(lr_j, weight_decay=0.01, **kw),
                      jax.tree.map(lambda a: jnp.asarray(a, master), p0),
                      grads)
    pt, st = _run_port(bo.mp_adamw(lr_t, weight_decay=0.01, **kw),
                       tree_map(lambda a: torch.from_numpy(a).to(
                           bo.resolve_dtype(master)), p0), grads)
    fp32 = mode == "fp32"
    rtol = 1e-6 if fp32 else BF16_RTOL
    _assert_tree_close(pt, pj, rtol=rtol, atol=1e-7)
    _assert_tree_close(st.mu, sj.mu, rtol=rtol, atol=1e-7)
    _assert_tree_close(st.nu, sj.nu, rtol=rtol, atol=1e-9)
    assert st.count == int(sj.count) == STEPS
    if master == "bfloat16":
        # the Kahan residual (what the bf16 apply dropped) is the same on
        # both sides; atol: residuals are themselves ~1 ulp of the weights
        _assert_tree_close(st.comp, sj.comp, rtol=BF16_RTOL, atol=1e-6)
        assert any(float(c.float().abs().max()) > 0
                   for c in jax.tree.leaves(st.comp))


def test_kahan_master_accumulates_updates_below_one_ulp():
    """An update far below one bf16 ulp of the weight is lost by a plain
    bf16 master and kept by the compensated one, as in the reference."""
    p0 = {"w": np.ones((4,), np.float32)}
    grads = [{"w": np.full((4,), 1.0, np.float32)} for _ in range(50)]
    lr = 1e-4    # |update| ~ 1e-4 << 2^-8 (one ulp of 1.0 in bf16)
    tx = bo.mp_adamw(lr, master_dtype="bfloat16")
    pt, _ = _run_port(tx, tree_map(lambda a: torch.from_numpy(a)
                                   .bfloat16(), p0), grads)
    plain, _ = _run_port(bo.mp_adamw(lr), tree_map(
        lambda a: torch.from_numpy(a).bfloat16(), p0), grads)
    assert float(plain["w"][0]) == 1.0          # every update rounded away
    assert float(pt["w"][0]) < 1.0              # the residual carried them
    pj, _ = _run_jax(bo_jax.mp_adamw(lr, master_dtype="bfloat16"),
                     jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  p0), grads)
    _assert_tree_close(pt, pj, rtol=BF16_RTOL)


@pytest.mark.parametrize("name,params", [
    ("adam", {"lr": 1e-2}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.99]}),
    ("fusedadam", {"lr": 1e-2, "weight_decay": 0.05}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.05, "adam_w_mode": False,
              "eps": 1e-6}),
])
def test_build_optimizer_adam_family_matches_optax(name, params):
    p0 = _leaves(1)
    grads = [_leaves(20 + i, scale=0.1) for i in range(STEPS)]
    pj, _ = _run_jax(opt_jax.build_optimizer(name, params),
                     jax.tree.map(jnp.asarray, p0), grads)
    pt, _ = _run_port(opt.build_optimizer(name, params),
                      tree_map(torch.from_numpy, p0), grads)
    _assert_tree_close(pt, pj, rtol=1e-6, atol=1e-7)


def test_build_optimizer_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        opt.build_optimizer("lamb", {"lr": 1e-3})
    with pytest.raises(ValueError, match="Unknown optimizer"):
        opt.build_optimizer("nosuch", {})
    with pytest.raises(ValueError, match="Adam-family"):
        opt.build_optimizer("sgd", {}, mu_dtype="bfloat16")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Both sides of the threshold: scaled when norm >= max_norm, left
    alone below it."""
    g = _leaves(5)
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        jax.tree.map(jnp.asarray, g), optax.EmptyState())
    got, _ = opt.clip_by_global_norm(max_norm).update(
        tree_map(torch.from_numpy, g), ())
    _assert_tree_close(got, ref, rtol=1e-6)
    if max_norm > 1e2:
        _assert_tree_close(got, g, rtol=0)


SCHEDULES = {
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4,
                        lr_range_test_step_size=7,
                        lr_range_test_staircase=True),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                     cycle_first_step_size=8, decay_step_size=4,
                     decay_lr_rate=0.5),
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_num_steps=10),
    "WarmupDecayLR": dict(total_num_steps=25, warmup_num_steps=10,
                          warmup_type="linear"),
    "WarmupCosineLR": dict(total_num_steps=25, warmup_num_steps=6,
                           warmup_min_ratio=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_reference(name):
    ref = lrs_jax.get_lr_schedule(name, SCHEDULES[name], base_lr=3e-3)
    got = lrs.get_lr_schedule(name, SCHEDULES[name], base_lr=3e-3)
    for step in range(31):
        np.testing.assert_allclose(got(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9,
                                   err_msg=f"{name} step {step}")
    with pytest.raises(ValueError, match="unknown scheduler"):
        lrs.get_lr_schedule("Nope", {})
