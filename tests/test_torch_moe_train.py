"""deepspeed_tpu_torch MoE training vs the JAX package.

- Kernel level: the backward's plain versions (``ggemm_t_plain``, the
  transposed-RHS form; ``tgmm_plain``, dW) against the Pallas kernels in
  interpret mode (``_pallas_ggemm(..., transpose_rhs=True)``,
  ``_pallas_tgmm``) on one 64-row group layout: ragged routing, an empty
  expert, a single expert, fp32 and bf16; and the autograd Function
  (``GroupedGemm``) against ``jax.vjp`` of ``ds_ggemm(interpret=True)``.
- Capacity dispatch: ``topkgating`` / ``top1gating`` / ``top2gating``
  masks and combine weights against the reference, drops included.
- Layer level: ``moe_layer(train=True)``, grouped (the JAX side's
  kernels in interpret mode) and einsum, output, aux loss and gradients
  against ``jax.value_and_grad``; grouped against einsum at drop-free
  capacity.
- Model level: ``mixtral:tiny``'s loss and gradients against the
  reference's ``loss_fn``, both dispatches, remat on and off.
- Engine level: ``initialize`` -> ``train_batch`` over 4 steps
  (``mixtral:tiny``, grouped, fp32, gas 2, WarmupLR, clipping) against
  the JAX engine run in a subprocess of its own (donated JAX train steps
  and torch must not share a process; see tests/conftest.py), which
  writes its init, losses and final params to an .npz:
  ``python tests/test_torch_moe_train.py --ref out.npz``.

Tolerances (fp32, summation order only): kernels and layers 1e-5 abs;
bf16 kernels one rounding of the same fp32 sum apart (8e-3 relative);
model loss 1e-6 relative, grads 1e-5 abs; engine losses 1e-5 relative and
params 1e-5 abs after 4 steps (Adam normalises each update to ~lr).
"""
import os
import subprocess
import sys

import numpy as np

MODEL = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=4,
             num_kv_heads=2, d_model=32, d_ff=64, num_experts=4, top_k=2)
MICRO, GAS, STEPS, S = 2, 2, 4, 32
LR = 1e-3


def engine_config() -> dict:
    return {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3}},
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": 2},
            "steps_per_print": 0}


def step_batches(seed: int = 11):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, MODEL["vocab_size"],
                                       (GAS, MICRO, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _jax_reference(out_path: str) -> int:
    """The JAX engine's grouped-dispatch trajectory -> ``out_path``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import deepspeed_tpu
    from deepspeed_tpu.models.mixtral import init_params, mixtral_model
    jm = mixtral_model("custom", dtype="float32", remat=True,
                       attention_impl="xla", moe_dispatch="grouped",
                       **MODEL)
    init = jax.device_get(init_params(jm.config, jax.random.PRNGKey(0)))
    eng, *_ = deepspeed_tpu.initialize(model=jm, config=engine_config(),
                                       model_parameters=init)
    res = {"loss": np.array([float(eng.train_batch(batch=b))
                             for b in step_batches()])}
    for tag, tree in (("init", init),
                      ("param", jax.device_get(eng.state["params"]))):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            name = "/".join(p.key for p in path)
            res[f"{tag}/{name}"] = np.asarray(leaf, np.float32)
    np.savez(out_path, **res)
    return 0


if __name__ == "__main__":
    # the reference run, in a process without torch
    if sys.argv[1:2] != ["--ref"] or len(sys.argv) != 3:
        sys.exit("usage: python tests/test_torch_moe_train.py --ref out.npz")
    sys.exit(_jax_reference(sys.argv[2]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.comm.mesh import sharding_pin_scope  # noqa: E402
from deepspeed_tpu.models import mixtral as jmix  # noqa: E402
from deepspeed_tpu.moe import sharded_moe as jsm  # noqa: E402
from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig  # noqa: E402
from deepspeed_tpu.moe.layer import init_moe_params  # noqa: E402
from deepspeed_tpu.moe.layer import moe_layer as jax_moe_layer  # noqa: E402
from deepspeed_tpu.ops.pallas import grouped_gemm as jg  # noqa: E402
from deepspeed_tpu_torch.checkpoint.jax_params import (  # noqa: E402
    mixtral_params_from_numpy, mixtral_params_to_numpy)
from deepspeed_tpu_torch.models import mixtral as pmix  # noqa: E402
from deepspeed_tpu_torch.moe import sharded_moe as psm  # noqa: E402
from deepspeed_tpu_torch.moe.layer import (MoEConfig,  # noqa: E402
                                           moe_layer)
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg  # noqa: E402
from deepspeed_tpu_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
BF16_RTOL = 8e-3          # two roundings of one fp32 sum: <= 2^-7 apart
BM = gg.DEFAULT_BLOCK_M


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------- kernels
#: (R, E, K, N, routing): ragged R, an empty expert, a single expert,
#: ragged K / N
KCASES = [(150, 4, 64, 96, "random"), (200, 4, 64, 96, "one_empty"),
          (90, 4, 64, 96, "one_expert"), (70, 3, 40, 72, "random")]


def _kernel_inputs(case, seed):
    R, E, K, N, routing = case
    rng = np.random.default_rng(seed)
    e = rng.integers(0, E, (R,)).astype(np.int32)
    if routing == "one_expert":
        e[:] = E - 1
    elif routing == "one_empty":
        e = np.where(e == 1, 2, e).astype(np.int32)
    plan = gg.make_group_plan(torch.from_numpy(e), E)
    x = gg.scatter_to_groups(torch.from_numpy(
        rng.standard_normal((R, K), dtype=np.float32)), plan)
    dy = gg.scatter_to_groups(torch.from_numpy(
        rng.standard_normal((R, N), dtype=np.float32) * 0.1), plan)
    w = torch.from_numpy(rng.standard_normal((E, K, N), dtype=np.float32)
                         * 0.1)
    return e, plan, x, dy, w


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6,
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KCASES, ids=lambda c: f"R{c[0]}-{c[4]}")
def test_backward_plain_versions_match_pallas_interpret(case, dtype):
    e, plan, x, dy, w = _kernel_inputs(case, seed=case[0])
    E = case[1]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x, dy, w = x.to(tdt), dy.to(tdt), w.to(tdt)
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)
    np.testing.assert_array_equal(plan.block_group_ids.numpy(),
                                  np.asarray(jp.block_group_ids))

    def j(t):
        return jnp.asarray(_np(t), jdt)
    ref_dx = jg._pallas_ggemm(j(dy), j(w), jp.block_group_ids, BM,
                              block_k=512, block_n=1024, interpret=True,
                              out_dtype=jdt, transpose_rhs=True)
    ref_dw = jg._pallas_tgmm(j(x), j(dy), jp.block_group_ids, BM, E,
                             block_k=512, block_n=1024, interpret=True,
                             out_dtype=jdt)
    gg.ds_ggemm.transpose_launches = gg.ds_tgmm.launches = 0
    dx = gg.ds_ggemm(dy, w, plan, transpose_rhs=True)
    dw = gg.ds_tgmm(x, dy, plan)
    assert dx.dtype == dw.dtype == tdt
    assert dx.shape == (plan.padded_rows, case[2])
    assert dw.shape == (E, case[2], case[3])
    _close(dx, ref_dx, dtype)
    _close(dw, ref_dw, dtype)
    # an expert without rows gets exact zeros; the plain versions ran
    for ex in range(E):
        if not (e == ex).any():
            assert not dw[ex].any()
    assert gg.ds_ggemm.transpose_launches == gg.ds_tgmm.launches == 0
    # dW in fp32 from bf16 rows (the reference's out_dtype=w.dtype)
    if dtype == "bfloat16":
        dw32 = gg.ds_tgmm(x, dy, plan, out_dtype=torch.float32)
        assert dw32.dtype == torch.float32
        _close(dw32.to(tdt), ref_dw, dtype)


@pytest.mark.parametrize("case", KCASES[:3], ids=lambda c: f"R{c[0]}-{c[4]}")
def test_grouped_gemm_autograd_matches_jax_vjp(case):
    e, plan, _, _, w = _kernel_inputs(case, seed=7)
    R, E, K, N, _ = case
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, K), dtype=np.float32)
    cot = rng.standard_normal((R, N), dtype=np.float32) * 0.1
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)

    def jfn(x_, w_):
        y = jg.ds_ggemm(jg.scatter_to_groups(x_, jp), w_, jp,
                        interpret=True)
        return jg.gather_from_groups(y, jp)
    ref_y, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(_np(w)))
    ref_dx, ref_dw = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    y = gg.gather_from_groups(
        gg.grouped_gemm(gg.scatter_to_groups(xt, plan), wt, plan), plan)
    y.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(y), np.asarray(ref_y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(ref_dx), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(_np(wt.grad), np.asarray(ref_dw), atol=ATOL,
                               rtol=0)


def test_backward_forms_refuse_what_they_do_not_take():
    _, plan, x, dy, w = _kernel_inputs(KCASES[0], seed=1)
    q = (w.to(torch.int8), torch.ones(w.shape[0], w.shape[1], 1))
    with pytest.raises(ValueError, match="no transposed-RHS"):
        gg.ds_ggemm(dy, q, plan, transpose_rhs=True)
    with pytest.raises(ValueError, match="dy \\["):
        gg.ds_ggemm(x, w, plan, transpose_rhs=True)      # x is [Mp, K]
    with pytest.raises(ValueError, match="dtypes"):
        gg.ds_tgmm(x, dy.double(), plan)
    with pytest.raises(ValueError, match="out"):
        gg.ds_tgmm(x, dy, plan, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="padded rows"):
        gg.ds_tgmm(x[:64], dy[:64], plan)
    # the CUDA wrappers check the plan's fit before any launch
    with pytest.raises(ValueError, match="plan"):
        gg.ggemm_t_cuda(dy[:64], w, plan)
    with pytest.raises(ValueError, match="tile is 64 rows"):
        small = gg.make_group_plan(torch.zeros(8, dtype=torch.int32), 4,
                                   block_m=8)
        gg.tgmm_cuda(torch.zeros(small.padded_rows, 64),
                     torch.zeros(small.padded_rows, 96), small)


# -------------------------------------------------------- capacity gating
def _gate_logits(T, E, seed):
    lg = np.random.default_rng(seed).standard_normal((T, E),
                                                     dtype=np.float32)
    lg[: T // 2, 0] += 3.0       # a hot expert: drops at capacity 1.0
    return lg


@pytest.mark.parametrize("T,E,k,cf,mc", [(40, 4, 2, 1.0, 4),
                                         (33, 8, 2, 1.25, 4),
                                         (24, 4, 1, 1.0, 1),
                                         (30, 8, 3, 2.0, 4)])
def test_topkgating_matches_jax(T, E, k, cf, mc):
    lg = _gate_logits(T, E, seed=T + k)
    ref = jsm.topkgating(jnp.asarray(lg), k, cf, mc)
    got = psm.topkgating(torch.from_numpy(lg), k, cf, mc)
    assert got.dispatch_mask.shape == ref.dispatch_mask.shape
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(ref.dispatch_mask))
    np.testing.assert_allclose(_np(got.combine_weights),
                               np.asarray(ref.combine_weights), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(got.l_aux), float(ref.l_aux),
                               atol=1e-6)
    if cf == 1.0 and k > 1:     # the hot expert overflows: tokens drop
        kept = got.dispatch_mask.sum((1, 2))
        assert int(kept.sum()) < T * k
    # from one routing decision, the combine weights are exact
    r = psm.topk_routing(torch.from_numpy(lg), k)
    jr = jsm.TopKRouting(jnp.asarray(_np(r.l_aux)),
                         jnp.asarray(_np(r.router_z_loss)),
                         jnp.asarray(r.expert_idx.numpy()),
                         jnp.asarray(_np(r.gate_weights)))
    np.testing.assert_array_equal(
        _np(psm.topkgating(torch.from_numpy(lg), k, cf, mc,
                           routing=r).combine_weights),
        np.asarray(jsm.topkgating(jnp.asarray(lg), k, cf, mc,
                                  routing=jr).combine_weights))


@pytest.mark.parametrize("which", ["top1", "top2"])
def test_top1_top2_gating_match_jax(which):
    lg = _gate_logits(36, 4, seed=5)
    jf, pf = getattr(jsm, f"{which}gating"), getattr(psm, f"{which}gating")
    ref = jf(jnp.asarray(lg), 1.0, 2)
    got = pf(torch.from_numpy(lg), 1.0, 2)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(ref.dispatch_mask))
    np.testing.assert_allclose(_np(got.combine_weights),
                               np.asarray(ref.combine_weights), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(got.l_aux), float(ref.l_aux),
                               atol=1e-6)
    # the noisy gate: the same Gumbel draw on both sides
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3), lg.shape))
    ref = jf(jnp.asarray(lg), 1.0, 2, noise_rng=jax.random.PRNGKey(3))
    got = pf(torch.from_numpy(lg), 1.0, 2, noise_rng=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(ref.dispatch_mask))
    np.testing.assert_allclose(_np(got.combine_weights),
                               np.asarray(ref.combine_weights), atol=1e-6,
                               rtol=0)


# ------------------------------------------------------------------ layer
D, F, E, K = 32, 48, 4, 2


def _layer_params(seed):
    jc = JaxMoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K)
    return jax.device_get(init_moe_params(jc, jax.random.PRNGKey(seed)))


def _jax_layer_grads(jp, x, cot, mode, cf):
    jc = JaxMoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K,
                      capacity_factor=cf, dispatch_mode=mode,
                      z_loss_coef=1e-3)

    def loss(p, x_):
        out, aux = jax_moe_layer(p, x_, jc, train=True)
        return jnp.sum(out * cot) + aux, (out, aux)
    with sharding_pin_scope(False):
        (_, (out, aux)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
                jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    return out, aux, grads


def _port_layer_grads(jp, x, cot, mode, cf):
    cfg = MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K,
                    capacity_factor=cf, dispatch_mode=mode,
                    z_loss_coef=1e-3)
    pp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_layer(pp, xt, cfg, train=True)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    return out, aux, ({k: v.grad for k, v in pp.items()}, xt.grad)


@pytest.mark.parametrize("mode", ["grouped", "einsum"])
@pytest.mark.parametrize("B,S", [(2, 40), (1, 104)])
def test_moe_layer_train_matches_jax_value_and_grad(mode, B, S,
                                                    monkeypatch):
    """T * k = 160 and 208 routed rows; the einsum arm at the default
    capacity factor 1.25 (tokens past capacity drop)."""
    monkeypatch.setenv("DS_GGEMM_INTERPRET", "1")
    jp = _layer_params(seed=S)
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    cot = rng.standard_normal((B, S, D), dtype=np.float32)
    ref_out, ref_aux, (ref_gp, ref_gx) = _jax_layer_grads(jp, x, cot, mode,
                                                          1.25)
    gg.ds_ggemm.launches = gg.ds_ggemm.transpose_launches = 0
    gg.ds_tgmm.launches = 0
    out, aux, (gp, gx) = _port_layer_grads(jp, x, cot, mode, 1.25)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux),
                               atol=1e-6)
    np.testing.assert_allclose(_np(gx), np.asarray(ref_gx), atol=ATOL,
                               rtol=0)
    for key, g in gp.items():
        np.testing.assert_allclose(_np(g), np.asarray(ref_gp[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert gg.ds_ggemm.launches == gg.ds_ggemm.transpose_launches == \
        gg.ds_tgmm.launches == 0


def test_grouped_matches_einsum_train_fwd_bwd():
    """At drop-free capacity (E / k) the two formulations compute the same
    forward and gradients (the reference's own check)."""
    jp = _layer_params(seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, D), dtype=np.float32)
    cot = rng.standard_normal((2, 8, D), dtype=np.float32)
    ge = _port_layer_grads(jp, x, cot, "einsum", float(E) / K)
    gr = _port_layer_grads(jp, x, cot, "grouped", float(E) / K)
    np.testing.assert_allclose(_np(gr[0]), _np(ge[0]), atol=2e-5, rtol=0)
    assert float(gr[1].detach()) == pytest.approx(float(ge[1].detach()),
                                                  rel=1e-6)
    np.testing.assert_allclose(_np(gr[2][1]), _np(ge[2][1]), atol=5e-5,
                               rtol=0)
    for key in ("router", "w_in", "w_out", "w_gate"):
        np.testing.assert_allclose(_np(gr[2][0][key]), _np(ge[2][0][key]),
                                   atol=5e-5, rtol=5e-5, err_msg=key)


def test_refused_training_features():
    pp = {k: torch.from_numpy(np.array(v))
          for k, v in _layer_params(0).items()}
    x = torch.zeros(1, 8, D)
    # residual MoE and the noisy gate train now (test_torch_moe_extras):
    # the residual branch needs its leaves, the noise its logits' shape
    with pytest.raises(KeyError, match="res_gate"):
        moe_layer(pp, x, MoEConfig(D, F, E, K, use_residual=True),
                  train=True)
    with pytest.raises(ValueError, match="noise shape"):
        moe_layer(pp, x, MoEConfig(D, F, E, K, noisy_gate_policy="Jitter"),
                  train=True, rng=torch.zeros(2, E))
    with pytest.raises(NotImplementedError, match="remat policies"):
        pmix.mixtral_model("tiny", remat=True, remat_policy="dots")
    # einsum at eval: the capacity formulation at eval_capacity_factor
    out, _ = moe_layer(pp, torch.randn(1, 8, D), MoEConfig(D, F, E, K))
    assert out.shape == (1, 8, D)


# ------------------------------------------------------------------ model
def _tiny_params(seed=0):
    jc = jmix.MixtralConfig(**MODEL, dtype="float32")
    return jax.device_get(jmix.init_params(jc, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dispatch", ["grouped", "auto"])
def test_mixtral_loss_and_grads_match_jax(dispatch, monkeypatch):
    """``auto`` trains through the einsum dispatch, ``grouped`` through
    the grouped GEMMs (the JAX side's kernels in interpret mode)."""
    monkeypatch.setenv("DS_GGEMM_INTERPRET", "1")
    params = _tiny_params()
    ids = np.random.default_rng(1).integers(0, 256, (2, S)).astype(np.int32)
    jm = jmix.mixtral_model("custom", dtype="float32", attention_impl="xla",
                            moe_dispatch=dispatch, **MODEL)
    with sharding_pin_scope(False):
        loss_j, grads_j = jax.value_and_grad(jm.loss_fn)(
            jax.tree.map(jnp.asarray, params),
            {"input_ids": jnp.asarray(ids)})
    ref = jax.device_get(grads_j)
    for remat in (False, True):
        pm = pmix.mixtral_model("custom", dtype="float32", remat=remat,
                                moe_dispatch=dispatch, **MODEL)
        pt = mixtral_params_from_numpy(params, "cpu")
        for p in tree_leaves(pt):
            p.requires_grad_(True)
        loss = pm.loss(pt, {"input_ids": torch.from_numpy(ids)})
        grads = torch.autograd.grad(loss, tree_leaves(pt))
        np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                                   rtol=1e-6)
        it = iter(grads)
        got = mixtral_params_to_numpy(_rebuild(pt, it))
        for path, g in jax.tree_util.tree_leaves_with_path(ref):
            node = got
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, np.asarray(g), atol=ATOL,
                                       rtol=0, err_msg=str(path))


def _rebuild(tree, it):
    """``tree``'s structure with the next values of ``it`` as leaves."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def test_mixtral_trees_round_trip_and_count():
    tree = _tiny_params(3)
    back = mixtral_params_to_numpy(mixtral_params_from_numpy(tree, "cpu"))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    # 1b-moe: the same tree (names, shapes) and accounting on both sides
    jm = jmix.mixtral_model("1b-moe")
    pm = pmix.mixtral_model("1b-moe", moe_dispatch="grouped", remat=True)
    shapes = jax.eval_shape(jm.init_fn, jax.random.PRNGKey(0))
    want = {"/".join(p.key for p in path): tuple(s.shape) for path, s in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {}

    def walk(spec, prefix):
        for k, v in spec.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                got["/".join(prefix + [k])] = tuple(v[0])
    walk(pmix._shapes(pm.config), [])
    assert got == want
    assert pm.meta["n_params"] == jm.meta["n_params"] == 795_427_840
    assert pm.meta["active_params"] == jm.meta["active_params"] \
        == 266_945_536
    assert pm.flops_per_token == jm.flops_per_token


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe_ref") / "ref.npz"
    # one device: the test harness's flags give every process eight
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.pop("DS_GGEMM_INTERPRET", None)
    proc = subprocess.run([sys.executable, "tests/test_torch_moe_train.py",
                           "--ref", str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _tree_of(ref, tag):
    tree = {}
    for key, v in ref.items():
        if key.startswith(tag + "/"):
            node, path = tree, key.split("/")[1:]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
    return tree


def test_engine_trajectory_matches_jax_engine(reference):
    pm = pmix.mixtral_model("custom", dtype="float32", remat=True,
                            moe_dispatch="grouped", **MODEL)
    eng, *_ = dt.initialize(model=pm, config=engine_config(),
                            model_parameters=_tree_of(reference, "init"),
                            device="cpu")
    gg.ds_ggemm.launches = gg.ds_ggemm.transpose_launches = 0
    gg.ds_tgmm.launches = 0
    losses = [float(eng.train_batch(batch=b)) for b in step_batches()]
    assert eng.global_steps == STEPS
    assert gg.ds_ggemm.launches == gg.ds_ggemm.transpose_launches == \
        gg.ds_tgmm.launches == 0            # CPU: the plain versions
    np.testing.assert_allclose(losses, reference["loss"], rtol=1e-5)
    got = mixtral_params_to_numpy(eng.params)
    want = _tree_of(reference, "param")
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, leaf, atol=1e-5, rtol=0,
                                   err_msg=str(path))
