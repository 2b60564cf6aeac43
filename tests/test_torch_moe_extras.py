"""The rest of MoE training and einsum serving against the JAX package.

- The residual MoE (``use_residual``: a dense FFN beside the experts,
  mixed by a per-token fp32 softmax coefficient) and the noisy gate
  (``noisy_gate_policy="Jitter"``: Gumbel noise on the selection logits
  only), together, through ``moe_layer(train=True)`` on both dispatches:
  the forward, the aux loss and every gradient against the JAX
  ``moe_layer`` (``jax.value_and_grad``) on the same params; the port is
  handed the very Gumbel array ``jax.random.gumbel`` draws from the
  reference's key.  ``topk_routing`` with that noise against the
  reference's.
- The noise drawn from a seed (what the models pass): the same seed the
  same draw, a remat recompute included.
- The einsum dispatch at eval drops tokens past ``eval_capacity_factor``
  as the reference's does (same outputs at a capacity that drops).
- Einsum serving: ``serving.moe_dispatch="einsum"`` through the port's
  scheduler against the JAX scheduler's tokens on tiny Mixtral (fp32,
  greedy, a pool that preempts), and against the port's own static
  generate under ``dispatch_scope("einsum")``.

Tolerance: fp32 <= 1e-5 abs on outputs and gradients (summation order
only), the aux loss <= 1e-6; tokens exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import sharding_pin_scope
from deepspeed_tpu.models import mixtral as jmix
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig
from deepspeed_tpu.moe.layer import init_moe_params
from deepspeed_tpu.moe.layer import moe_layer as jax_moe_layer
from deepspeed_tpu.runtime.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.serving import SamplingParams as JaxSampling
from deepspeed_tpu_torch.checkpoint.jax_params import (
    mixtral_params_from_numpy, mixtral_params_to_numpy)
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import mixtral as pmix
from deepspeed_tpu_torch.moe import sharded_moe as psm
from deepspeed_tpu_torch.models.model import seeded_device_init
from deepspeed_tpu_torch.moe.layer import (MoEConfig, dispatch_scope,
                                           moe_layer, moe_shapes)
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                         RequestState, SamplingParams)
from deepspeed_tpu_torch.utils.tree import tree_leaves

ATOL = 1e-5
D, F, E, K = 32, 48, 4, 2


@pytest.fixture(scope="module", autouse=True)
def _interpret_grouped_gemm():
    """The JAX package's grouped-GEMM kernels in interpret mode, and its
    schedulers' block-accounting check each step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_GGEMM_INTERPRET", "1")
        mp.setenv("DS_SERVE_DEBUG", "1")
        yield


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _cfgs(mode, **kw):
    common = dict(d_model=D, d_ff=F, num_experts=E, top_k=K,
                  dispatch_mode=mode, z_loss_coef=1e-3, **kw)
    return JaxMoEConfig(**common), MoEConfig(**common)


def test_noisy_topk_routing_matches_jax():
    rng = np.random.default_rng(1)
    lg = rng.standard_normal((40, E), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.gumbel(key, lg.shape))
    ref = jsm.topk_routing(jnp.asarray(lg), K, key, 1e-3)
    got = psm.topk_routing(torch.from_numpy(lg), K, torch.from_numpy(noise),
                           1e-3)
    clean = psm.topk_routing(torch.from_numpy(lg), K, None, 1e-3)
    np.testing.assert_array_equal(_np(got.expert_idx),
                                  np.asarray(ref.expert_idx))
    for a, b in ((got.gate_weights, ref.gate_weights), (got.l_aux, ref.l_aux),
                 (got.router_z_loss, ref.router_z_loss)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)
    # the noise moved the choice, not the gates' source or the z loss
    assert not torch.equal(got.expert_idx, clean.expert_idx)
    assert torch.equal(got.router_z_loss, clean.router_z_loss)


@pytest.mark.parametrize("mode", ["grouped", "einsum"])
def test_residual_and_noisy_gate_train_match_jax(mode):
    """Against the JAX layer's einsum dispatch at a drop-free capacity
    (E / k), where its two formulations compute the same function (the
    reference's own check), so the grouped arm needs no interpret-mode
    Pallas run."""
    drop_free = dict(use_residual=True, noisy_gate_policy="Jitter",
                     capacity_factor=E / K)
    jc, _ = _cfgs("einsum", **drop_free)
    _, pc = _cfgs(mode, **drop_free)
    jp = jax.device_get(init_moe_params(jc, jax.random.PRNGKey(7)))
    assert {"res_in", "res_gate", "res_out", "coef_w", "coef_b"} <= set(jp)
    jp["coef_b"] = np.array([0.3, -0.2], np.float32)   # a live bias
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, D), dtype=np.float32)
    cot = rng.standard_normal((2, 20, D), dtype=np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.gumbel(key, (40, E)))

    def jloss(p, x_):
        out, aux = jax_moe_layer(p, x_, jc, train=True, rng=key)
        return jnp.sum(out * cot) + aux, (out, aux)
    with sharding_pin_scope(False):
        (_, (ref_out, ref_aux)), (ref_gp, ref_gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
                jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    pp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_layer(pp, xt, pc, train=True,
                         rng=torch.from_numpy(noise))
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(ref_gx), atol=ATOL,
                               rtol=0)
    for k, p in pp.items():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref_gp[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    # without the noise the routing (and the output) differ
    quiet, _ = moe_layer(pp, xt, pc, train=False)
    assert not torch.allclose(quiet, out)


def test_seeded_noise_repeats_under_remat():
    _, pc = _cfgs("grouped", noisy_gate_policy="Jitter")
    pp = seeded_device_init(moe_shapes(pc), 0, "cpu", None, quantize=False)
    x = torch.randn(1, 24, D, generator=torch.Generator().manual_seed(0))
    a, _ = moe_layer(pp, x, pc, train=True, rng=123)
    b, _ = moe_layer(pp, x, pc, train=True, rng=123)
    c, _ = moe_layer(pp, x, pc, train=True, rng=124)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a model's layer under torch.utils.checkpoint draws it again in the
    # backward's recompute: gradients equal those without remat
    model = pmix.mixtral_model("tiny", dtype="float32", remat=True,
                               noisy_gate_policy="Jitter",
                               moe_dispatch="grouped")
    plain = pmix.mixtral_model("tiny", dtype="float32", remat=False,
                               noisy_gate_policy="Jitter",
                               moe_dispatch="grouped")
    params = model.init(0, "cpu")
    batch = {"input_ids": torch.randint(1, 256, (2, 16),
                                        generator=torch.Generator()
                                        .manual_seed(1))}
    grads = []
    for m in (model, plain):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = m.loss(params, batch, rng=(42, 3, 0))
        grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(g, h) for g, h in zip(*grads))


def test_einsum_eval_drops_match_jax():
    jc, pc = _cfgs("einsum", eval_capacity_factor=0.5)
    jp = jax.device_get(init_moe_params(jc, jax.random.PRNGKey(3)))
    x = np.random.default_rng(4).standard_normal((1, 32, D),
                                                 dtype=np.float32)
    with sharding_pin_scope(False):
        ref, _ = jax_moe_layer(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x), jc, train=False)
    got, _ = moe_layer({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()}, torch.from_numpy(x), pc)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL, rtol=0)
    # capacity 0.5 x T k / E slots an expert: some token lost a choice
    full, _ = moe_layer({k: torch.from_numpy(np.array(v))
                         for k, v in jp.items()}, torch.from_numpy(x),
                        _cfgs("grouped")[1])
    assert not torch.allclose(got, full, atol=1e-4)


def test_mixtral_residual_leaves_carry_across():
    m = pmix.mixtral_model("tiny", dtype="float32", use_residual=True)
    params = m.init(0, "cpu")
    moe = params["blocks"]["moe"]
    assert moe["res_in"].shape == (2, 32, 64) and moe["coef_b"].shape == \
        (2, 2) and not moe["coef_b"].any()
    back = mixtral_params_from_numpy(mixtral_params_to_numpy(params), "cpu")
    assert set(back["blocks"]["moe"]) == set(moe)
    assert all(torch.equal(back["blocks"]["moe"][k], moe[k]) for k in moe)


def test_einsum_serving_matches_jax_scheduler():
    jm = jmix.mixtral_model("tiny", attention_impl="xla", dtype="float32")
    cfg = {"dtype": "float32"}
    jeng = deepspeed_tpu.init_inference(model=jm, config=cfg)
    pm = pmix.mixtral_model("tiny", dtype="float32")
    peng = InferenceEngine(pm, DeepSpeedInferenceConfig(**cfg),
                           model_parameters=jax.device_get(jeng.params),
                           device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (9, 70, 17, 5)]
    scfg = dict(block_size=8, num_blocks=14, max_num_seqs=3,
                max_num_batched_tokens=256, moe_dispatch="einsum")
    js = JaxScheduler(jm, jeng.params, JaxServingConfig(**scfg))
    ps = ContinuousBatchingScheduler(pm, peng.params, ServingConfig(**scfg))
    new, prio = (8, 6, 10, 7), (1, 0, 0, 1)
    jr = [js.submit(p, JaxSampling(max_new_tokens=n), priority=q)
          for p, n, q in zip(prompts, new, prio)]
    pr = [ps.submit(p, SamplingParams(max_new_tokens=n), priority=q)
          for p, n, q in zip(prompts, new, prio)]
    js.run_until_idle()
    ps.run_until_idle()
    assert ps.metrics.counters["preemptions"] >= 1
    with dispatch_scope("einsum"):
        for p, a, b in zip(prompts, jr, pr):
            assert b.state == RequestState.FINISHED
            assert b.output_ids == a.output_ids
            ref = peng.generate(p[None], max_new_tokens=len(b.output_ids))
            assert b.output_ids == list(ref[0, p.size:])
