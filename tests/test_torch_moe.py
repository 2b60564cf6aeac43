"""deepspeed_tpu_torch MoE layer against the JAX package: top-k routing
(indices exact, gates and aux loss to 1e-6, fp32) and the grouped
``moe_layer`` on the same seeded params and inputs, with the JAX side
running its Pallas grouped-GEMM kernels in interpret mode
(``DS_GGEMM_INTERPRET=1``: the slot branch at T * k <= 128, the
group-padded branch above it, as the port), to 1e-5 — with float and with
int8 experts and router (the same codes on both sides; the JAX side's
``_slot_q_kernel`` / ``_ggemm_q_kernel``).  The unported features
raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.model import QuantizedTensor as JaxQuantized
from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig
from deepspeed_tpu.moe.layer import init_moe_params
from deepspeed_tpu.moe.layer import moe_layer as jax_moe_layer
from deepspeed_tpu.moe.sharded_moe import topk_routing as jax_topk_routing
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.moe.layer import (MoEConfig, moe_layer,
                                           resolve_dispatch_mode)
from deepspeed_tpu_torch.moe.sharded_moe import topk_routing
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
from deepspeed_tpu_torch.ops.kernels import qgemm as qg
from deepspeed_tpu_torch.ops.kernels.quantization import \
    block_quantize_int8

D, F, E, K = 32, 48, 4, 2


def _logits(T, E_, seed):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((T, E_), dtype=np.float32)
    lg[1, :2] = 3.0            # an exact tie: the first maximum wins
    lg[2, :] = 0.0             # all tied
    return lg


@pytest.mark.parametrize("T,E_,k,z", [(40, 8, 2, 0.0), (7, 4, 1, 0.0),
                                      (33, 8, 3, 1e-3)])
def test_topk_routing_matches_jax(T, E_, k, z):
    lg = _logits(T, E_, seed=T)
    ref = jax_topk_routing(jnp.asarray(lg), k, z_loss_coef=z)
    got = topk_routing(torch.from_numpy(lg), k, z_loss_coef=z)
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(ref.expert_idx))
    np.testing.assert_allclose(got.gate_weights.numpy(),
                               np.asarray(ref.gate_weights), atol=1e-6,
                               rtol=0)
    for a, b in ((got.l_aux, ref.l_aux),
                 (got.router_z_loss, ref.router_z_loss)):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6, rtol=0)


def _params(seed=0):
    jc = JaxMoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K,
                      dispatch_mode="grouped")
    p = jax.device_get(init_moe_params(jc, jax.random.PRNGKey(seed)))
    return jc, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("B,S", [(1, 8), (2, 32), (1, 64), (2, 40),
                                 (1, 104)])
def test_grouped_moe_layer_matches_jax(B, S, monkeypatch):
    """T * k = 16, 128, 128 (slot branch), 160, 208 (group branch); T a
    multiple of 8, as the JAX layer's token sharding over the test mesh
    needs."""
    monkeypatch.setenv("DS_GGEMM_INTERPRET", "1")
    jc, jp, pp = _params(seed=B * 100 + S)
    x = np.random.default_rng(S).standard_normal((B, S, D),
                                                 dtype=np.float32)
    ref, ref_aux = jax_moe_layer(jp, jnp.asarray(x), jc, train=False)
    gg.ds_ggemm.launches = gg.ds_ggemm_slots.launches = 0
    got, aux = moe_layer(pp, torch.from_numpy(x),
                         MoEConfig(d_model=D, d_ff=F, num_experts=E,
                                   top_k=K, dispatch_mode="auto"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6,
                               rtol=0)
    assert gg.ds_ggemm.launches == gg.ds_ggemm_slots.launches == 0


class _Spy:
    """Counts the calls of a plain version (the CPU side's launches)."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn = 0, getattr(module, name)

        def counted(*a, **kw):
            self.n += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("B,S", [(1, 8), (2, 32), (2, 40), (1, 104)])
def test_grouped_moe_layer_int8_matches_jax(B, S, monkeypatch):
    """int8 experts ([E, K, N] slices) and an int8 router ([D, E]), fp32:
    T * k = 16, 128 (slot branch: ``_slot_q_kernel``) and 160, 208 (group
    branch: ``_ggemm_q_kernel``); the router goes through qgemm with fp32
    rows on both sides."""
    monkeypatch.setenv("DS_GGEMM_INTERPRET", "1")
    jc, jp, _ = _params(seed=B * 10 + S)
    jq, pq = {}, {}
    for k, v in jp.items():
        q, s = block_quantize_int8(torch.from_numpy(np.array(v)))
        jq[k] = JaxQuantized(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                             "float32")
        pq[k] = QuantizedTensor(q, s, torch.float32)
    x = np.random.default_rng(S).standard_normal((B, S, D),
                                                 dtype=np.float32)
    ref, ref_aux = jax_moe_layer(jq, jnp.asarray(x), jc, train=False)
    slot_q = _Spy(monkeypatch, gg, "ggemm_slots_q_plain")
    group_q = _Spy(monkeypatch, gg, "ggemm_q_plain")
    router = _Spy(monkeypatch, qg, "qgemm_plain")
    got, aux = moe_layer(pq, torch.from_numpy(x),
                         MoEConfig(d_model=D, d_ff=F, num_experts=E,
                                   top_k=K, dispatch_mode="auto"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6,
                               rtol=0)
    slot = B * S * K <= gg.SLOT_MAX_ROWS
    assert (slot_q.n, group_q.n) == ((3, 0) if slot else (0, 3))
    assert router.n == 1


def test_refusals():
    cfg = MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K)
    x = torch.zeros(1, 3, D)
    _, _, pp = _params()
    assert resolve_dispatch_mode(cfg, train=False, override="auto") == \
        "grouped"
    assert resolve_dispatch_mode(
        MoEConfig(D, F, dispatch_mode="auto"), train=False) == "grouped"
    # served since MoE training: the einsum formulation (the reference's
    # default mode; "auto" when training) and the grouped one at train
    assert resolve_dispatch_mode(
        MoEConfig(D, F, dispatch_mode="auto"), train=True) == "einsum"
    assert resolve_dispatch_mode(cfg, False, override="einsum") == "einsum"
    out, _ = moe_layer(pp, x, cfg)
    assert out.shape == x.shape and not out.any()     # zero inputs
    grouped = MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K,
                        dispatch_mode="grouped")
    assert moe_layer(pp, x, grouped, train=True)[0].shape == x.shape
    # residual MoE and the noisy gate are served now: the residual
    # branch needs its own leaves, and noise must match the logits
    with pytest.raises(KeyError, match="res_gate"):
        moe_layer(pp, x, MoEConfig(d_model=D, d_ff=F, num_experts=E,
                                   top_k=K, dispatch_mode="grouped",
                                   use_residual=True))
    with pytest.raises(ValueError, match="noise shape"):
        topk_routing(torch.zeros(3, E), K, noise_rng=torch.zeros(2, E))
    with pytest.raises(ValueError, match="dispatch mode"):
        resolve_dispatch_mode(cfg, False, override="bogus")
