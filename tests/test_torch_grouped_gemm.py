"""deepspeed_tpu_torch grouped GEMM against the JAX package: the group and
slot plans give the reference's integers, and the plain versions match
the Pallas kernels (``interpret=True``) on the same seeded fp32 inputs,
gathered to the [R, N] routed rows (the port's tile may differ from the
reference's padded layout).  On CPU tensors the wrappers launch nothing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepspeed_tpu.ops.pallas import grouped_gemm as jg
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg

# fp32, the same products in another summation order
ATOL = 1e-5
BM = gg.DEFAULT_BLOCK_M

#: (R, E, K, N, routing): R not a multiple of the tile, all rows on one
#: expert, two empty experts, ragged K / N
CASES = [
    (1, 8, 64, 96, "random"),
    (16, 8, 64, 96, "random"),
    (128, 8, 64, 96, "one_expert"),
    (129, 8, 64, 96, "random"),
    (300, 8, 64, 96, "two_empty"),
    (37, 4, 50, 70, "random"),
    (100, 4, 72, 130, "two_empty"),
]


def _eids(rng, R, E, routing):
    e = rng.integers(0, E, (R,)).astype(np.int32)
    if routing == "one_expert":
        e[:] = E // 2
    elif routing == "two_empty":
        e = np.where(e < 2, e + 2, e).astype(np.int32)
    return e


def _inputs(case, seed=0):
    R, E, K, N, routing = case
    rng = np.random.default_rng(seed)
    e = _eids(rng, R, E, routing)
    x = rng.standard_normal((R, K), dtype=np.float32)
    w = rng.standard_normal((E, K, N), dtype=np.float32) * 0.1
    return e, x, w


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"R{c[0]}-{c[4]}")
def test_plans_give_the_references_integers(case):
    e, _, _ = _inputs(case)
    E = case[1]
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)
    pp = gg.make_group_plan(torch.from_numpy(e), E, block_m=BM)
    assert (pp.block_m, pp.padded_rows, pp.num_blocks, pp.num_experts) == \
        (jp.block_m, jp.padded_rows, jp.num_blocks, jp.num_experts)
    for f in ("group_sizes", "block_group_ids", "row_to_padded", "counts"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    # the port's tile_rows: the real rows of each tile, from the layout
    real = np.zeros(pp.padded_rows, bool)
    real[pp.row_to_padded.numpy()] = True
    np.testing.assert_array_equal(pp.tile_rows.numpy(),
                                  real.reshape(-1, BM).sum(1))
    js = jg.make_slot_plan(jnp.asarray(e), E)
    ps = gg.make_slot_plan(torch.from_numpy(e), E)
    assert ps.num_slots == js.num_slots
    for f in ("active", "valid", "eids_col"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    # slot s owns exactly the rows of expert active[s], in row order
    order, offs = ps.row_order.numpy(), ps.slot_offsets.numpy()
    for s in range(ps.num_slots):
        rows = order[offs[s]:offs[s + 1]]
        want = np.flatnonzero(e == ps.active[s].item()) \
            if ps.valid[s] else []
        np.testing.assert_array_equal(rows, want)
    assert offs[-1] == case[0]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"R{c[0]}-{c[4]}")
def test_ggemm_plain_matches_pallas_interpret(case):
    e, x, w = _inputs(case, seed=1)
    E = case[1]
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)
    ref = np.asarray(jg.gather_from_groups(jg.ds_ggemm(
        jg.scatter_to_groups(jnp.asarray(x), jp), jnp.asarray(w), jp,
        interpret=True), jp))
    pp = gg.make_group_plan(torch.from_numpy(e), E)
    padded = gg.ds_ggemm(gg.scatter_to_groups(torch.from_numpy(x), pp),
                         torch.from_numpy(w), pp)
    got = gg.gather_from_groups(padded, pp).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # padding tiles hold zeros, as the Pallas kernel writes them
    real = np.zeros(pp.padded_rows, bool)
    real[pp.row_to_padded.numpy()] = True
    assert not padded.numpy()[~real].any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"R{c[0]}-{c[4]}")
def test_ggemm_slots_plain_matches_pallas_interpret(case):
    e, x, w = _inputs(case, seed=2)
    E = case[1]
    ref = np.asarray(jg.ds_ggemm_slots(
        jnp.asarray(x), jnp.asarray(w), jg.make_slot_plan(jnp.asarray(e), E),
        interpret=True))
    got = gg.ds_ggemm_slots(torch.from_numpy(x), torch.from_numpy(w),
                            gg.make_slot_plan(torch.from_numpy(e), E))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_cpu_tensors_launch_nothing_and_both_forms_agree():
    gg.ds_ggemm.launches = 0
    gg.ds_ggemm_slots.launches = 0
    e, x, w = _inputs((96, 8, 64, 96, "random"), seed=3)
    et, xt, wt = (torch.from_numpy(a) for a in (e, x, w))
    pp = gg.make_group_plan(et, 8)
    grouped = gg.gather_from_groups(
        gg.ds_ggemm(gg.scatter_to_groups(xt, pp), wt, pp), pp)
    slots = gg.ds_ggemm_slots(xt, wt, gg.make_slot_plan(et, 8))
    oracle = np.stack([x[r] @ w[e[r]] for r in range(e.size)])
    np.testing.assert_allclose(grouped.numpy(), oracle, atol=ATOL, rtol=0)
    np.testing.assert_allclose(slots.numpy(), oracle, atol=ATOL, rtol=0)
    assert gg.ds_ggemm.launches == 0 and gg.ds_ggemm_slots.launches == 0


def test_unported_forms_and_bad_inputs_raise():
    e, x, w = _inputs((16, 8, 64, 96, "random"))
    et, xt, wt = (torch.from_numpy(a) for a in (e, x, w))
    sp, gp = gg.make_slot_plan(et, 8), gg.make_group_plan(et, 8)
    q = (wt.to(torch.int8), torch.ones(8, 64, 1))
    with pytest.raises(NotImplementedError, match="int8 MoE"):
        gg.ds_ggemm_slots(xt, q, sp)
    with pytest.raises(NotImplementedError, match="MoE training"):
        gg.ds_ggemm(gg.scatter_to_groups(xt, gp), wt, gp, transpose_rhs=True)
    with pytest.raises(ValueError, match="dtypes"):
        gg.ds_ggemm_slots(xt, wt.double(), sp)
    with pytest.raises(ValueError, match="x \\["):
        gg.ds_ggemm_slots(xt[:, :32], wt, sp)
    # the CUDA wrappers check the plan's fit before any launch
    with pytest.raises(ValueError, match="plan"):
        gg.ggemm_cuda(xt, wt, gp)
    with pytest.raises(ValueError, match="plan"):
        gg.ggemm_slots_cuda(xt[:8], wt, sp)
    with pytest.raises(ValueError, match="tile is 64 rows"):
        small = gg.make_group_plan(et, 8, block_m=8)
        gg.ggemm_cuda(gg.scatter_to_groups(xt, small), wt, small)
