"""deepspeed_tpu_torch grouped GEMM against the JAX package: the group and
slot plans give the reference's integers, and the plain versions match
the Pallas kernels (``interpret=True``) on the same seeded fp32 inputs,
gathered to the [R, N] routed rows (the port's tile may differ from the
reference's padded layout) — float experts and int8 experts (the
``_ggemm_q_kernel`` / ``_slot_q_kernel`` forms, the same codes and scales
on both sides).  On CPU tensors the wrappers launch nothing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepspeed_tpu.models.model import QuantizedTensor as JaxQuantized
from deepspeed_tpu.ops.pallas import grouped_gemm as jg
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
from deepspeed_tpu_torch.ops.kernels.quantization import \
    block_quantize_int8

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
    # int8 experts are served (the slot form here); only their
    # transposed-RHS form is refused, as in the reference
    got = gg.ds_ggemm_slots(xt, q, sp)
    want = np.stack([x[r] @ q[0][e[r]].float().numpy()
                     for r in range(e.size)])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="no transposed-RHS"):
        gg.ds_ggemm(gg.scatter_to_groups(xt, gp), q, gp, transpose_rhs=True)
    # the float transposed-RHS form (the backward's dx) is served: dy
    # [Mp, N] against w[e] transposed, each routed row its own expert's
    dy = np.random.default_rng(4).standard_normal((e.size, 96),
                                                  dtype=np.float32)
    dx = gg.gather_from_groups(gg.ds_ggemm(
        gg.scatter_to_groups(torch.from_numpy(dy), gp), wt, gp,
        transpose_rhs=True), gp)
    want = np.stack([dy[r] @ w[e[r]].T for r in range(e.size)])
    np.testing.assert_allclose(dx.numpy(), want, atol=ATOL, rtol=0)
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


# ------------------------------------------------------------ int8 experts
#: (R, E, K, N, routing): as CASES, plus ragged N whose scale-group width
#: (ceil(N / nb): 150, 234) divides neither the port's tiles nor the
#: reference's
Q_CASES = CASES + [
    (16, 8, 64, 300, "random"),
    (160, 8, 64, 300, "two_empty"),
    (48, 4, 40, 700, "one_expert"),
]


def _q_inputs(case, seed):
    """Seeded inputs with int8 experts: the codes and scales the port's
    quantizer gives, handed to both packages."""
    e, x, w = _inputs(case, seed)
    q, s = block_quantize_int8(torch.from_numpy(w))
    return e, x, q, s


@pytest.mark.parametrize("case", Q_CASES, ids=lambda c: f"R{c[0]}-N{c[3]}-{c[4]}")
def test_ggemm_q_plain_matches_pallas_interpret(case):
    """ggemm_q_plain against ``_ggemm_q_kernel`` (interpret mode)."""
    e, x, q, s = _q_inputs(case, seed=4)
    E = case[1]
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)
    ref = np.asarray(jg.gather_from_groups(jg.ds_ggemm(
        jg.scatter_to_groups(jnp.asarray(x), jp),
        JaxQuantized(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                     "float32"), jp, interpret=True), jp))
    pp = gg.make_group_plan(torch.from_numpy(e), E)
    padded = gg.ds_ggemm(gg.scatter_to_groups(torch.from_numpy(x), pp),
                         QuantizedTensor(q, s, torch.float32), pp)
    got = gg.gather_from_groups(padded, pp).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    real = np.zeros(pp.padded_rows, bool)
    real[pp.row_to_padded.numpy()] = True
    assert not padded.numpy()[~real].any()


@pytest.mark.parametrize("case", [c for c in Q_CASES
                                  if c[0] <= gg.SLOT_MAX_ROWS],
                         ids=lambda c: f"R{c[0]}-N{c[3]}-{c[4]}")
def test_ggemm_slots_q_plain_matches_pallas_interpret(case):
    """ggemm_slots_q_plain against ``_slot_q_kernel`` (interpret mode),
    the weights given as a ``(q, s)`` pair on both sides."""
    e, x, q, s = _q_inputs(case, seed=5)
    E = case[1]
    ref = np.asarray(jg.ds_ggemm_slots(
        jnp.asarray(x), (jnp.asarray(q.numpy()), jnp.asarray(s.numpy())),
        jg.make_slot_plan(jnp.asarray(e), E), interpret=True))
    got = gg.ds_ggemm_slots(torch.from_numpy(x), (q, s),
                            gg.make_slot_plan(torch.from_numpy(e), E))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_int8_cpu_tensors_launch_nothing_and_round_like_the_kernels():
    """Both int8 forms on CPU tensors: no launch; bf16 rows take the
    dequantized weight rounded to bf16 (the kernels' ``dequant_w``), so
    the two forms agree with a bf16 oracle."""
    gg.ds_ggemm.int8_launches = gg.ds_ggemm_slots.int8_launches = 0
    e, x, q, s = _q_inputs((96, 8, 64, 300, "random"), seed=6)
    et, xt = torch.from_numpy(e), torch.from_numpy(x).bfloat16()
    wb = gg.dequant_experts(q, s, torch.bfloat16)
    pp = gg.make_group_plan(et, 8)
    grouped = gg.gather_from_groups(
        gg.ds_ggemm(gg.scatter_to_groups(xt, pp), (q, s), pp), pp)
    slots = gg.ds_ggemm_slots(xt, (q, s), gg.make_slot_plan(et, 8))
    oracle = torch.stack([xt[r].float() @ wb[e[r]].float()
                          for r in range(e.size)])
    for got in (grouped, slots):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), oracle.numpy(),
                                   atol=2e-2 * float(oracle.abs().max()),
                                   rtol=0)
    assert gg.ds_ggemm.int8_launches == gg.ds_ggemm_slots.int8_launches == 0
    assert gg.ds_ggemm.launches == gg.ds_ggemm_slots.launches == 0


def test_int8_bad_inputs_raise():
    e, x, q, s = _q_inputs((16, 8, 64, 96, "random"), seed=7)
    et, xt = torch.from_numpy(e), torch.from_numpy(x)
    sp, gp = gg.make_slot_plan(et, 8), gg.make_group_plan(et, 8)
    with pytest.raises(ValueError, match="int8 experts"):
        gg.ds_ggemm_slots(xt, (q, s[:, :32]), sp)
    with pytest.raises(ValueError, match="dtypes"):
        gg.ds_ggemm_slots(xt, (q.int(), s), sp)
    with pytest.raises(ValueError, match="dtypes"):
        gg.ds_ggemm(gg.scatter_to_groups(xt, gp), (q, s.double()), gp)
    # the CUDA wrappers check the plan's fit before any launch
    with pytest.raises(ValueError, match="plan"):
        gg.ggemm_q_cuda(xt, q, s, gp)
    with pytest.raises(ValueError, match="plan"):
        gg.ggemm_slots_q_cuda(xt[:8], q, s, sp)
