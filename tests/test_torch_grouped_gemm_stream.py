"""deepspeed_tpu_torch grouped GEMM: the streaming kernels of
``csrc/grouped_gemm_stream.cu`` (bf16 ``ds_ggemm_slots``, int8-expert
``ds_ggemm_q`` and ``ds_ggemm_slots_q``) as their decomposition, walked in
plain torch.

- The walks (``slot_stream_walk``, ``ggemm_q_stream_walk``: units, K
  ranges and split order, 8-row passes, dequantize-then-round, fp32 sums
  in K order) against the Pallas ``_slot_kernel`` / ``_ggemm_q_kernel``
  in interpret mode and against the plain versions, fp32 to 1e-5, at R 1 /
  16 / 128 / 129 / 192 (the slot form to its 128 rows) with random,
  one-expert, two-empty and repeated-slot routing, K splits with a
  part-filled last stage, and an nb whose scale groups cross a
  256-column unit.
- A row's bits in the walks whatever R (slots: R 1 / 16 / 128; int8: R
  129 / 192 / 1800), with the same expert and x for row 0.
- The split rule, the blocks and the units: what the kernel's merges and
  counters are sized by.
- The int8 slot walk (``slot_q_stream_walk``) against the Pallas
  ``_slot_q_kernel`` in interpret mode and the plain version (fp32, 1e-5;
  R 1 / 2 / 16 / 128, four routings, K splits, a scale-group edge inside a
  unit), and its rows bit-identical to ``ggemm_q_stream_walk``'s for the
  same x rows and experts (R 2 / 16 / 128 against R 192).
- The route rule (dtype, widths, alignment -> which kernel, which counter),
  with the launch stubbed as in ``tests/test_torch_grouped_gemm_hopper.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepspeed_tpu.models.model import QuantizedTensor as JaxQuantized
from deepspeed_tpu.ops.pallas import grouped_gemm as jg
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
from deepspeed_tpu_torch.ops.kernels.quantization import \
    block_quantize_int8

ATOL = 1e-5
BM = gg.DEFAULT_BLOCK_M
#: the walks' multiprocessors: few, so that small N still splits K
SMS = 4
#: K 328: six stages of 64 rows, the last 8 (a part-filled k16 slice)
K_SLOT = 328
ROUTINGS = ("random", "one_expert", "two_empty", "repeated_slots")


def _eids(rng, R, E, routing):
    e = rng.integers(0, E, (R,)).astype(np.int32)
    if routing == "one_expert":
        e[:] = E // 2
    elif routing == "two_empty":
        e = np.where(e < 2, e + 2, e).astype(np.int32)
    elif routing == "repeated_slots":
        # three distinct experts for up to E slots: the trailing slots
        # repeat the last id with no rows (valid 0)
        e = np.asarray([1, 4, 6], np.int32)[rng.integers(0, 3, (R,))]
    return e


def _slot_inputs(R, routing, seed, K=K_SLOT, N=136, E=8):
    rng = np.random.default_rng(seed)
    e = _eids(rng, R, E, routing)
    x = rng.standard_normal((R, K), dtype=np.float32)
    w = rng.standard_normal((E, K, N), dtype=np.float32) * 0.1
    return e, x, w


# ------------------------------------------------------------- slots
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("R", [1, 16, 128])
def test_slot_walk_matches_pallas_interpret_and_plain(R, routing):
    e, x, w = _slot_inputs(R, routing, seed=R)
    E = w.shape[0]
    ref = np.asarray(jg.ds_ggemm_slots(
        jnp.asarray(x), jnp.asarray(w), jg.make_slot_plan(jnp.asarray(e), E),
        interpret=True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plan = gg.make_slot_plan(torch.from_numpy(e), E)
    got = gg.slot_stream_walk(xt, wt, plan, SMS)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               gg.ggemm_slots_plain(xt, wt, plan).numpy(),
                               atol=ATOL, rtol=0)


def test_slot_walk_gives_rows_of_unknown_experts_zeros():
    e, x, w = _slot_inputs(16, "random", seed=3)
    plan = gg.make_slot_plan(torch.from_numpy(e), 8)
    got = gg.slot_stream_walk(torch.from_numpy(x), torch.from_numpy(w[:6]),
                              plan, SMS)
    gone = torch.from_numpy(e >= 6)
    assert gone.any() and not got[gone].any()
    np.testing.assert_allclose(
        got[~gone].numpy(), np.stack([x[r] @ w[e[r]] for r in range(16)
                                      if e[r] < 6]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_walk_row_bits_do_not_follow_R(dtype):
    """Row 0 (expert 3, the same x) at R 1, 16 and 128 over random
    routing: the K ranges, splits and passes do not depend on R, so its
    bits do not either."""
    e, x, w = _slot_inputs(128, "random", seed=11)
    e[0] = 3
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    rows = [gg.slot_stream_walk(xt[:R], wt, gg.make_slot_plan(
        torch.from_numpy(e[:R]), 8), SMS)[0] for R in (1, 16, 128)]
    assert all(torch.equal(r, rows[0]) for r in rows[1:])


@pytest.mark.parametrize("K,N,sms,want", [
    (4096, 14336, 132, (3, 1408)),     # Mixtral gate/in on an H100
    (14336, 4096, 132, (9, 1600)),     # Mixtral out
    (328, 136, 4, (3, 128)),           # the walks' shape
    (64, 4096, 132, (1, 64)),          # no stage to split
    (1 << 20, 64, 132, (16, 65536)),   # capped at SLOT_MAX_SPLIT
])
def test_slot_split_rule(K, N, sms, want):
    nsplit, kper = gg.slot_stream_splits(K, N, sms)
    assert (nsplit, kper) == want
    assert kper % gg.STREAM_SLOT_BK == 0
    assert 1 <= nsplit <= gg.SLOT_MAX_SPLIT
    assert nsplit * kper >= K > (nsplit - 1) * kper   # no empty range


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("R", [1, 16, 37, 128])
def test_slot_blocks_and_units_cover_every_row_once(R, routing):
    e, _, _ = _slot_inputs(R, routing, seed=R + 1, K=8, N=8)
    plan = gg.make_slot_plan(torch.from_numpy(e), 8)
    blocks = gg.slot_blocks(plan, 8)
    order = plan.row_order.tolist()
    seen = []
    for ex, r0, nrow, slot in blocks:
        assert 1 <= nrow <= gg.STREAM_SLOT_ROWS
        rows = order[r0:r0 + nrow]
        assert all(e[r] == ex for r in rows)
        seen += rows
    assert sorted(seen) == list(range(R))
    assert len(blocks) <= gg.slot_block_bound(R, plan.num_slots)
    slots = [b[3] for b in blocks]
    assert slots == sorted(slots)          # a slot's blocks adjacent
    K, N = 1000, 600
    units = gg.slot_stream_units(plan, 8, K, N, SMS)
    nsplit = gg.slot_stream_splits(K, N, SMS)[0]
    assert len(units) == len(set(units)) == len(blocks) * nsplit * 3
    assert [u[2] for u in units[:3]] == [0, 1, 2]     # N-tiles fastest
    assert [u[0] for u in units[:3 * len(blocks):3]] == list(
        range(len(blocks)))


# ---------------------------------------------------------------- int8
#: (R, E, K, N, routing): N 300 with nb 2 puts a scale-group edge (150)
#: inside the first 256-column unit; N 96 is one part-filled unit
Q_CASES = [(R, 8, 64, N, routing) for R in (1, 16, 128, 129, 192)
           for N, routing in ((96, "random"), (300, "two_empty"))] + [
    (16, 8, 64, 300, "one_expert"), (192, 8, 64, 300, "repeated_slots"),
    (48, 4, 40, 700, "one_expert"), (129, 4, 320, 96, "random"),
    (16, 3, 328, 300, "random"), (192, 4, 328, 96, "one_expert")]


def _q_inputs(case, seed):
    R, E, K, N, routing = case
    rng = np.random.default_rng(seed)
    e = _eids(rng, R, E, routing)
    x = rng.standard_normal((R, K), dtype=np.float32)
    q, s = block_quantize_int8(torch.from_numpy(
        rng.standard_normal((E, K, N), dtype=np.float32) * 0.1))
    return e, x, q, s


@pytest.mark.parametrize("case", Q_CASES,
                         ids=lambda c: f"R{c[0]}-N{c[3]}-{c[4]}")
def test_ggemm_q_walk_matches_pallas_interpret_and_plain(case):
    e, x, q, s = _q_inputs(case, seed=case[0] + case[3])
    E = case[1]
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)
    ref = np.asarray(jg.gather_from_groups(jg.ds_ggemm(
        jg.scatter_to_groups(jnp.asarray(x), jp),
        JaxQuantized(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                     "float32"), jp, interpret=True), jp))
    plan = gg.make_group_plan(torch.from_numpy(e), E)
    xp = gg.scatter_to_groups(torch.from_numpy(x), plan)
    padded = gg.ggemm_q_stream_walk(xp, q, s, plan, SMS)
    got = gg.gather_from_groups(padded, plan).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(padded.numpy(),
                               gg.ggemm_q_plain(xp, q, s, plan).numpy(),
                               atol=ATOL, rtol=0)
    real = np.zeros(plan.padded_rows, bool)
    real[plan.row_to_padded.numpy()] = True
    assert not padded.numpy()[~real].any()


@pytest.mark.parametrize("K,N,E,sms,want", [
    (4096, 14336, 8, 132, (1, 4096)),    # Mixtral gate/in: 448 units
    (14336, 4096, 8, 132, (3, 4800)),    # Mixtral out: 128 units a split
    (64, 96, 8, 4, (1, 64)),             # no stage to split
    (640, 96, 2, 132, (5, 128)),         # 8 (STREAM_Q_MAX_SPLIT) of 10
    #                                      stages: 5 ranges of 2
])
def test_ggemm_q_split_rule(K, N, E, sms, want):
    nsplit, kper = gg.ggemm_q_stream_splits(K, N, E, sms)
    assert (nsplit, kper) == want
    assert kper % gg.STREAM_Q_BK == 0
    assert nsplit * kper >= K > (nsplit - 1) * kper   # no empty range


def test_ggemm_q_walk_cases_split_k():
    """Some of the walks' int8 cases split K (3-4 experts, K 320 / 328 at
    SMS 4: two ranges, the last part-filled), so the split order is what
    the walks hold there."""
    split = [c for c in Q_CASES
             if gg.ggemm_q_stream_splits(c[2], c[3], c[1], SMS)[0] > 1]
    assert len(split) >= 3


def test_q_cases_cross_a_scale_group_inside_a_unit():
    N, nb = 300, block_quantize_int8(torch.zeros(1, 300))[1].shape[-1]
    qblock = -(-N // nb)
    edges = {c for c in range(1, N) if c % qblock == 0}
    units = [(n0, min(N, n0 + gg.STREAM_Q_BN))
             for n0 in range(0, N, gg.STREAM_Q_BN)]
    assert any(n0 < c < n1 for n0, n1 in units for c in edges)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ggemm_q_walk_row_bits_do_not_follow_R(dtype):
    """Row 0 (expert 5, the same x) at R 129, 192 and 1800: its tile's
    position moves, its unit's K order does not."""
    e, x, q, s = _q_inputs((1800, 8, 64, 96, "random"), seed=21)
    e[0] = 5
    xt = torch.from_numpy(x).to(dtype)
    got = []
    for R in (129, 192, 1800):
        plan = gg.make_group_plan(torch.from_numpy(e[:R]), 8)
        out = gg.ggemm_q_stream_walk(gg.scatter_to_groups(xt[:R], plan), q,
                                     s, plan, SMS)
        got.append(out[int(plan.row_to_padded[0])])
    assert all(torch.equal(r, got[0]) for r in got[1:])


# ------------------------------------------------------------ int8 slots
#: (R, E, K, N, routing) of the int8 slot walk: N 300 with nb 2 puts a
#: scale-group edge (150) inside the first 256-column unit; K 328 with 3-4
#: experts splits K at SMS 4 (two ranges, the last stage part-filled)
SQ_CASES = [(1, 8, 64, 96, "random"), (2, 8, 64, 300, "random"),
            (16, 8, 64, 300, "two_empty"), (16, 8, 64, 96, "one_expert"),
            (16, 8, 64, 96, "repeated_slots"), (128, 8, 64, 300, "random"),
            (128, 8, 64, 96, "two_empty"), (2, 3, 328, 300, "random"),
            (16, 4, 320, 96, "one_expert")]


@pytest.mark.parametrize("case", SQ_CASES,
                         ids=lambda c: f"R{c[0]}-K{c[2]}-N{c[3]}-{c[4]}")
def test_slot_q_walk_matches_pallas_interpret_and_plain(case):
    e, x, q, s = _q_inputs(case, seed=case[0] + case[2] + case[3])
    E = case[1]
    ref = np.asarray(jg.ds_ggemm_slots(
        jnp.asarray(x), (jnp.asarray(q.numpy()), jnp.asarray(s.numpy())),
        jg.make_slot_plan(jnp.asarray(e), E), interpret=True))
    xt = torch.from_numpy(x)
    plan = gg.make_slot_plan(torch.from_numpy(e), E)
    got = gg.slot_q_stream_walk(xt, q, s, plan, SMS)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), gg.ggemm_slots_q_plain(xt, q, s, plan).numpy(),
        atol=ATOL, rtol=0)


def test_slot_q_walk_cases_split_k_and_cross_a_group_edge():
    """The split order and a unit's group edge are what the int8 slot
    walk's cases hold there."""
    split = [c for c in SQ_CASES
             if gg.ggemm_q_stream_splits(c[2], c[3], c[1], SMS)[0] > 1]
    assert len(split) >= 2
    assert any(c[3] == 300 for c in split)


def test_slot_q_walk_gives_rows_of_unknown_experts_zeros():
    e, x, q, s = _q_inputs((16, 8, 64, 96, "random"), seed=9)
    plan = gg.make_slot_plan(torch.from_numpy(e), 8)
    got = gg.slot_q_stream_walk(torch.from_numpy(x), q[:6], s[:6], plan, SMS)
    gone = torch.from_numpy(e >= 6)
    assert gone.any() and not got[gone].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_q_walk_rows_equal_ggemm_q_walk_rows(dtype):
    """The same x rows and experts through the int8 slot walk at R 2, 16
    and 128 and through the int8 group walk at R 192: every row
    bit-identical (K split in two ranges, a group edge inside a unit)."""
    e, x, q, s = _q_inputs((192, 3, 328, 300, "random"), seed=31)
    assert gg.ggemm_q_stream_splits(328, 300, 3, SMS)[0] > 1
    xt = torch.from_numpy(x).to(dtype)
    gp = gg.make_group_plan(torch.from_numpy(e), 3)
    group = gg.gather_from_groups(gg.ggemm_q_stream_walk(
        gg.scatter_to_groups(xt, gp), q, s, gp, SMS), gp)
    for R in (2, 16, 128):
        slot = gg.slot_q_stream_walk(xt[:R], q, s, gg.make_slot_plan(
            torch.from_numpy(e[:R]), 3), SMS)
        assert slot.dtype == dtype
        assert torch.equal(slot, group[:R]), R


# ---------------------------------------------------------------- routes
#: the multiprocessors the route tests' wrapper reads
SMS_ROUTE = 132


class _Launches:
    """Stands in for the wrapper's launch: records (library, entry point,
    integer arguments) and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, lib, name, n_ptr, n_int, device, *args):
        assert len(args) == n_ptr + n_int
        self.calls.append((lib, name, tuple(args[n_ptr:])))
        return 0


COUNTERS = ((gg.ds_ggemm, ("int8_launches", "unaligned_int8_launches")),
            (gg.ds_ggemm_slots, ("launches", "unaligned_launches",
                                 "int8_launches", "unaligned_int8_launches")))


@pytest.fixture
def launches(monkeypatch):
    stub = _Launches()
    monkeypatch.setattr(gg, "_call", stub)
    monkeypatch.setattr(gg, "_sm_count", lambda device: SMS_ROUTE)
    monkeypatch.setattr(gg, "_slot_scratch", lambda *a: (
        torch.zeros(1), torch.zeros(1, dtype=torch.int32)))
    for f, attrs in COUNTERS:
        for a in attrs:
            monkeypatch.setattr(f, a, 0)
    return stub


def _counts():
    return {f"{f.__name__}.{a}": getattr(f, a) for f, attrs in COUNTERS
            for a in attrs}


def _unaligned(t):
    """A contiguous copy of ``t`` whose base is one element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    off = (16 - flat.data_ptr() % 16) % 16 // t.element_size() + 1
    out = flat[off:off + t.numel()].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


#: (dtype, K, N, what is off the rule) -> the entry point and counter
SLOT_ROUTES = [
    (torch.bfloat16, 136, 264, None, "stream", "launches"),
    (torch.bfloat16, 1024, 512, None, "stream", "launches"),
    (torch.float32, 136, 264, None, "tile", "launches"),
    (torch.bfloat16, 132, 264, "K", "tile", "unaligned_launches"),
    (torch.bfloat16, 136, 260, "N", "tile", "unaligned_launches"),
    (torch.bfloat16, 136, 264, "base", "tile", "unaligned_launches"),
]


@pytest.mark.parametrize("dtype,K,N,off,route,counter", SLOT_ROUTES)
def test_slot_route_rule(launches, dtype, K, N, off, route, counter):
    R, E = 16, 8
    e = torch.arange(R, dtype=torch.int32) % E
    plan = gg.make_slot_plan(e, E)
    x = torch.zeros(R, K, dtype=dtype)
    w = torch.zeros(E, K, N, dtype=dtype)
    if off == "base":
        x = _unaligned(x)
    c0 = _counts()
    out = gg.ggemm_slots_cuda(x, w, plan)
    assert out.shape == (R, N) and out.dtype == dtype
    moved = {k: v - c0[k] for k, v in _counts().items() if v != c0[k]}
    assert moved == {f"ds_ggemm_slots.{counter}": 1}
    S = plan.num_slots
    if route == "stream":
        nsplit, kper = gg.slot_stream_splits(K, N, SMS_ROUTE)
        assert launches.calls == [("grouped_gemm_stream", "ds_ggemm_slots_s",
                                   (R, K, N, E, S, nsplit, kper))]
    else:
        assert launches.calls == [("grouped_gemm", "ds_ggemm_slots",
                                   (R, K, N, E, S,
                                    int(dtype == torch.bfloat16)))]


#: (dtype, N, nb, what is off the rule) -> the entry point and counter
Q_ROUTES = [
    (torch.bfloat16, 272, 4, None, "stream", "int8_launches"),
    (torch.bfloat16, 1792, 14, "nb", "tile", "unaligned_int8_launches"),
    (torch.float32, 272, 4, None, "tile", "int8_launches"),
    (torch.bfloat16, 264, 4, "N", "tile", "unaligned_int8_launches"),
    (torch.bfloat16, 272, 2, "nb", "tile", "unaligned_int8_launches"),
    (torch.bfloat16, 272, 4, "base", "tile", "unaligned_int8_launches"),
    (torch.bfloat16, 272, 136, None, "stream", "int8_launches"),
    (torch.bfloat16, 272, 272, "nb", "tile", "unaligned_int8_launches"),
]


@pytest.mark.parametrize("dtype,N,nb,off,route,counter", Q_ROUTES)
def test_ggemm_q_route_rule(launches, dtype, N, nb, off, route, counter):
    K, E = 136, 3
    plan = gg.make_group_plan(torch.arange(150, dtype=torch.int32) % E, E)
    x = torch.zeros(plan.padded_rows, K, dtype=dtype)
    q = torch.zeros(E, K, N, dtype=torch.int8)
    s = torch.ones(E, K, nb)
    if off == "base":
        s = _unaligned(s)
    c0 = _counts()
    out = gg.ggemm_q_cuda(x, q, s, plan)
    assert out.shape == (plan.padded_rows, N) and out.dtype == dtype
    moved = {k: v - c0[k] for k, v in _counts().items() if v != c0[k]}
    assert moved == {f"ds_ggemm.{counter}": 1}
    nbk = plan.num_blocks
    if route == "stream":
        nsplit, kper = gg.ggemm_q_stream_splits(K, N, E, SMS_ROUTE)
        assert launches.calls == [("grouped_gemm_stream", "ds_ggemm_q_s",
                                   (nbk, K, N, E, nb, nsplit, kper))]
    else:
        assert launches.calls == [("grouped_gemm", "ds_ggemm_q",
                                   (nbk, K, N, E, nb,
                                    int(dtype == torch.bfloat16)))]


#: (dtype, N, nb, what is off the rule) -> the int8 slot entry point and
#: counter
SLOT_Q_ROUTES = [
    (torch.bfloat16, 272, 4, None, "stream", "int8_launches"),
    (torch.bfloat16, 272, 136, None, "stream", "int8_launches"),
    (torch.float32, 272, 4, None, "tile", "int8_launches"),
    (torch.bfloat16, 264, 4, "N", "tile", "unaligned_int8_launches"),
    (torch.bfloat16, 272, 2, "nb", "tile", "unaligned_int8_launches"),
    (torch.bfloat16, 272, 272, "nb", "tile", "unaligned_int8_launches"),
    (torch.bfloat16, 272, 4, "base", "tile", "unaligned_int8_launches"),
]


@pytest.mark.parametrize("dtype,N,nb,off,route,counter", SLOT_Q_ROUTES)
def test_slot_q_route_rule(launches, dtype, N, nb, off, route, counter):
    """bf16 rows on the rule launch ``ds_ggemm_slots_q_s`` with
    ``ds_ggemm_q_s``'s split; fp32 rows and shapes off the rule launch
    ``grouped_gemm.cu``'s slot kernel, bf16 ones on their own counter."""
    R, K, E = 16, 136, 3
    e = torch.arange(R, dtype=torch.int32) % E
    plan = gg.make_slot_plan(e, E)
    x = torch.zeros(R, K, dtype=dtype)
    q = torch.zeros(E, K, N, dtype=torch.int8)
    s = torch.ones(E, K, nb)
    if off == "base":
        x = _unaligned(x)
    c0 = _counts()
    out = gg.ggemm_slots_q_cuda(x, q, s, plan)
    assert out.shape == (R, N) and out.dtype == dtype
    moved = {k: v - c0[k] for k, v in _counts().items() if v != c0[k]}
    assert moved == {f"ds_ggemm_slots.{counter}": 1}
    S = plan.num_slots
    if route == "stream":
        nsplit, kper = gg.ggemm_q_stream_splits(K, N, E, SMS_ROUTE)
        assert launches.calls == [("grouped_gemm_stream", "ds_ggemm_slots_q_s",
                                   (R, K, N, E, S, nb, nsplit, kper))]
    else:
        assert launches.calls == [("grouped_gemm", "ds_ggemm_slots_q",
                                   (R, K, N, E, S, nb,
                                    int(dtype == torch.bfloat16)))]


def test_slot_q_takes_the_group_forms_split(launches):
    """The int8 slot form splits K by ``ggemm_q_stream_splits`` (the int8
    group form's rule, so a row sums in the same ranges whatever kernel
    runs it), not by the bf16 slot rule, at a shape where the two differ;
    the int8 group launch of the same K, N and E takes the same split."""
    R, K, N, E = 16, 1024, 512, 8
    want = gg.ggemm_q_stream_splits(K, N, E, SMS_ROUTE)
    assert want != gg.slot_stream_splits(K, N, SMS_ROUTE)
    e = torch.arange(R, dtype=torch.int32) % E
    q = torch.zeros(E, K, N, dtype=torch.int8)
    s = torch.ones(E, K, 4)
    gg.ggemm_slots_q_cuda(torch.zeros(R, K, dtype=torch.bfloat16), q, s,
                          gg.make_slot_plan(e, E))
    gp = gg.make_group_plan(e, E)
    gg.ggemm_q_cuda(torch.zeros(gp.padded_rows, K, dtype=torch.bfloat16), q,
                    s, gp)
    (_, slot_name, slot_ints), (_, group_name, group_ints) = launches.calls
    assert (slot_name, group_name) == ("ds_ggemm_slots_q_s", "ds_ggemm_q_s")
    assert slot_ints[-2:] == group_ints[-2:] == want


def test_stream_route_q_is_a_shape_rule():
    p = 1 << 12
    assert gg.stream_route_q(torch.bfloat16, (p, p, p), 4096, 14336, 56)
    assert not gg.stream_route_q(torch.float32, (p, p, p), 4096, 14336, 56)
    assert not gg.stream_route_q(torch.bfloat16, (p, p, p), 4092, 14336, 56)
    assert not gg.stream_route_q(torch.bfloat16, (p, p, p), 4096, 14328, 56)
    assert not gg.stream_route_q(torch.bfloat16, (p, p, p), 4096, 14336, 58)
    assert not gg.stream_route_q(torch.bfloat16, (p, p, p), 4096, 16, 16)
    assert not gg.stream_route_q(torch.bfloat16, (p, p + 2, p), 4096, 14336,
                                 56)
