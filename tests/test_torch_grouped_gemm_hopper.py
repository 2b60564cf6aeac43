"""deepspeed_tpu_torch grouped GEMM: the layouts the Hopper kernels'
work-unit walk meets at its edges, and the wrapper's routing by shape.

- The plain versions (``ggemm_plain``, ``ggemm_t_plain``, ``tgmm_plain``)
  against the Pallas kernels in interpret mode (``_pallas_ggemm``, its
  ``transpose_rhs=True`` form, ``_pallas_tgmm``) on one 64-row group
  layout with an expert of exactly one M-tile next to a long one (a pair
  of M-tiles split between two experts), an empty expert, trailing tiles
  clamped to the last expert, an odd number of M-tiles, K and N multiples
  of 8 but not of 64 / 128 / 256, and a ragged R; fp32, 1e-5 abs (the same
  sums in another order).
- The wrapper's routing (``csrc/grouped_gemm_hopper.cu`` for bf16 with K
  and N multiples of 8 on 16-byte aligned bases; ``csrc/grouped_gemm.cu``
  for fp32, int8 experts and the rest) and its refusals, with the launch
  stubbed so that no kernel runs: the entry point, its integer arguments
  and the counter each launch adds to.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepspeed_tpu.ops.pallas import grouped_gemm as jg
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg

ATOL = 1e-5
BM = gg.DEFAULT_BLOCK_M

#: (name, per-expert routed rows, K, N); rows are shuffled into token
#: order, so each expert's run keeps its tokens' order
LAYOUTS = [
    # tiles: e0 1 (exactly one), e1 4, e2 1 (empty), e3 1; R 301 pads to
    # 9 tiles, so pair (0, 1) is split and tiles 7-8 trail (clamped)
    ("split_pair_empty_trailing", (64, 200, 0, 37), 136, 264),
    # 7 tiles (odd): the last pair has one tile; e1 and e2 empty
    ("odd_tiles_two_empty", (130, 0, 0, 1), 72, 520),
    # every pair split: one-tile experts side by side
    ("one_tile_experts", (60, 64, 1, 33, 64), 200, 136),
]


def _case(layout, seed):
    _, counts, K, N = layout
    rng = np.random.default_rng(seed)
    e = np.concatenate([np.full(c, i, np.int32)
                        for i, c in enumerate(counts)])
    e = e[rng.permutation(len(e))]
    E = len(counts)
    plan = gg.make_group_plan(torch.from_numpy(e), E)
    R = len(e)
    x = gg.scatter_to_groups(torch.from_numpy(
        rng.standard_normal((R, K), dtype=np.float32)), plan)
    dy = gg.scatter_to_groups(torch.from_numpy(
        rng.standard_normal((R, N), dtype=np.float32) * 0.1), plan)
    w = torch.from_numpy(rng.standard_normal((E, K, N), dtype=np.float32)
                         * 0.1)
    return e, E, plan, x, dy, w


def test_layouts_reach_the_unit_walks_edges():
    """The cases hold what they are named for (pairs of M-tiles 2p and
    2p + 1 split between experts, empty experts, trailing tiles, an odd
    tile count, K and N off the kernels' 64 / 128 / 256 blocks)."""
    seen = set()
    for layout in LAYOUTS:
        _, E, plan, _, _, _ = _case(layout, seed=0)
        gids = plan.block_group_ids.tolist()
        rows = plan.tile_rows.tolist()
        used = int(torch.clamp(-(-plan.counts // BM), min=1).sum())
        for p in range(0, plan.num_blocks - 1, 2):
            if rows[p] and rows[p + 1] and gids[p] != gids[p + 1]:
                seen.add("split_pair")
        if (plan.counts == 0).any():
            seen.add("empty_expert")
        if plan.num_blocks > used:
            assert all(g == E - 1 for g in gids[used:])
            assert not any(rows[used:])
            seen.add("trailing")
        if plan.num_blocks % 2:
            seen.add("odd_tiles")
        K, N = layout[2], layout[3]
        assert K % 8 == 0 and N % 8 == 0
        if K % 64 and N % 256:
            seen.add("ragged_k_n")
    assert seen == {"split_pair", "empty_expert", "trailing", "odd_tiles",
                    "ragged_k_n"}


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: c[0])
@pytest.mark.parametrize("form", ["forward", "dx", "dw"])
def test_plain_versions_match_pallas_interpret_at_the_edges(layout, form):
    e, E, plan, x, dy, w = _case(layout, seed=len(layout[0]))
    jp = jg.make_group_plan(jnp.asarray(e), E, block_m=BM)
    np.testing.assert_array_equal(plan.block_group_ids.numpy(),
                                  np.asarray(jp.block_group_ids))
    kw = dict(block_k=512, block_n=1024, interpret=True,
              out_dtype=jnp.float32)
    if form == "forward":
        got = gg.ds_ggemm(x, w, plan)
        ref = jg._pallas_ggemm(jnp.asarray(x.numpy()), jnp.asarray(
            w.numpy()), jp.block_group_ids, BM, **kw)
    elif form == "dx":
        got = gg.ds_ggemm(dy, w, plan, transpose_rhs=True)
        ref = jg._pallas_ggemm(jnp.asarray(dy.numpy()), jnp.asarray(
            w.numpy()), jp.block_group_ids, BM, transpose_rhs=True, **kw)
    else:
        got = gg.ds_tgmm(x, dy, plan)
        ref = jg._pallas_tgmm(jnp.asarray(x.numpy()), jnp.asarray(
            dy.numpy()), jp.block_group_ids, BM, E, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    if form == "dw":    # an expert without rows: exact zeros
        for ex in np.flatnonzero(np.asarray(layout[1]) == 0):
            assert not got[ex].any()
    else:               # rows outside the routed ones: exact zeros
        pad = torch.ones(plan.padded_rows, dtype=torch.bool)
        pad[plan.row_to_padded.long()] = False
        assert not got[pad].any()


# ------------------------------------------------------------- routing
class _Launches:
    """Stands in for the wrapper's launch: records (library, entry point,
    integer arguments) and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, lib, name, n_ptr, n_int, device, *args):
        assert len(args) == n_ptr + n_int
        self.calls.append((lib, name, tuple(args[n_ptr:])))
        return self.rc


@pytest.fixture
def launches(monkeypatch):
    stub = _Launches()
    monkeypatch.setattr(gg, "_call", stub)
    for f, attrs in ((gg.ds_ggemm, ("launches", "transpose_launches",
                                    "int8_launches", "unaligned_launches",
                                    "unaligned_transpose_launches")),
                     (gg.ds_tgmm, ("launches", "unaligned_launches"))):
        for a in attrs:
            monkeypatch.setattr(f, a, 0)
    return stub


def _counts():
    return {"launches": gg.ds_ggemm.launches,
            "transpose_launches": gg.ds_ggemm.transpose_launches,
            "int8_launches": gg.ds_ggemm.int8_launches,
            "unaligned_launches": gg.ds_ggemm.unaligned_launches,
            "unaligned_transpose_launches":
            gg.ds_ggemm.unaligned_transpose_launches,
            "tgmm_launches": gg.ds_tgmm.launches,
            "tgmm_unaligned_launches": gg.ds_tgmm.unaligned_launches}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items()
            if v != before[k]}


def _operands(dtype, K, N, E=3, R=150, seed=3):
    rng = np.random.default_rng(seed)
    e = torch.from_numpy(rng.integers(0, E, (R,)).astype(np.int32))
    plan = gg.make_group_plan(e, E)
    x = torch.zeros(plan.padded_rows, K, dtype=dtype)
    dy = torch.zeros(plan.padded_rows, N, dtype=dtype)
    w = torch.zeros(E, K, N, dtype=dtype)
    return plan, x, dy, w


def _unaligned(t):
    """A contiguous copy of ``t`` whose base is 2 bytes past a 16-byte
    boundary (the allocator's bases are aligned)."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    base = flat.data_ptr() % 16
    off = ((16 - base) % 16 + 2) // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("K,N", [(136, 264), (1024, 3584), (8, 8)])
def test_bf16_aligned_shapes_take_the_hopper_kernels(launches, K, N):
    plan, x, dy, w = _operands(torch.bfloat16, K, N)
    E = w.shape[0]
    c0 = _counts()
    out = gg.ggemm_cuda(x, w, plan)
    assert out.shape == (plan.padded_rows, N) and out.dtype == x.dtype
    assert _moved(c0) == {"launches": 1}
    c0 = _counts()
    dx = gg.ggemm_t_cuda(dy, w, plan)
    assert dx.shape == (plan.padded_rows, K)
    assert _moved(c0) == {"transpose_launches": 1}
    c0 = _counts()
    dw = gg.tgmm_cuda(x, dy, plan)
    dw32 = gg.tgmm_cuda(x, dy, plan, out_dtype=torch.float32)
    assert dw.dtype == torch.bfloat16 and dw32.dtype == torch.float32
    assert dw.shape == dw32.shape == (E, K, N)
    assert _moved(c0) == {"tgmm_launches": 2}
    nb, Mp = plan.num_blocks, plan.padded_rows
    assert launches.calls == [
        ("grouped_gemm_hopper", "ds_ggemm_h", (nb, K, N, E)),
        ("grouped_gemm_hopper", "ds_ggemm_t_h", (nb, K, N, E)),
        ("grouped_gemm_hopper", "ds_tgmm_h", (Mp, K, N, E, 0)),
        ("grouped_gemm_hopper", "ds_tgmm_h", (Mp, K, N, E, 1))]


@pytest.mark.parametrize("dtype,K,N,why", [
    (torch.float32, 136, 264, "fp32"),
    (torch.bfloat16, 20, 264, "K"),
    (torch.bfloat16, 136, 70, "N"),
    (torch.bfloat16, 136, 264, "base")])
def test_other_shapes_take_the_layout_tile_kernels(launches, dtype, K, N,
                                                   why):
    plan, x, dy, w = _operands(dtype, K, N)
    if why == "base":
        x, dy = _unaligned(x), _unaligned(dy)
    E = w.shape[0]
    bf16 = int(dtype == torch.bfloat16)
    c0 = _counts()
    gg.ggemm_cuda(x, w, plan)
    gg.ggemm_t_cuda(dy, w, plan)
    gg.tgmm_cuda(x, dy, plan, out_dtype=torch.float32)
    if bf16:
        assert _moved(c0) == {"unaligned_launches": 1,
                              "unaligned_transpose_launches": 1,
                              "tgmm_unaligned_launches": 1}
    else:
        assert _moved(c0) == {"launches": 1, "transpose_launches": 1,
                              "tgmm_launches": 1}
    nb, Mp = plan.num_blocks, plan.padded_rows
    assert launches.calls == [
        ("grouped_gemm", "ds_ggemm", (nb, K, N, E, bf16)),
        ("grouped_gemm", "ds_ggemm_t", (nb, K, N, E, bf16)),
        ("grouped_gemm", "ds_tgmm", (Mp, K, N, E, bf16, 1))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_experts_take_the_int8_kernel(launches, dtype):
    plan, x, _, w = _operands(dtype, 136, 264)
    q = w.to(torch.int8)
    s = torch.ones(w.shape[0], w.shape[1], 2)
    c0 = _counts()
    gg.ggemm_q_cuda(x, q, s, plan)
    assert _moved(c0) == {"int8_launches": 1}
    assert launches.calls == [("grouped_gemm", "ds_ggemm_q",
                               (plan.num_blocks, 136, 264, w.shape[0], 2,
                                int(dtype == torch.bfloat16)))]


@pytest.mark.parametrize("route", ["hopper", "layout_tile"])
def test_a_failed_launch_raises_on_either_route(launches, route):
    """A launch that returns an error raises: no retry on the other
    route, and no count."""
    launches.rc = 1
    K = 136 if route == "hopper" else 20
    plan, x, dy, w = _operands(torch.bfloat16, K, 264)
    c0 = _counts()
    with pytest.raises(RuntimeError, match="ds_ggemm launch failed"):
        gg.ggemm_cuda(x, w, plan)
    with pytest.raises(RuntimeError, match="ds_ggemm_t launch failed"):
        gg.ggemm_t_cuda(dy, w, plan)
    with pytest.raises(RuntimeError, match="ds_tgmm launch failed"):
        gg.tgmm_cuda(x, dy, plan)
    assert _moved(c0) == {}
    assert len(launches.calls) == 3


def test_refusals_come_before_any_launch(launches):
    plan, x, dy, w = _operands(torch.bfloat16, 136, 264)
    with pytest.raises(ValueError, match="dtypes"):
        gg.ggemm_cuda(x, w.float(), plan)
    with pytest.raises(ValueError, match="does not fit the plan"):
        gg.ggemm_cuda(x[:64], w, plan)
    with pytest.raises(ValueError, match="contiguous"):
        gg.ggemm_t_cuda(dy.t().contiguous().t(), w, plan)
    with pytest.raises(ValueError, match="dtypes"):
        gg.tgmm_cuda(x, dy.float(), plan)
    with pytest.raises(ValueError, match="tile is 64 rows"):
        small = gg.make_group_plan(torch.zeros(8, dtype=torch.int32), 3,
                                   block_m=8)
        gg.tgmm_cuda(torch.zeros(small.padded_rows, 136,
                                 dtype=torch.bfloat16),
                     torch.zeros(small.padded_rows, 264,
                                 dtype=torch.bfloat16), small)
    assert launches.calls == []


def test_hopper_route_is_a_shape_rule():
    a = torch.zeros(64, 136, dtype=torch.bfloat16)
    p, u = a.data_ptr(), _unaligned(a).data_ptr()
    assert gg.hopper_route(torch.bfloat16, (p, p), (136, 264))
    assert not gg.hopper_route(torch.bfloat16, (p, p), (136, 260))
    assert not gg.hopper_route(torch.float32, (p, p), (136, 264))
    assert not gg.hopper_route(torch.bfloat16, (p, u), (136, 264))
