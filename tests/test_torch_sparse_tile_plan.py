"""deepspeed_tpu_torch block-sparse attention: the bf16 kernels' tile plan
(``TilePlan``, built per layout by ``BlockSparsePlan``; the forward and dQ
walk its "dq" side, dK/dV its "dkv" side) and the wrappers that launch
them.

- The plan of every layout class chip_smoke.py's phase 27a checks (Fixed,
  BigBird, BSLongformer, Variable, per-head, empty rows and columns,
  dense, block 128 as 64-row sub-blocks, ragged S), causal and
  bidirectional, and of the Fixed and BigBird path layouts at S 16384:
  every live (row block, listed block) pair is covered exactly once per
  side and no other pair is marked live; diagonal pairs are marked where
  causal; segments cut each long list at fixed positions with a fixed
  merge order; the fill (live pairs over computed pairs) is at least 0.9
  at the two path layouts; nothing depends on B.
- A plain-torch walk of the plan, the kernels' arithmetic (gathered tiles
  with zeros in empty slots, the live words' masks, each split unit's
  segment partials summed in segment order), against the plain versions
  in fp32 (1e-5 abs: the same sums in another order) and against the JAX
  Pallas ``_bwd_call`` in interpret mode on the same seeded numpy inputs
  (1e-5, as ``test_plain_backward_matches_pallas``).
- The same for the forward (``tile_walk_fwd``): the dQ side's items, the
  scores masked to -inf by the live words, an online softmax per own tile
  in log2 units, each split unit's (o, max, sum) partials combined in
  segment order, against the plain forward (o and lse, 1e-5 abs, lse
  +inf exactly where the plain one is) and against the JAX ``_call(...,
  interpret=True, with_lse=True)`` (2e-5, as
  ``test_plain_forward_matches_pallas``).
- The wrappers with the launch stubbed, so that no kernel runs: bf16
  takes ``bsa_fwd_h`` / ``bsa_dq_h`` / ``bsa_dkv_h`` with the plan's
  arguments, fp32 the FMA kernels' ``bsa_fwd`` / ``bsa_dq`` / ``bsa_dkv``;
  ``with_lse=False`` passes no lse; a forward alone builds only the dQ
  side of the tile plan; the workspace and counters asked of
  ``build.scratch`` are sized from the plan; refusals come before any
  launch; a failed launch raises and counts nothing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as JB
from deepspeed_tpu_torch.ops import sparse_attention as T
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as TB

TOL = 1e-5
FWD_TOL = 2e-5          # against the Pallas forward, as its plain version
LOG2E, LN2 = float(np.log2(np.e)), float(np.log(2.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread, as in tests/test_torch_sparse_attention.py
    (its fixture says why: a first threaded CPU ``exp`` under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _empty_rows_cols(H, n):
    """Causal: block row 0 sees only an above-diagonal block; odd columns
    but 1 are attended by no row; the heads differ."""
    lay = np.zeros((H, n, n), np.int64)
    lay[:, 0, 1] = 1
    lay[:, 1:, 0] = 1
    for i in range(2, n, 2):
        lay[:, i, i] = 1
    lay[-1, 5 % n, 3 % n] = 1
    return lay


def _layouts():
    """(layout, S): every layout class of phase 27a's cases at small S."""
    return {
        "fixed_b16": (T.FixedSparsityConfig(
            2, 16, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional").make_layout(512), 512),
        "bigbird_b64": (T.BigBirdSparsityConfig(2, 64).make_layout(1024),
                        1024),
        "bslongformer_b128": (T.BSLongformerSparsityConfig(
            2, 128, global_block_indices=[0, 3]).make_layout(1024), 1024),
        "variable_b32": (T.VariableSparsityConfig(
            2, 32, num_random_blocks=1, local_window_blocks=[2, 4],
            global_block_indices=[0, 9], seed=3).make_layout(512), 512),
        "bigbird_per_head_b32": (T.BigBirdSparsityConfig(
            2, 32, different_layout_per_head=True, num_random_blocks=2,
            seed=5).make_layout(512), 512),
        "empty_rows_cols_b64": (_empty_rows_cols(2, 8), 512),
        "fixed_b128": (T.FixedSparsityConfig(
            2, 128, num_local_blocks=2, num_global_blocks=1).make_layout(
                1024), 1024),
        "dense_b64": (T.DenseSparsityConfig(2, 64).make_layout(512), 512),
        "fixed_b16_ragged": (T.FixedSparsityConfig(
            2, 16, num_local_blocks=4).make_layout(400), 400),
        "bigbird_b32_ragged": (T.BigBirdSparsityConfig(
            2, 32, attention="unidirectional").make_layout(416), 416),
    }


def _path_layouts():
    """The path's layouts at S 16384 (chip_smoke.py sparse_path_configs)."""
    return {
        "fixed": T.FixedSparsityConfig(
            16, block=16, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"),
        "bigbird": T.BigBirdSparsityConfig(
            16, block=64, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1, attention="unidirectional")}


def _side_layout(lay, S, causal, side):
    """The sub-block layout a side's tile plan is built from: rows its own
    blocks, columns its lists (dK/dV: the transpose)."""
    block = S // lay.shape[1]
    sub = TB.sub_layout(np.tril(lay != 0) if causal else lay != 0, block,
                        causal)
    return sub if side == "dq" else sub.transpose(0, 2, 1)


def _covered(tp, H, n):
    """Per (head, own sub-block, listed sub-block): how many streamed
    tiles mark the pair live, and as diagonal; and each own tile's
    streamed tiles -> (live [H, n, n], diag [H, n, n])."""
    live = np.zeros((H, n, n), np.int64)
    diag = np.zeros((H, n, n), np.int64)
    g = tp.g
    for it in tp.items:
        own, head, first, count = it[:4]
        for t in range(first, first + count):
            word = int(tp.tiles[t, 4]) & 0xFFFFFFFF
            for o in range(g):
                for s in range(g):
                    r, c = tp.own[own, o], tp.tiles[t, s]
                    bit = o * g + s
                    if (word >> bit) & 1:
                        assert r >= 0 and c >= 0
                        live[head, r, c] += 1
                    if (word >> (16 + bit)) & 1:
                        diag[head, r, c] += 1
    return live, diag


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(_layouts()))
def test_each_live_pair_covered_once_per_side(name, causal):
    lay, S = _layouts()[name]
    plan = TB.BlockSparsePlan(lay, causal)
    block = S // plan.n
    for side, tp in plan.tile_plans(block).items():
        want = _side_layout(lay, S, causal, side)
        H, n, _ = want.shape
        assert tp.kw == min(block, 64) and tp.g == 64 // tp.kw
        live, diag = _covered(tp, H, n)
        np.testing.assert_array_equal(live, want.astype(np.int64))
        eye = np.eye(n, dtype=bool)[None] & want
        np.testing.assert_array_equal(diag, (eye if causal else 0 * eye)
                                      .astype(np.int64))
        assert tp.live_pairs == int(want.sum())
        assert tp.fill == tp.live_pairs / (len(tp.tiles) * tp.g * tp.g)
        # every own sub-block is in exactly one own tile; those with no
        # list only in items of no streamed tile, which come last
        own = tp.own[:, :tp.g]
        heads = np.zeros(len(own), np.int64)
        heads[tp.items[:, 0]] = tp.items[:, 1]
        for h in range(H):
            rows = own[heads == h]
            assert sorted(rows[rows >= 0].tolist()) == list(range(n))
        counts = tp.items[:, 3]
        assert (np.diff(counts) <= 0).all()
        assert tp.n_live == int((counts > 0).sum())
        for it in tp.items[counts == 0]:
            r = tp.own[it[0], :tp.g]
            assert not want[it[1], r[r >= 0]].any()


@pytest.mark.parametrize("seg", [1, 2, 3])
def test_segments_cut_at_fixed_positions(monkeypatch, seg):
    """Each own tile's streamed tiles are walked exactly once, by segments
    of at most the side's segment length (SEGMENT_TILES, or 1 /
    SPLIT_SHARE of the side's streamed tiles if longer) cut into the
    fewest near-equal parts; a split unit's segments number 0 .. nseg - 1
    in list order, with their own split id, counter and partial tiles."""
    monkeypatch.setattr(TB, "SEGMENT_TILES", seg)
    lay, S = _layouts()["fixed_b16"]
    plan = TB.BlockSparsePlan(lay, True)
    for tp in plan.tile_plans(16).values():
        assert tp.segment == max(seg, -(-len(tp.tiles) // TB.SPLIT_SHARE))
        seg = tp.segment
        by_own = {}
        for it in tp.items:
            by_own.setdefault(int(it[0]), []).append(it)
        splits, bases = set(), []
        for own, its in by_own.items():
            its = sorted(its, key=lambda x: x[5])
            n = sum(int(x[3]) for x in its)
            nseg = max(-(-n // seg), 1)
            step = -(-n // nseg) if n else 0
            assert [int(x[5]) for x in its] == list(range(nseg))
            assert all(int(x[6]) == nseg for x in its)
            first = int(its[0][2])
            for k, x in enumerate(its):
                assert int(x[2]) == first + k * step
                assert int(x[3]) == min(step, n - k * step)
                assert int(x[3]) <= seg
            if nseg > 1:
                assert len({int(x[4]) for x in its}) == 1
                assert len({int(x[7]) for x in its}) == 1
                splits.add(int(its[0][4]))
                bases.append((int(its[0][7]), nseg))
            else:
                assert int(its[0][4]) == -1
        assert splits == set(range(tp.n_split))
        # the split units' partial tiles tile [0, n_partials) exactly
        cover = np.zeros(tp.n_partials, np.int64)
        for base, nseg in bases:
            cover[base:base + nseg] += 1
        assert (cover == 1).all()
        if seg == 1:
            assert tp.n_split > 0


@pytest.mark.parametrize("name", ["fixed", "bigbird"])
def test_path_layouts_fill_and_splits(name):
    """At the path's layouts (S 16384, 16 heads) each side computes at
    least 90 % live pairs and every live pair is covered once (counted).
    Only lists longer than 1 / SPLIT_SHARE of a side's tiles are cut: at
    Fixed none (the longest, 256 tiles, against 142,352), at BigBird the
    dK/dV side's column 0 (256 tiles against 14,064) into 3 or more."""
    cfg = _path_layouts()[name]
    plan = T.cached_plan(cfg, 16384, True, "cpu")
    tps = plan.tile_plans(cfg.block)
    for side, tp in tps.items():
        assert tp.fill >= 0.9, (side, tp.fill)
        words = tp.tiles[:, 4].astype(np.uint32)
        bits = np.unpackbits(words.view(np.uint8)).reshape(-1, 32)
        live = int(bits[:, :16].sum())     # little-endian: low 16 bits
        assert live == tp.live_pairs == plan.live
        assert tp.items[:, 3].max() <= tp.segment
        assert tp.segment == max(TB.SEGMENT_TILES,
                                 -(-len(tp.tiles) // TB.SPLIT_SHARE))
    if name == "fixed":
        assert tps["dq"].n_split == tps["dkv"].n_split == 0
    else:
        assert tps["dq"].n_split == 0 and tps["dkv"].n_split > 0
        assert tps["dkv"].items[:, 6].max() >= 3


def test_plan_does_not_depend_on_B(monkeypatch):
    """The tile plan is the layout's: two plans of one layout are equal;
    a launch at B 3 passes the same plan arrays as at B 1, three times the
    workspace and counters, and B 3."""
    monkeypatch.setattr(TB, "SEGMENT_TILES", 1)     # splits: a workspace
    lay, S = _layouts()["variable_b32"]
    a = TB.BlockSparsePlan(lay, True).tile_plans(32)
    b = TB.BlockSparsePlan(lay, True).tile_plans(32)
    for side in ("dq", "dkv"):
        for f in ("items", "own", "tiles"):
            np.testing.assert_array_equal(getattr(a[side], f),
                                          getattr(b[side], f))
    calls, asked = _stub(monkeypatch)
    plan = TB.BlockSparsePlan(lay, True)
    for B in (1, 3):
        x, rows = _zeros(B, S, 2, 64, torch.bfloat16)
        TB.block_sparse_attention_dq_cuda(x, x, x, x, rows, rows, plan)
    (n1, i1), (n3, i3) = calls
    assert i1[1:] == i3[1:] and (i1[0], i3[0]) == (1, 3)
    assert asked[1] == (3 * asked[0][0], 3 * asked[0][1])
    assert asked[0][1] == a["dq"].n_split > 0


# ------------------------------------------------------------ the walk
def _gather(x, ids, kw):
    """[B, n_sub, kw, hd] rows of sub-blocks ``ids`` (-1: zeros, as an
    empty slot lands by TMA) -> [B, len(ids) * kw, hd]."""
    B, _, _, hd = x.shape
    out = torch.zeros(B, len(ids), kw, hd)
    for j, i in enumerate(ids):
        if i >= 0:
            out[:, j] = x[:, i]
    return out.reshape(B, -1, hd)


def _mask(word, g, kw, keys_rows):
    """The live word as a [64, 64] boolean mask: live pairs, with the
    causal triangle inside diagonal pairs (dQ: keys after the query;
    dK/dV, rows keys: queries before the key)."""
    m = torch.zeros(g * kw, g * kw, dtype=torch.bool)
    tri = torch.ones(kw, kw, dtype=torch.bool)
    tri = tri.tril() if not keys_rows else tri.triu()
    for o in range(g):
        for s in range(g):
            bit = o * g + s
            if (word >> bit) & 1:
                blk = tri if (word >> (16 + bit)) & 1 else torch.ones_like(tri)
                m[o * kw:(o + 1) * kw, s * kw:(s + 1) * kw] = blk
    return m


def tile_walk(q, k, v, do, lse, dsum, plan, sm_scale=None):
    """The bf16 kernels' arithmetic over the tile plan, in fp32 torch:
    per work item its own tile's rows against its gathered streamed
    tiles, P and dS masked by the live words, each split unit's segment
    partials summed in segment order, rows of no item zero -> (dq, dk,
    dv)."""
    B, S, H, hd = q.shape
    block = S // plan.n
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    tps = plan.tile_plans(block)
    outs = {}
    for side, tp in tps.items():
        kw, g = tp.kw, tp.g
        na = 2 if side == "dkv" else 1
        acc = torch.zeros(na, B, S, H, hd)
        parts = {}

        def sub(x, h):
            return x[:, :, h].float().reshape(B, S // kw, kw, hd)

        def rows(t, h):
            return t[:, h].float().reshape(B, S // kw, kw)
        for it in tp.items[:tp.n_live]:
            own_i, h, first, count, split, seg, nseg = (int(x)
                                                        for x in it[:7])
            own = tp.own[own_i, :g].tolist()
            part = torch.zeros(na, B, g * kw, hd)
            for t in range(first, first + count):
                strm = tp.tiles[t, :g].tolist()
                m = _mask(int(tp.tiles[t, 4]) & 0xFFFFFFFF, g, kw,
                          side == "dkv")
                if side == "dq":
                    qo, doo = (_gather(sub(x, h), own, kw) for x in (q, do))
                    l2 = _gather(rows(lse, h)[..., None], own, kw)[..., 0]
                    ds_ = _gather(rows(dsum, h)[..., None], own, kw)[..., 0]
                    ks, vs = (_gather(sub(x, h), strm, kw) for x in (k, v))
                    s = qo @ ks.transpose(1, 2) * scale
                    p = torch.where(m, torch.exp(s - l2[..., None]),
                                    torch.zeros_like(s))
                    dp = doo @ vs.transpose(1, 2)
                    ds = torch.where(m, p * (dp - ds_[..., None]),
                                     torch.zeros_like(s))
                    part[0] += ds @ ks
                else:
                    ko, vo = (_gather(sub(x, h), own, kw) for x in (k, v))
                    qs, dos = (_gather(sub(x, h), strm, kw) for x in (q, do))
                    l2 = _gather(rows(lse, h)[..., None], strm, kw)[..., 0]
                    ds_ = _gather(rows(dsum, h)[..., None], strm, kw)[..., 0]
                    st = ko @ qs.transpose(1, 2) * scale
                    pt = torch.where(m, torch.exp(st - l2[:, None]),
                                     torch.zeros_like(st))
                    dpt = vo @ dos.transpose(1, 2)
                    dst = torch.where(m, pt * (dpt - ds_[:, None]),
                                      torch.zeros_like(st))
                    part[0] += dst @ qs
                    part[1] += pt @ dos
            if split >= 0:
                parts.setdefault((own_i, h), {})[seg] = part
                if len(parts[(own_i, h)]) < nseg:
                    continue
                total = torch.zeros_like(part)
                for s_ in range(nseg):      # segment order
                    total = total + parts[(own_i, h)][s_]
                part = total
            for j, r in enumerate(own):
                if r >= 0:
                    acc[:, :, r * kw:(r + 1) * kw, h] = \
                        part[:, :, j * kw:(j + 1) * kw]
        acc[0] *= scale
        outs[side] = acc
    return outs["dq"][0], outs["dkv"][0], outs["dkv"][1]


def tile_walk_fwd(q, k, v, plan, sm_scale=None):
    """The bf16 forward's arithmetic over the dQ side of the tile plan, in
    fp32 torch: per work item its own q rows against its gathered k / v
    tiles, the scores of pairs the live word does not mark (and of keys
    after the query inside a diagonal pair) -inf before the row max, an
    online softmax in log2 units (c = sm_scale * log2(e); running max m,
    sum l, o rescaled by 2^(m_old - m_new); a row that has seen no live key
    keeps base 0), each split unit's (o, m, l) partials combined in segment
    order (M = max m, o = sum o 2^(m - M), l alike), then o / l and lse =
    (M + log2 l) ln 2; rows of no item o = 0, lse = +inf -> (o, lse)."""
    B, S, H, hd = q.shape
    block = S // plan.n
    c = (hd ** -0.5 if sm_scale is None else sm_scale) * LOG2E
    tp = plan.tile_plan(block, "dq")
    kw, g = tp.kw, tp.g
    inf = float("inf")
    o = torch.zeros(B, S, H, hd)
    lse = torch.full((B, H, S), inf)
    parts = {}

    def sub(x, h):
        return x[:, :, h].float().reshape(B, S // kw, kw, hd)

    def base_of(m):
        return torch.where(m == -inf, torch.zeros_like(m), m)
    for it in tp.items[:tp.n_live]:
        own_i, h, first, count, split, seg, nseg = (int(x) for x in it[:7])
        own = tp.own[own_i, :g].tolist()
        qo = _gather(sub(q, h), own, kw)
        acc = torch.zeros(B, g * kw, hd)
        m = torch.full((B, g * kw), -inf)
        l = torch.zeros(B, g * kw)
        for t in range(first, first + count):
            strm = tp.tiles[t, :g].tolist()
            mask = _mask(int(tp.tiles[t, 4]) & 0xFFFFFFFF, g, kw, False)
            ks, vs = (_gather(sub(x, h), strm, kw) for x in (k, v))
            s = torch.where(mask, qo @ ks.transpose(1, 2),
                            torch.full((), -inf))
            m_new = torch.maximum(m, s.amax(-1) * c)
            base = base_of(m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s * c - base[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vs
            m = m_new
        if split >= 0:
            parts.setdefault((own_i, h), {})[seg] = (acc, m, l)
            if len(parts[(own_i, h)]) < nseg:
                continue
            segs = [parts[(own_i, h)][s_] for s_ in range(nseg)]
            m = torch.stack([x[1] for x in segs]).amax(0)
            base = base_of(m)
            acc, l = torch.zeros_like(acc), torch.zeros_like(l)
            for a_, m_, l_ in segs:          # segment order
                w_ = torch.exp2(m_ - base)
                acc = acc + a_ * w_[..., None]
                l = l + l_ * w_
        live = l > 0
        l1 = torch.where(live, l, torch.ones_like(l))
        out = torch.where(live[..., None], acc / l1[..., None],
                          torch.zeros_like(acc))
        rows_lse = torch.where(live, (m + torch.log2(l1)) * LN2,
                               torch.full_like(l, inf))
        for j, r in enumerate(own):
            if r >= 0:
                o[:, r * kw:(r + 1) * kw, h] = out[:, j * kw:(j + 1) * kw]
                lse[:, h, r * kw:(r + 1) * kw] = \
                    rows_lse[:, j * kw:(j + 1) * kw]
    return o, lse


def _inputs(B, S, H, hd, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd), dtype=np.float32)
            for _ in range(n)]


def _rows_of(q, k, v, do, plan, sm_scale=None):
    o, lse = TB.block_sparse_attention_fwd(q, k, v, plan, sm_scale)
    dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
    return lse, dsum


@pytest.mark.parametrize("seg", [32, 1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["fixed_b16", "bigbird_per_head_b32",
                                  "empty_rows_cols_b64", "fixed_b128",
                                  "fixed_b16_ragged"])
def test_tile_walk_matches_plain(monkeypatch, name, causal, seg):
    """The walk over the plan against the plain versions (fp32, 1e-5);
    seg 1 cuts every list of more than one streamed tile, so each such
    unit merges its partials."""
    monkeypatch.setattr(TB, "SEGMENT_TILES", seg)
    lay, S = _layouts()[name]
    H, hd = lay.shape[0], 16
    plan = TB.BlockSparsePlan(lay, causal)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, S, H, hd, 21))
    lse, dsum = _rows_of(q, k, v, do, plan)
    got = tile_walk(q, k, v, do, lse, dsum, plan)
    want = (TB.block_sparse_attention_dq_plain(q, k, v, do, lse, dsum,
                                               plan),
            *TB.block_sparse_attention_dkv_plain(q, k, v, do, lse, dsum,
                                                 plan))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
    if seg == 1:
        assert any(tp.n_split for tp in plan.tile_plans(S // plan.n)
                   .values())


@pytest.mark.parametrize("causal,sm_scale", [(False, None), (True, None),
                                             (True, 0.3)])
def test_tile_walk_matches_pallas(monkeypatch, causal, sm_scale):
    """The walk (with split units) against the JAX ``_bwd_call`` in
    interpret mode, given the reference's own lse and dsum."""
    monkeypatch.setattr(TB, "SEGMENT_TILES", 1)
    lay = T.BigBirdSparsityConfig(2, 16, different_layout_per_head=True,
                                  num_random_blocks=2,
                                  num_sliding_window_blocks=3,
                                  num_global_blocks=1, seed=7).make_layout(
                                      128)
    q, k, v, do = _inputs(2, 128, 2, 16, seed=2)
    kv_idx, kv_cnt, _ = JB._plan(lay, causal)
    q_idx, q_cnt, _ = JB._plan_transpose(lay, causal)
    args = [jnp.asarray(a) for a in (kv_idx, kv_cnt, q_idx, q_cnt)]
    qt, kt, vt, dot = (jnp.asarray(x).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    o, lse = JB._call(qt, kt, vt, args[0], args[1], causal=causal, block=16,
                      sm_scale=sm_scale, interpret=True, with_lse=True)
    dsum = (dot * o).sum(-1, keepdims=True)
    dq, dk, dv, lse, dsum = (np.asarray(jax.block_until_ready(x)) for x in (
        *JB._bwd_call(qt, kt, vt, dot, lse, dsum, *args, causal=causal,
                      block=16, sm_scale=sm_scale, interpret=True),
        lse, dsum))
    plan = TB.BlockSparsePlan(lay, causal)
    assert plan.tile_plans(16)["dkv"].n_split > 0
    rows = [torch.from_numpy(x[..., 0].copy()) for x in (lse, dsum)]
    got = tile_walk(*(torch.from_numpy(x) for x in (q, k, v, do)), *rows,
                    plan, sm_scale)
    for a, b in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(a.numpy(), b.transpose(0, 2, 1, 3),
                                   rtol=0, atol=TOL)


def _lse_close(got, want, atol):
    """lse: +inf exactly where ``want`` has it, within ``atol`` elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert (got[np.isinf(got)] > 0).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("seg", [32, 1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["fixed_b16", "bigbird_per_head_b32",
                                  "empty_rows_cols_b64", "fixed_b128",
                                  "fixed_b16_ragged"])
def test_tile_walk_fwd_matches_plain(monkeypatch, name, causal, seg):
    """The forward's walk over the dQ side against the plain forward
    (fp32, 1e-5): o, and lse with +inf exactly on the rows of no live
    block; seg 1 cuts every list of more than one streamed tile, so each
    such unit combines its (o, m, l) partials."""
    monkeypatch.setattr(TB, "SEGMENT_TILES", seg)
    lay, S = _layouts()[name]
    H, hd = lay.shape[0], 16
    plan = TB.BlockSparsePlan(lay, causal)
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, S, H, hd, 23, n=3))
    o, lse = tile_walk_fwd(q, k, v, plan)
    po, plse = TB.block_sparse_attention_fwd_plain(q, k, v, plan)
    np.testing.assert_allclose(o.numpy(), po.numpy(), rtol=0, atol=TOL)
    _lse_close(lse, plse, TOL)
    if seg == 1:
        assert plan.tile_plan(S // plan.n, "dq").n_split > 0
    if name == "empty_rows_cols_b64" and causal:
        assert bool(torch.isinf(plse).any())


@pytest.mark.parametrize("causal,sm_scale", [(False, None), (True, None),
                                             (True, 0.3)])
def test_tile_walk_fwd_matches_pallas(monkeypatch, causal, sm_scale):
    """The forward's walk (with split units) against the JAX ``_call`` in
    interpret mode: o and lse."""
    monkeypatch.setattr(TB, "SEGMENT_TILES", 1)
    lay = T.BigBirdSparsityConfig(2, 16, different_layout_per_head=True,
                                  num_random_blocks=2,
                                  num_sliding_window_blocks=3,
                                  num_global_blocks=1, seed=7).make_layout(
                                      128)
    q, k, v = _inputs(2, 128, 2, 16, seed=4, n=3)
    kv_idx, kv_cnt, _ = JB._plan(lay, causal)
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    o, lse = (np.asarray(jax.block_until_ready(x)) for x in JB._call(
        qt, kt, vt, jnp.asarray(kv_idx), jnp.asarray(kv_cnt), causal=causal,
        block=16, sm_scale=sm_scale, interpret=True, with_lse=True))
    plan = TB.BlockSparsePlan(lay, causal)
    assert plan.tile_plan(16, "dq").n_split > 0
    got_o, got_lse = tile_walk_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   plan, sm_scale)
    np.testing.assert_allclose(got_o.numpy(), o.transpose(0, 2, 1, 3),
                               rtol=0, atol=FWD_TOL)
    _lse_close(got_lse, lse[..., 0], FWD_TOL)


# --------------------------------------------------------- the wrapper
def _stub(monkeypatch, rc=0, raw=None):
    """Stand in for the launch and the scratch: record (entry point,
    integer arguments) of each launch (and, into ``raw``, all its
    arguments) and (floats, counters) of each workspace asked for; zero
    the launch counts."""
    calls, asked = [], []
    ints = {"bsa_fwd_h": slice(10, 19), "bsa_dq_h": slice(12, 21),
            "bsa_dkv_h": slice(13, 22), "bsa_fwd": slice(8, 14),
            "bsa_dq": slice(10, 16), "bsa_dkv": slice(11, 17)}

    def launch(name, device, *args):
        assert len(args) == len(TB._ARGTYPES[name])
        calls.append((name, tuple(args[ints[name]])))
        if raw is not None:
            raw.append(args)
        return rc

    def scratch(device, n_floats, n_counters):
        asked.append((n_floats, n_counters))
        return (torch.zeros(max(n_floats, 1)),
                torch.zeros(max(n_counters, 1), dtype=torch.int32))
    monkeypatch.setattr(TB, "_launch", launch)
    monkeypatch.setattr(TB.build, "scratch", scratch)
    for name in ("fwd", "dq", "dkv"):
        monkeypatch.setattr(getattr(TB, f"block_sparse_attention_{name}"),
                            "launches", 0)
    return calls, asked


def _zeros(B, S, H, hd, dt):
    return torch.zeros(B, S, H, hd, dtype=dt), torch.zeros(B, H, S)


def _counts():
    return [getattr(TB, f"block_sparse_attention_{n}").launches
            for n in ("fwd", "dq", "dkv")]


@pytest.mark.parametrize("block,hd", [(16, 96), (32, 80), (64, 64),
                                      (128, 128)])
def test_bf16_takes_the_hopper_kernels(monkeypatch, block, hd):
    calls, asked = _stub(monkeypatch)
    monkeypatch.setattr(TB, "SEGMENT_TILES", 1)     # splits: a workspace
    S, B, H = 512, 2, 2
    lay = T.FixedSparsityConfig(H, block, num_local_blocks=2,
                                num_global_blocks=1,
                                attention="unidirectional").make_layout(S)
    plan = TB.BlockSparsePlan(lay, True)
    x, rows = _zeros(B, S, H, hd, torch.bfloat16)
    dq = TB.block_sparse_attention_dq_cuda(x, x, x, x, rows, rows, plan)
    dk, dv = TB.block_sparse_attention_dkv_cuda(x, x, x, x, rows, rows, plan)
    assert all(t.shape == x.shape and t.dtype == torch.bfloat16
               for t in (dq, dk, dv))
    assert _counts() == [0, 1, 1]
    tps = plan.tile_plans(block)
    want = []
    for side in ("dq", "dkv"):
        tp = tps[side]
        want.append((f"bsa_{side}_h", (B, S, H, hd, min(block, 64),
                                       len(tp.items), tp.n_live, tp.n_split,
                                       tp.n_partials)))
        per = (2 if side == "dkv" else 1) * 64 * hd
        assert asked[len(want) - 1] == (B * tp.n_partials * per,
                                        B * tp.n_split)
    assert calls == want
    assert tps["dkv"].n_split > 0


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("block,hd", [(16, 96), (32, 80), (64, 64),
                                      (128, 128)])
def test_bf16_forward_takes_the_hopper_kernel(monkeypatch, block, hd,
                                              with_lse):
    """bf16 forwards launch ``bsa_fwd_h`` over the dQ side of the tile
    plan, with a workspace of the forward's partials (o and the rows' max
    and sum); ``with_lse=False`` passes a null lse and returns None; a
    forward alone builds no dK/dV side."""
    raw = []
    calls, asked = _stub(monkeypatch, raw=raw)
    monkeypatch.setattr(TB, "SEGMENT_TILES", 1)     # splits: a workspace
    S, B, H = 512, 2, 2
    lay = T.FixedSparsityConfig(H, block, num_local_blocks=2,
                                num_global_blocks=1,
                                attention="unidirectional").make_layout(S)
    plan = TB.BlockSparsePlan(lay, True)
    x, _ = _zeros(B, S, H, hd, torch.bfloat16)
    o, lse = TB.block_sparse_attention_fwd_cuda(x, x, x, plan,
                                                with_lse=with_lse)
    assert o.shape == x.shape and o.dtype == torch.bfloat16
    assert (lse is None) == (not with_lse)
    if with_lse:
        assert lse.shape == (B, H, S) and lse.dtype == torch.float32
        assert raw[0][4] == lse.data_ptr()
    else:
        assert raw[0][4] is None
    assert raw[0][3] == o.data_ptr()
    assert _counts() == [1, 0, 0]
    assert set(plan._tiles) == {(block, "dq")}
    tp = plan.tile_plan(block, "dq")
    assert tp.n_split > 0
    assert calls == [("bsa_fwd_h", (B, S, H, hd, min(block, 64),
                                    len(tp.items), tp.n_live, tp.n_split,
                                    tp.n_partials))]
    assert asked == [(B * tp.n_partials * (64 * hd + 4 * 128),
                      B * tp.n_split)]
    assert TB.partial_floats("fwd", hd) == 64 * (hd + 8)
    # the plan pointers are the dQ side's, as the dQ kernel reads them
    items, own, tiles = tp.dev
    assert raw[0][5:8] == (items.data_ptr(), own.data_ptr(),
                           tiles.data_ptr())


@pytest.mark.parametrize("with_lse", [True, False])
def test_fp32_forward_takes_the_fma_kernel(monkeypatch, with_lse):
    """fp32 forwards launch ``bsa_fwd`` over the forward plan's lists and
    build no tile plan."""
    raw = []
    calls, asked = _stub(monkeypatch, raw=raw)
    S, B, H, hd, block = 512, 1, 2, 64, 32
    plan = TB.BlockSparsePlan(T.BigBirdSparsityConfig(H, block)
                              .make_layout(S), False)
    x, _ = _zeros(B, S, H, hd, torch.float32)
    o, lse = TB.block_sparse_attention_fwd_cuda(x, x, x, plan,
                                                with_lse=with_lse)
    assert o.dtype == torch.float32 and (lse is None) == (not with_lse)
    assert calls == [("bsa_fwd", (B, S, H, hd, block, plan.max_active))]
    assert raw[0][5:8] == (plan.kv_idx.data_ptr(), plan.kv_cnt.data_ptr(),
                           plan.q_order.data_ptr())
    assert (raw[0][4] is None) == (not with_lse)
    assert asked == [] and plan._tiles == {} and _counts() == [1, 0, 0]


def test_forward_and_backward_share_the_dq_side(monkeypatch):
    """A bf16 forward, then the backward: the dQ kernel reads the very
    tile plan the forward built (one "dq" side), dK/dV adds its own."""
    raw = []
    calls, _ = _stub(monkeypatch, raw=raw)
    plan = TB.BlockSparsePlan(np.tril(np.ones((2, 8, 8), np.int64)), True)
    x, rows = _zeros(1, 128, 2, 64, torch.bfloat16)
    TB.block_sparse_attention_fwd_cuda(x, x, x, plan)
    dq_side = plan._tiles[(16, "dq")]
    TB.block_sparse_attention_dq_cuda(x, x, x, x, rows, rows, plan)
    TB.block_sparse_attention_dkv_cuda(x, x, x, x, rows, rows, plan)
    assert plan.tile_plan(16, "dq") is dq_side
    assert sorted(plan._tiles) == [(16, "dkv"), (16, "dq")]
    assert raw[0][5:8] == raw[1][6:9]      # items, own, tiles
    assert [c[0] for c in calls] == ["bsa_fwd_h", "bsa_dq_h", "bsa_dkv_h"]
    with pytest.raises(ValueError, match="side"):
        plan.tile_plan(16, "fwd")


@pytest.mark.parametrize("block", [16, 128])
def test_fp32_takes_the_fma_kernels(monkeypatch, block):
    calls, asked = _stub(monkeypatch)
    S, B, H, hd = 512, 1, 2, 64
    lay = T.BigBirdSparsityConfig(H, block).make_layout(S)
    plan = TB.BlockSparsePlan(lay, False)
    x, rows = _zeros(B, S, H, hd, torch.float32)
    TB.block_sparse_attention_dq_cuda(x, x, x, x, rows, rows, plan)
    TB.block_sparse_attention_dkv_cuda(x, x, x, x, rows, rows, plan)
    assert calls == [
        ("bsa_dq", (B, S, H, hd, block, plan.max_active)),
        ("bsa_dkv", (B, S, H, hd, block, plan.max_q))]
    assert asked == [] and _counts() == [0, 1, 1]


def test_refusals_come_before_any_launch(monkeypatch):
    calls, asked = _stub(monkeypatch)
    plan = TB.BlockSparsePlan(np.ones((2, 4, 4), np.int64), True)
    for S, hd, dt in ((32, 64, torch.bfloat16),      # block 8
                      (64, 32, torch.bfloat16),      # head_dim 32
                      (64, 64, torch.float16)):      # fp16
        x, rows = _zeros(1, S, 2, hd, dt)
        for fn in (TB.block_sparse_attention_dq_cuda,
                   TB.block_sparse_attention_dkv_cuda):
            with pytest.raises(NotImplementedError, match="no CUDA kernel"):
                fn(x, x, x, x, rows, rows, plan)
        with pytest.raises(NotImplementedError, match="no CUDA kernel"):
            TB.block_sparse_attention_fwd_cuda(x, x, x, plan)
    x, rows = _zeros(1, 64, 2, 64, torch.bfloat16)
    bad = torch.zeros(1, 64, 2, 66, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="strides"):
        TB.block_sparse_attention_dkv_cuda(x, x, x, bad, rows, rows, plan)
    with pytest.raises(ValueError, match="strides"):
        TB.block_sparse_attention_fwd_cuda(x, bad, x, plan, with_lse=False)
    with pytest.raises(ValueError, match="dsum"):
        TB.block_sparse_attention_dq_cuda(x, x, x, x, rows, rows[0], plan)
    with pytest.raises(ValueError, match="lse"):
        TB.block_sparse_attention_dkv_cuda(x, x, x, x, rows.double(), rows,
                                           plan)
    assert calls == [] and asked == [] and _counts() == [0, 0, 0]
    assert plan._tiles == {}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_failed_launch_raises(monkeypatch, dtype):
    calls, _ = _stub(monkeypatch, rc=700)
    plan = TB.BlockSparsePlan(np.tril(np.ones((2, 4, 4), np.int64)), True)
    x, rows = _zeros(1, 64, 2, 64, dtype)
    sfx = "_h" if dtype == torch.bfloat16 else ""
    with pytest.raises(RuntimeError, match=f"bsa_dq{sfx} launch failed"):
        TB.block_sparse_attention_dq_cuda(x, x, x, x, rows, rows, plan)
    with pytest.raises(RuntimeError, match=f"bsa_dkv{sfx} launch failed"):
        TB.block_sparse_attention_dkv_cuda(x, x, x, x, rows, rows, plan)
    with pytest.raises(RuntimeError, match=f"bsa_fwd{sfx} launch failed"):
        TB.block_sparse_attention_fwd_cuda(x, x, x, plan)
    assert len(calls) == 3 and _counts() == [0, 0, 0]
