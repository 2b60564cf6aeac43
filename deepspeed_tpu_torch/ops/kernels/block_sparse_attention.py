"""Block-sparse attention: forward, dQ and dK/dV over a block layout's
live blocks only.

Port of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``: the
forward ``_kernel`` (launcher ``_call``), the backward ``_dq_kernel`` and
``_dkv_kernel`` (launcher ``_bwd_call``), the plans ``_plan`` /
``_plan_transpose``, ``block_sparse_attention_trainable`` (the custom VJP,
here :class:`BlockSparseAttention`) and ``block_sparse_attention`` (the
forward alone, no lse).  For CUDA tensors the three wrappers launch the
kernels of ``csrc/block_sparse_attention.cu`` (bf16 on the Hopper kernels
over a tile plan, fp32 on the FMA kernels over the plan's lists); for CPU
tensors they take their plain versions.

Layouts (the reference's public ones): q/k/v [B, S, H, hd], a 0/1 layout
[H, S // block, S // block] -> o [B, S, H, hd] in the input dtype and lse
[B, H, S] fp32, ``+inf`` on a row with no live block (so exp(s - lse) = 0
and its gradients vanish; the flash kernels' -1e30 is another convention
and is not shared).  A row with no live block emits o = 0, and a kv block
no query attends gets dk = dv = 0, exactly.

The plan is config, not data: :class:`BlockSparsePlan` builds it once on
the host (vectorised numpy, the reference's arrays exactly) and keeps its
int32 tensors on the device, so a call copies nothing to the card and
waits on nothing.  Beside the reference's arrays it holds each side's
blocks ordered by list length (longest first), which the fp32 kernels use
to group blocks of like work into one CTA and to start the longest first,
and per block size the bf16 kernels' tile plans (:class:`TilePlan`: own
tiles of 64 rows, streamed tiles of gathered listed blocks with their live
pairs, work items longest first, long lists cut into segments merged in a
fixed order), each side built at its first use: the forward and dQ walk
the "dq" side, dK/dV the "dkv" side.

The plain versions walk the same plan: each head's live (q-block,
kv-block) pairs are gathered, the diagonal block masked causally, the
softmax (or its backward) taken in fp32 and summed back per block.  They
never read a block outside the plan, so ``inf`` in a masked block cannot
reach them, and their memory scales with the live blocks of one head.
"""
import ctypes
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels import build

#: what the CUDA kernels take; anything else on a CUDA tensor raises
#: NotImplementedError naming the ROADMAP item that would bring it
BLOCKS = (16, 32, 64, 128)
HEAD_DIMS = (64, 80, 96, 128)
_REFUSED_ITEM = ("ROADMAP.md Queue C: Block-sparse shapes the reference "
                 "runs and the port refuses")
_DTYPES = (torch.float32, torch.bfloat16)


# -------------------------------------------------------------------- plans

def _plan(layout: np.ndarray, causal: bool):
    """[H, nq, nk] 0/1 block layout -> (kv_idx [H, nq, max_active] int32,
    kv_cnt [H, nq] int32, max_active): each row's live blocks ascending,
    padded with its last live block (0 for an empty row) — the reference's
    arrays exactly, built without a Python loop over rows."""
    layout = np.asarray(layout)
    if causal:
        layout = np.tril(layout)
    H, nq, nk = layout.shape
    cnt = layout.sum(-1).astype(np.int32)                    # [H, nq]
    max_active = max(int(cnt.max()), 1)
    flat_cnt = cnt.reshape(-1).astype(np.int64)
    idx = np.zeros((H * nq, max_active), np.int32)
    h, q, col = np.nonzero(layout)                 # row-major: sorted rows
    rows = h.astype(np.int64) * nq + q
    starts = np.cumsum(flat_cnt) - flat_cnt
    idx[rows, np.arange(len(rows)) - starts[rows]] = col
    last = idx[np.arange(H * nq), np.maximum(flat_cnt - 1, 0)]
    pad = np.arange(max_active)[None, :] >= flat_cnt[:, None]
    idx = np.where(pad, last[:, None], idx).astype(np.int32)
    return idx.reshape(H, nq, max_active), cnt, max_active


def _plan_transpose(layout: np.ndarray, causal: bool):
    """Column-wise plan: for each KV block, which q blocks attend it —
    exactly ``_plan`` of the (tril'd) transposed layout.
    -> (q_idx [H, nk, max_q] int32, q_cnt [H, nk] int32, max_q)."""
    layout = np.asarray(layout)
    if causal:
        layout = np.tril(layout)
    return _plan(layout.transpose(0, 2, 1), causal=False)


def _live_pairs(idx: np.ndarray, cnt: np.ndarray, h: int):
    """Head h's live (row block, listed block) pairs, row-major."""
    live = np.arange(idx.shape[-1])[None, :] < cnt[h][:, None]
    return np.nonzero(live)[0], idx[h][live]


# ---------------------------------------------------------------- tile plans
#: rows of an own tile and of a streamed tile of the bf16 kernels
TILE_ROWS = 64
#: the shortest segment a list is cut into, in streamed tiles: a unit with
#: a longer list than a side's segment length (:func:`segment_tiles`) is
#: cut into segments at fixed list positions, each writes fp32 partials,
#: and the last to arrive sums them in segment order (so the cut, and the
#: bits, follow the layout alone)
SEGMENT_TILES = 32
#: a list is cut only where it is longer than 1 / SPLIT_SHARE of its
#: side's streamed tiles: half the share of one of the 264 consumer
#: warpgroups of a 132-SM H100 at B 1, under which the longest-first order
#: evens the consumers out and a split only adds its partials' traffic
#: (a constant, not the card's count, so that the cut follows the layout)
SPLIT_SHARE = 512


def segment_tiles(n_tiles: int) -> int:
    """A side's segment length for ``n_tiles`` streamed tiles in all."""
    return max(SEGMENT_TILES, -(-n_tiles // SPLIT_SHARE))


def sub_layout(lay: np.ndarray, block: int, causal: bool) -> np.ndarray:
    """A tril'd (when causal) bool [H, n, n] block layout at ``block`` as
    the layout of its sub-blocks of ``min(block, 64)`` rows: each block of
    128 as 2 x 2 sub-blocks, tril'd again when causal (the diagonal
    block's upper sub-block is fully masked); smaller blocks as they
    are."""
    if block <= TILE_ROWS:
        return lay
    f = block // TILE_ROWS
    out = np.kron(lay, np.ones((1, f, f), bool))
    return np.tril(out) if causal else out


class TilePlan:
    """One side of the bf16 kernels' tile plan: what each work item's
    consumer warpgroup computes, as int32 arrays.  The forward and dQ walk
    the "dq" side, dK/dV the "dkv" side.

    A side's rows are its own blocks (q blocks for the forward and dQ, kv
    blocks for dK/dV) and its lists the blocks each attends or is attended
    by, all in
    sub-blocks of ``kw = min(block, 64)`` rows (:func:`sub_layout`), ``g =
    64 // kw`` to a 64-row tile.

    - ``own`` [U, 4]: own tiles, each up to g own sub-blocks (-1: an empty
      slot, staged as zeros).  Per head, the sub-blocks with a list are
      taken g at a time in row order (dQ: contiguous q blocks, whose lists
      are nearly the same; the forward's too) or by list length, longest
      first (dK/dV: like
      lists together); those with none after them, in tiles of their own.
    - ``tiles`` [T, 8]: streamed tiles, the sorted union of an own tile's
      lists cut g sub-blocks at a time (-1 past its end), then the live
      word: bit ``o * g + s`` when own slot o and streamed slot s are a
      live pair, bit ``16 + o * g + s`` when that pair is on the diagonal
      and causal (masked inside).  An own tile's streamed tiles are
      consecutive.
    - ``items`` [I, 8]: (own tile, head, its first streamed tile, how
      many, split unit or -1, segment, segments, first partial tile of
      the split unit), longest first (stable); the first ``n_live`` walk
      streamed tiles.  An own tile with more than ``segment`` streamed
      tiles (:func:`segment_tiles` of the side's) is cut into segments at
      fixed positions; an own tile with no list is one item of no
      streamed tile (it writes zeros).
    - ``n_split`` split units and ``n_partials`` partial tiles for one
      batch row: the workspace and counters a launch takes.
    - ``live_pairs`` (== the layout's live sub-block pairs, each covered
      once), ``computed_pairs`` (streamed tiles x g x g) and ``fill``.
    - ``dev``: (items, own, tiles) as int32 tensors on ``device``.

    Built from the layout alone: not from B, S beyond the layout, or the
    card."""

    def __init__(self, lay: np.ndarray, causal: bool, kw: int,
                 by_length: bool, device="cpu"):
        g = TILE_ROWS // kw
        self.kw, self.g = kw, g
        cnt = lay.sum(-1)                                   # [H, n]
        own, own_head = _own_tiles(cnt, g, by_length)
        # the union of each own tile's lists: [U, n]
        valid = own[:, :g] >= 0
        rows = lay[own_head[:, None], np.maximum(own[:, :g], 0)]  # [U,g,n]
        rows &= valid[..., None]
        union = rows.any(1)
        tile_of, col = np.nonzero(union)                    # sorted by tile
        length = union.sum(1)
        n_str = (length + g - 1) // g                       # per own tile
        first = np.cumsum(n_str) - n_str
        pos = np.arange(len(col)) - (np.cumsum(length) - length)[tile_of]
        sid = first[tile_of] + pos // g
        slot = pos % g
        T = int(n_str.sum())
        tiles = np.zeros((T, 8), np.int64)
        tiles[:, :4] = -1
        tiles[sid, slot] = col
        # live and diagonal bits of each entry against each own slot
        live = rows[tile_of, :, col]                        # [E, g]
        bit = np.arange(g)[None, :] * g + slot[:, None]
        word = (live.astype(np.int64) << bit).sum(1)
        if causal:
            diag = live & (own[tile_of, :g] == col[:, None])
            word += (diag.astype(np.int64) << (bit + 16)).sum(1)
        np.add.at(tiles[:, 4], sid, word)
        self.live_pairs = int(lay.sum())
        self.computed_pairs = T * g * g
        self.fill = self.live_pairs / max(self.computed_pairs, 1)
        self.segment = segment_tiles(T)
        self.items, self.n_split, self.n_partials = _items(
            own_head, first, n_str, self.segment)
        self.n_live = int((self.items[:, 3] > 0).sum())
        self.own = own.astype(np.int32)
        self.tiles = tiles.astype(np.int32)
        self.dev = tuple(torch.from_numpy(a).to(device)
                         for a in (self.items, self.own, self.tiles))


def _own_tiles(cnt: np.ndarray, g: int, by_length: bool):
    """Own tiles of g row blocks each: per head the rows with a list, in
    row order or by length (longest first, stable), then the rows with
    none -> (own [U, 4] with -1 in empty slots, own_head [U])."""
    H, n = cnt.shape
    h = np.repeat(np.arange(H), n)
    r = np.tile(np.arange(n), H)
    c = cnt.reshape(-1)
    dead = (c == 0).astype(np.int64)
    keys = (r, -c if by_length else np.zeros_like(c), dead, h)
    idx = np.lexsort(keys)
    grp = (h * 2 + dead)[idx]                  # (head, no list): sorted
    size = np.bincount(grp, minlength=2 * H)
    pos = np.arange(len(idx)) - (np.cumsum(size) - size)[grp]
    per = (size + g - 1) // g
    tile = (np.cumsum(per) - per)[grp] + pos // g
    own = np.full((int(per.sum()), 4), -1, np.int64)
    own[tile, pos % g] = r[idx]
    return own, np.repeat(np.arange(2 * H) // 2, per)


def _items(own_head, first, n_str, segment):
    """Work items of the own tiles, a list of more than ``segment``
    streamed tiles cut into the fewest near-equal segments of at most that
    many, longest first -> (items [I, 8], n_split, n_partials)."""
    nseg = np.maximum((n_str + segment - 1) // segment, 1)
    step = (n_str + nseg - 1) // nseg          # near-equal segments
    u = np.repeat(np.arange(len(n_str)), nseg)
    seg = np.arange(len(u)) - (np.cumsum(nseg) - nseg)[u]
    start = seg * step[u]
    count = np.minimum(n_str[u] - start, step[u])
    is_split = nseg > 1
    split_id = np.where(is_split, np.cumsum(is_split) - 1, -1)
    ws_base = np.cumsum(np.where(is_split, nseg, 0)) - np.where(
        is_split, nseg, 0)
    items = np.stack([u, own_head[u], first[u] + start, count,
                      split_id[u], seg, nseg[u],
                      np.where(is_split, ws_base, 0)[u]], axis=1)
    items = items[np.argsort(-count, kind="stable")]
    return (items.astype(np.int32), int(is_split.sum()),
            int(nseg[is_split].sum()))


class BlockSparsePlan:
    """A layout's forward plan (``_plan``) and transposed plan
    (``_plan_transpose``) as int32 tensors on ``device``, with each side's
    block order (list length descending, stable) for the kernels.
    Counts for the bounds: ``live`` live blocks over all heads and
    ``live_diag`` of them on the diagonal (half-masked when causal).  The
    bf16 kernels' tile plans (:meth:`tile_plan`) are built a side at a
    time, at the side's first use."""

    def __init__(self, layout, causal: bool, device="cpu"):
        layout = np.asarray(layout)
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
            raise ValueError(f"block_sparse_attention: layout must be "
                             f"[H, n, n], got {layout.shape}")
        self.causal = bool(causal)
        self.device = torch.device(device)
        self.H, self.n = layout.shape[0], layout.shape[1]
        # a 0/1 layout as bool, tril'd once: the same plans as _plan and
        # _plan_transpose of the layout, at an eighth of the bytes
        lay = layout != 0
        if causal:
            lay = np.tril(lay)
        self.kv_idx_np, self.kv_cnt_np, self.max_active = _plan(lay, False)
        self.q_idx_np, self.q_cnt_np, self.max_q = _plan_transpose(lay,
                                                                   False)
        self.live = int(self.kv_cnt_np.sum())
        self.live_diag = int(np.trace(lay, axis1=1, axis2=2).sum())

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def order(cnt):
            return np.argsort(-cnt, axis=-1, kind="stable").astype(np.int32)
        self.kv_idx, self.kv_cnt = dev(self.kv_idx_np), dev(self.kv_cnt_np)
        self.device = self.kv_idx.device          # "cuda" -> "cuda:0"
        self.q_idx, self.q_cnt = dev(self.q_idx_np), dev(self.q_cnt_np)
        self.q_order = dev(order(self.kv_cnt_np))
        self.k_order = dev(order(self.q_cnt_np))
        self._pairs = {}
        self._lay = lay
        self._tiles = {}

    def tile_plan(self, block: int, side: str) -> TilePlan:
        """One side ("dq": the forward's and dQ's; "dkv") of the bf16
        kernels' tile plan at ``block`` on the plan's device, built once per
        (block, side) at its first use."""
        key = (block, side)
        if key not in self._tiles:
            lay = sub_layout(self._lay, block, self.causal)
            kw = min(block, TILE_ROWS)
            if side == "dq":
                tp = TilePlan(lay, self.causal, kw, False, self.device)
            elif side == "dkv":
                tp = TilePlan(lay.transpose(0, 2, 1), self.causal, kw, True,
                              self.device)
            else:
                raise ValueError(f"block_sparse_attention: no tile plan "
                                 f"side {side!r} (dq, dkv)")
            self._tiles[key] = tp
        return self._tiles[key]

    def tile_plans(self, block: int):
        """Both sides of the tile plan at ``block``: {"dq": TilePlan,
        "dkv": TilePlan} (each built at its first use)."""
        return {side: self.tile_plan(block, side) for side in ("dq", "dkv")}

    def pairs(self, device, transposed: bool):
        """Per head, the live pairs as int64 tensors on ``device``: (q
        block, kv block) of the forward plan, or (kv block, q block) of
        the transposed plan (the plain versions' index lists)."""
        key = (str(device), transposed)
        if key not in self._pairs:
            idx, cnt = ((self.q_idx_np, self.q_cnt_np) if transposed
                        else (self.kv_idx_np, self.kv_cnt_np))
            self._pairs[key] = [
                tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                      for a in _live_pairs(idx, cnt, h))
                for h in range(self.H)]
        return self._pairs[key]


def as_plan(layout, causal: bool, device) -> BlockSparsePlan:
    """A plan for ``layout`` (a plan passes through; its causality must
    match ``causal``)."""
    if isinstance(layout, BlockSparsePlan):
        if layout.causal != bool(causal):
            raise ValueError(f"block_sparse_attention: plan built with "
                             f"causal={layout.causal}, called with "
                             f"causal={causal}")
        return layout
    return BlockSparsePlan(layout, causal, device)


# ------------------------------------------------------------ plain versions

def _dims(q, k, v, plan):
    """(B, S, H, hd, block) after the shape rules every path shares."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"block_sparse_attention: q/k/v must share one "
                         f"[B, S, H, hd] shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if plan.H != H:
        raise ValueError(f"block_sparse_attention: layout has {plan.H} "
                         f"heads, q has {H}")
    if S % plan.n:
        raise ValueError(f"block_sparse_attention: S {S} not a multiple "
                         f"of the layout's {plan.n} blocks")
    if plan.device != q.device:
        raise ValueError(f"block_sparse_attention: plan on {plan.device}, "
                         f"q on {q.device}")
    return B, S, H, hd, S // plan.n


def _blocks(x, h, block):
    """Head h of [B, S, H, hd] as fp32 [B, S // block, block, hd]."""
    B, S, _, hd = x.shape
    return x[:, :, h].float().reshape(B, S // block, block, hd)


def _rows(t, h, block):
    """Head h of an fp32 [B, H, S] row tensor as [B, S // block, block]."""
    return t[:, h].float().reshape(t.shape[0], -1, block)


def _scores(qg, kg, qb, kb, scale, causal, block):
    """Scaled [B, E, block, block] scores of the gathered pairs, the
    diagonal block's upper triangle -inf when causal."""
    s = torch.einsum("beid,bejd->beij", qg, kg) * scale
    if causal:
        upper = torch.ones(block, block, dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill((qb == kb)[:, None, None] & upper, float("-inf"))
    return s


def block_sparse_attention_fwd_plain(q, k, v, plan, sm_scale=None,
                                     with_lse=True):
    """Plain PyTorch version of the forward kernel: (o, lse or None)."""
    B, S, H, hd, block = _dims(q, k, v, plan)
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    n = plan.n
    o = torch.zeros(B, S, H, hd, dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, S), float("inf"), dtype=torch.float32,
                     device=q.device)
    for h, (qb, kb) in enumerate(plan.pairs(q.device, False)):
        if qb.numel() == 0:
            continue
        s = _scores(_blocks(q, h, block)[:, qb], _blocks(k, h, block)[:, kb],
                    qb, kb, scale, plan.causal, block)
        idx = qb[None, :, None].expand(B, -1, block)
        m = torch.full((B, n, block), float("-inf"), device=q.device)
        m = m.scatter_reduce(1, idx, s.amax(-1), "amax")
        p = torch.exp(s - m[:, qb, :, None])
        l = torch.zeros(B, n, block, device=q.device).index_add_(
            1, qb, p.sum(-1))
        acc = torch.zeros(B, n, block, hd, device=q.device).index_add_(
            1, qb, torch.einsum("beij,bejd->beid", p,
                                _blocks(v, h, block)[:, kb]))
        live = l > 0
        l1 = torch.where(live, l, torch.ones_like(l))
        o[:, :, h] = torch.where(live[..., None], acc / l1[..., None],
                                 torch.zeros_like(acc)).reshape(B, S, hd)
        lse[:, h] = torch.where(live, m + torch.log(l1),
                                torch.full_like(l, float("inf"))
                                ).reshape(B, S)
    return o.to(q.dtype), (lse if with_lse else None)


def _probs_and_ds(q, k, v, do, lse, dsum, h, qb, kb, plan, scale, block):
    """P and dS = P (dO V^T - dsum) of head h's gathered pairs, fp32."""
    s = _scores(_blocks(q, h, block)[:, qb], _blocks(k, h, block)[:, kb],
                qb, kb, scale, plan.causal, block)
    p = torch.exp(s - _rows(lse, h, block)[:, qb, :, None])
    dp = torch.einsum("beid,bejd->beij", _blocks(do, h, block)[:, qb],
                      _blocks(v, h, block)[:, kb])
    return p, p * (dp - _rows(dsum, h, block)[:, qb, :, None])


def block_sparse_attention_dq_plain(q, k, v, do, lse, dsum, plan,
                                    sm_scale=None):
    """Plain PyTorch version of the dQ kernel (over the forward plan)."""
    B, S, H, hd, block = _dims(q, k, v, plan)
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    dq = torch.zeros(B, S, H, hd, dtype=torch.float32, device=q.device)
    for h, (qb, kb) in enumerate(plan.pairs(q.device, False)):
        if qb.numel() == 0:
            continue
        _, ds = _probs_and_ds(q, k, v, do, lse, dsum, h, qb, kb, plan,
                              scale, block)
        acc = torch.zeros(B, plan.n, block, hd, device=q.device).index_add_(
            1, qb, torch.einsum("beij,bejd->beid", ds,
                                _blocks(k, h, block)[:, kb]))
        dq[:, :, h] = (acc * scale).reshape(B, S, hd)
    return dq.to(q.dtype)


def block_sparse_attention_dkv_plain(q, k, v, do, lse, dsum, plan,
                                     sm_scale=None):
    """Plain PyTorch version of the dK/dV kernel (over the transposed
    plan): (dk, dv)."""
    B, S, H, hd, block = _dims(q, k, v, plan)
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    dk = torch.zeros(B, S, H, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for h, (kb, qb) in enumerate(plan.pairs(q.device, True)):
        if kb.numel() == 0:
            continue
        p, ds = _probs_and_ds(q, k, v, do, lse, dsum, h, qb, kb, plan,
                              scale, block)
        zeros = torch.zeros(B, plan.n, block, hd, device=q.device)
        dv[:, :, h] = zeros.index_add(1, kb, torch.einsum(
            "beij,beid->bejd", p, _blocks(do, h, block)[:, qb])
        ).reshape(B, S, hd)
        dk[:, :, h] = (zeros.index_add(1, kb, torch.einsum(
            "beij,beid->bejd", ds, _blocks(q, h, block)[:, qb]))
            * scale).reshape(B, S, hd)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- CUDA kernels

def _check_cuda(q, k, v, plan, extra=()):
    """The kernels' argument rules; returns (B, S, H, hd, block)."""
    B, S, H, hd, block = _dims(q, k, v, plan)
    if block not in BLOCKS or hd not in HEAD_DIMS or q.dtype not in _DTYPES:
        f16 = ("; fp16: ROADMAP.md Queue A: fp16 grouped and block-sparse "
               "kernels" if q.dtype == torch.float16 else "")
        raise NotImplementedError(
            f"block_sparse_attention: no CUDA kernel for block {block}, "
            f"head_dim {hd}, dtype {q.dtype} (blocks {BLOCKS}, head dims "
            f"{HEAD_DIMS}, dtypes float32 / bfloat16); the plain version "
            f"on CPU tensors takes any ({_REFUSED_ITEM}{f16})")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"block_sparse_attention: {name} is {t.dtype} "
                             f"on {t.device}, q {q.dtype} on {q.device}")
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"block_sparse_attention: {name} strides {t.stride()} need "
                f"a contiguous head dim and 16-byte aligned rows")
    return B, S, H, hd, block


def _check_rows(lse, dsum, B, H, S, q):
    rows = []
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"block_sparse_attention: {name} must be fp32 "
                             f"[B, H, S] = {(B, H, S)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
        rows.append(t.contiguous())
    return rows


_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_OLD_TAIL = [_I] * 6 + [_STRIDES, _I, ctypes.c_float]
_NEW_TAIL = [_I] * 9 + [_STRIDES, ctypes.c_float]
#: each C entry point's argument types, the stream after them
_ARGTYPES = {"bsa_fwd": [_P] * 8 + _OLD_TAIL,
             "bsa_dq": [_P] * 10 + _OLD_TAIL,
             "bsa_dkv": [_P] * 11 + _OLD_TAIL,
             "bsa_fwd_h": [_P] * 10 + _NEW_TAIL,
             "bsa_dq_h": [_P] * 12 + _NEW_TAIL,
             "bsa_dkv_h": [_P] * 13 + _NEW_TAIL}
_entries = {}


def _launch(name, device, *args):
    """Launch entry point ``name`` of ``csrc/block_sparse_attention.cu`` on
    ``device``'s current stream with ``args`` (its C arguments but the
    stream); returns its ``cudaError_t``."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.load("block_sparse_attention"), name)
        fn.argtypes = _ARGTYPES[name] + [_P]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _strides(*ts):
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _scale(hd, sm_scale):
    return float(hd ** -0.5 if sm_scale is None else sm_scale)


def _tail(B, S, H, hd, block, max_list, strides, plan, sm_scale):
    return (B, S, H, hd, block, max_list, strides, int(plan.causal),
            _scale(hd, sm_scale))


def partial_floats(kernel: str, hd: int) -> int:
    """The fp32 floats of one split segment's partial tile for ``kernel``
    ("fwd", "dq" or "dkv") at head dim ``hd``: dQ's 64 x hd accumulators,
    dK/dV's two, the forward's o and each of its 128 threads' four row
    values (two rows' max and sum)."""
    return {"fwd": TILE_ROWS * hd + 4 * 128, "dq": TILE_ROWS * hd,
            "dkv": 2 * TILE_ROWS * hd}[kernel]


def _hopper_args(tp, B, S, H, hd, q, kernel):
    """The bf16 kernels' plan, workspace and integer arguments for one
    side's tile plan: (items, own, tiles, ws, counters) pointers, then B, S,
    H, hd, kw, n_items, n_live, n_split, n_partials.  The workspace holds B x
    n_partials fp32 partial tiles (:func:`partial_floats` of ``kernel``),
    the counters B x n_split ints (``build.scratch``: 0, and each launch
    leaves them 0)."""
    per = partial_floats(kernel, hd)
    ws, counters = build.scratch(q.device, B * tp.n_partials * per,
                                 B * tp.n_split)
    items, own, tiles = tp.dev
    return ((items.data_ptr(), own.data_ptr(), tiles.data_ptr(),
             ws.data_ptr(), counters.data_ptr()),
            (B, S, H, hd, tp.kw, len(tp.items), tp.n_live, tp.n_split,
             tp.n_partials))


def block_sparse_attention_fwd_cuda(q, k, v, plan, sm_scale=None,
                                    with_lse=True):
    """Launch the forward kernel; raises on anything it does not take.
    q/k/v may be strided views with a contiguous head dim and 16-byte
    aligned rows.  bf16 runs the Hopper kernel over the plan's dQ tile
    plan (``bsa_fwd_h``), fp32 the FMA kernel over the forward plan
    (``bsa_fwd``); ``with_lse=False`` passes no lse and none is written.
    -> (o [B, S, H, hd], lse [B, H, S] fp32 or None)."""
    B, S, H, hd, block = _check_cuda(q, k, v, plan)
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr())
    strides = _strides(q, k, v)
    if q.dtype == torch.bfloat16:
        (items, own, tiles, ws, counters), ints = _hopper_args(
            plan.tile_plan(block, "dq"), B, S, H, hd, q, "fwd")
        rc = _launch("bsa_fwd_h", q.device, *ptrs, items, own, tiles, ws,
                     counters, *ints, strides, _scale(hd, sm_scale))
        build.check(rc, "bsa_fwd_h")
    else:
        rc = _launch("bsa_fwd", q.device, *ptrs, plan.kv_idx.data_ptr(),
                     plan.kv_cnt.data_ptr(), plan.q_order.data_ptr(),
                     *_tail(B, S, H, hd, block, plan.max_active, strides,
                            plan, sm_scale))
        build.check(rc, "bsa_fwd")
    block_sparse_attention_fwd.launches += 1
    return o, lse


def block_sparse_attention_dq_cuda(q, k, v, do, lse, dsum, plan,
                                   sm_scale=None):
    """Launch the dQ kernel -> dq [B, S, H, hd] in the input dtype: bf16
    on the Hopper kernel over the plan's dQ tile plan (``bsa_dq_h``), fp32
    on the FMA kernel over the forward plan (``bsa_dq``)."""
    B, S, H, hd, block = _check_cuda(q, k, v, plan, (("dO", do),))
    lse, dsum = _check_rows(lse, dsum, B, H, S, q)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr())
    strides = _strides(q, k, v, do)
    if q.dtype == torch.bfloat16:
        (items, own, tiles, ws, counters), ints = _hopper_args(
            plan.tile_plan(block, "dq"), B, S, H, hd, q, "dq")
        rc = _launch("bsa_dq_h", q.device, *ptrs, items, own, tiles,
                     dq.data_ptr(), ws, counters, *ints, strides,
                     _scale(hd, sm_scale))
        build.check(rc, "bsa_dq_h")
    else:
        rc = _launch("bsa_dq", q.device, *ptrs, plan.kv_idx.data_ptr(),
                     plan.kv_cnt.data_ptr(), plan.q_order.data_ptr(),
                     dq.data_ptr(),
                     *_tail(B, S, H, hd, block, plan.max_active, strides,
                            plan, sm_scale))
        build.check(rc, "bsa_dq")
    block_sparse_attention_dq.launches += 1
    return dq


def block_sparse_attention_dkv_cuda(q, k, v, do, lse, dsum, plan,
                                    sm_scale=None):
    """Launch the dK/dV kernel -> (dk, dv) [B, S, H, hd] in the input
    dtype: bf16 on the Hopper kernel over the plan's dK/dV tile plan
    (``bsa_dkv_h``), fp32 on the FMA kernel over the transposed plan
    (``bsa_dkv``)."""
    B, S, H, hd, block = _check_cuda(q, k, v, plan, (("dO", do),))
    lse, dsum = _check_rows(lse, dsum, B, H, S, q)
    dk = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr())
    strides = _strides(q, k, v, do)
    if q.dtype == torch.bfloat16:
        (items, own, tiles, ws, counters), ints = _hopper_args(
            plan.tile_plan(block, "dkv"), B, S, H, hd, q, "dkv")
        rc = _launch("bsa_dkv_h", q.device, *ptrs, items, own, tiles,
                     dk.data_ptr(), dv.data_ptr(), ws, counters, *ints,
                     strides, _scale(hd, sm_scale))
        build.check(rc, "bsa_dkv_h")
    else:
        rc = _launch("bsa_dkv", q.device, *ptrs, plan.q_idx.data_ptr(),
                     plan.q_cnt.data_ptr(), plan.k_order.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(),
                     *_tail(B, S, H, hd, block, plan.max_q, strides, plan,
                            sm_scale))
        build.check(rc, "bsa_dkv")
    block_sparse_attention_dkv.launches += 1
    return dk, dv


# ----------------------------------------------------------------- wrappers

def _route(q, cuda, plain, *args):
    if q.device.type == "cuda":
        return cuda(q, *args)
    if q.device.type == "cpu":
        return plain(q, *args)
    raise ValueError(f"block_sparse_attention: unsupported device "
                     f"{q.device}")


def block_sparse_attention_fwd(q, k, v, plan, sm_scale=None, with_lse=True):
    """(o, lse): the CUDA forward kernel for CUDA tensors, its plain
    version for CPU tensors (the reference's ``_call``)."""
    return _route(q, block_sparse_attention_fwd_cuda,
                  block_sparse_attention_fwd_plain, k, v, plan, sm_scale,
                  with_lse)


def block_sparse_attention_dq(q, k, v, do, lse, dsum, plan, sm_scale=None):
    """dq: the CUDA dQ kernel for CUDA tensors, its plain version for CPU
    tensors (``_bwd_call``'s first kernel)."""
    return _route(q, block_sparse_attention_dq_cuda,
                  block_sparse_attention_dq_plain, k, v, do, lse, dsum, plan,
                  sm_scale)


def block_sparse_attention_dkv(q, k, v, do, lse, dsum, plan, sm_scale=None):
    """(dk, dv): the CUDA dK/dV kernel for CUDA tensors, its plain version
    for CPU tensors (``_bwd_call``'s second kernel)."""
    return _route(q, block_sparse_attention_dkv_cuda,
                  block_sparse_attention_dkv_plain, k, v, do, lse, dsum,
                  plan, sm_scale)


#: kernel launches since the counts were last set to 0
block_sparse_attention_fwd.launches = 0
block_sparse_attention_dq.launches = 0
block_sparse_attention_dkv.launches = 0


class BlockSparseAttention(torch.autograd.Function):
    """Differentiable block-sparse attention (the reference's custom VJP
    in ``block_sparse_attention_trainable``): the forward kernel with lse,
    then dsum = rowsum(dO * O) in plain torch (an XLA op outside the
    kernels in the reference too), the dQ kernel over the forward plan and
    the dK/dV kernel over the transposed plan."""

    @staticmethod
    def forward(ctx, q, k, v, plan, sm_scale):
        o, lse = block_sparse_attention_fwd(q, k, v, plan, sm_scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plan, ctx.sm_scale = plan, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = block_sparse_attention_dq(q, k, v, do, lse, dsum, ctx.plan,
                                       ctx.sm_scale)
        dk, dv = block_sparse_attention_dkv(q, k, v, do, lse, dsum,
                                            ctx.plan, ctx.sm_scale)
        return dq, dk, dv, None, None


def block_sparse_attention_trainable(q, k, v, layout, causal: bool = False,
                                     sm_scale: Optional[float] = None):
    """Differentiable block-sparse attention, forward and backward on the
    block-skipping kernels.  ``layout``: a 0/1 [H, n, n] numpy layout (its
    plan is built on each call) or a :class:`BlockSparsePlan` (built once;
    :func:`~deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention`
    caches one per config)."""
    return BlockSparseAttention.apply(q, k, v,
                                      as_plan(layout, causal, q.device),
                                      sm_scale)


def block_sparse_attention(q, k, v, layout, causal: bool = False,
                           sm_scale: Optional[float] = None):
    """q/k/v [B, S, H, hd], layout [H, S // block, S // block] (0/1 numpy,
    or a plan) -> [B, S, H, hd]; the forward alone, writing no lse.
    Skipped blocks are never loaded or multiplied."""
    o, _ = block_sparse_attention_fwd(q, k, v,
                                      as_plan(layout, causal, q.device),
                                      sm_scale, with_lse=False)
    return o
