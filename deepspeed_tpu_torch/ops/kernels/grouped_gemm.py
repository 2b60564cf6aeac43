"""Grouped GEMM for routed experts (port of
``deepspeed_tpu/ops/pallas/grouped_gemm.py``): the megablocks-style
expert dispatch of the MoE layer's serving path.

Two forms, both against the stacked expert weights ``w`` [E, K, N] —
a float tensor, or int8 experts as a ``QuantizedTensor`` or a ``(q int8
[E, K, N], s fp32 [E, K, nb])`` pair in the ``block_quantize_int8``
layout (the reference wrappers' contract):

- :func:`ds_ggemm` — rows sorted by expert and padded per expert to a
  multiple of the M-tile (:func:`make_group_plan`,
  :func:`scatter_to_groups`, :func:`gather_from_groups`); each M-tile
  contracts against its expert's [K, N] slice.  The CUDA kernels
  (``csrc/grouped_gemm.cu``) ``ds_ggemm`` and, for int8 experts,
  ``ds_ggemm_q`` replace ``_ggemm_kernel`` (``grouped_gemm.py:163``,
  forward form) and ``_ggemm_q_kernel`` (``:200``).
- :func:`ds_ggemm_slots` — at most :data:`SLOT_MAX_ROWS` raw routed rows
  (no padding, no scatter): each DISTINCT routed expert's weights stream
  once (:func:`make_slot_plan`), and each row takes only its own
  expert's product.  The CUDA kernels ``ds_ggemm_slots`` and
  ``ds_ggemm_slots_q`` replace ``_slot_kernel`` (``grouped_gemm.py:433``)
  and ``_slot_q_kernel`` (``:452``).

The plans are plain torch ops on the tensors' device (XLA computed them
in the reference) with static shapes, so the decode path never waits on
the host: the kernels read ``block_group_ids`` / ``tile_rows`` and
``active`` / ``valid`` / ``row_order`` / ``slot_offsets`` from device
memory.  Each wrapper takes its plain version only for CPU tensors: for a
CUDA tensor it launches its kernel or raises.

The backward (the reference's ``_ggemm_diff`` custom VJP, :580-605):
:class:`GroupedGemm` is a ``torch.autograd.Function`` whose forward is
:func:`ds_ggemm` and whose backward runs ``ds_ggemm(dy, w, plan,
transpose_rhs=True)`` for dx (dy [Mp, N] against ``w[e]`` transposed:
``_ggemm_kernel``'s transposed-RHS form, :163) and :func:`ds_tgmm` for
dW (the per-expert sum of ``x_row^T dy_row``: ``_tgmm_kernel``, :222),
the CUDA kernels ``ds_ggemm_t`` and ``ds_tgmm`` on CUDA tensors and
their plain versions on CPU tensors; :func:`grouped_gemm` is the
differentiable entry point.  int8 experts have no backward: with
``transpose_rhs`` they raise ``ValueError``, as in the reference.

Routing by shape (:func:`hopper_route`, :func:`stream_route_q`): bf16
operands whose K and N are multiples of 8 on 16-byte aligned bases (TMA's
address rule) launch the Hopper wgmma / TMA kernels of
``csrc/grouped_gemm_hopper.cu`` (``ds_ggemm_h``, ``ds_ggemm_t_h``,
``ds_tgmm_h``) and, for the slot form, the streaming kernel of
``csrc/grouped_gemm_stream.cu`` (``ds_ggemm_slots_s``); int8 experts under
bf16 rows with K a multiple of 8, N of 16 and nb of 4 on aligned bases
launch ``ds_ggemm_q_s`` and, by slot, ``ds_ggemm_slots_q_s`` there (one
rule, :func:`stream_route_q`, for both; the slot form takes the group
form's K split and sum order, so a row's bits are the same in both).  fp32
operands and bf16 shapes outside those rules launch the kernels of
``csrc/grouped_gemm.cu``.  The choice is the shape's, never a fallback
after a failure: a failed launch raises either way.  The streaming
kernels' decomposition (units, K ranges, row passes) is written out here
too (:func:`slot_stream_splits`, :func:`slot_blocks`,
:func:`slot_stream_walk`, :func:`ggemm_q_stream_splits`,
:func:`ggemm_q_stream_walk`, :func:`slot_q_stream_walk`): the CPU tests
walk it in plain torch.

Numerics: fp32 accumulation (tensor cores for bf16, fmaf for fp32 — no
TF32), output rounded once to ``x``'s dtype, as the reference's kernels.
An int8 weight is dequantized in fp32 with the group width
``ceil(N / nb)`` of the unpadded N and rounded to ``x``'s dtype before
its product (the reference's ``_dequant_tile``).  ``<wrapper>.launches``
counts the float kernel's launches, ``<wrapper>.int8_launches`` the int8
kernel's, ``ds_ggemm.transpose_launches`` the transposed-RHS kernel's and
``ds_tgmm.launches`` the dW kernel's (the Hopper kernels for bf16, the
``layout_tile`` ones for fp32); bf16 launches that the shape rules sent to
``csrc/grouped_gemm.cu`` count on ``ds_ggemm.unaligned_launches``,
``ds_ggemm.unaligned_transpose_launches``, ``ds_tgmm.unaligned_launches``,
``ds_ggemm.unaligned_int8_launches``, ``ds_ggemm_slots.unaligned_launches``
and ``ds_ggemm_slots.unaligned_int8_launches`` instead.
"""
import ctypes
from typing import NamedTuple

import torch

from deepspeed_tpu_torch.models.model import quantized_parts
from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels.quantization import \
    block_dequantize_int8

#: the port's M-tile: the CUDA kernel's 64-row tile (the reference's
#: default is 128; the layout rule is the same for any ``block_m``)
DEFAULT_BLOCK_M = 64
#: rows at or below this ride the slot kernel (decode, short prefills);
#: above it the group-padded kernel (the reference's cut)
SLOT_MAX_ROWS = 128
#: the slot kernel's output columns per CTA and most K splits
#: (``csrc/grouped_gemm.cu`` kSlotBN, kSlotMaxSplit)
SLOT_BN = 128
SLOT_MAX_SPLIT = 16
#: the bf16 streaming slot kernel (``csrc/grouped_gemm_stream.cu``
#: slots::kBN, kBK, kRows): output columns a unit, K rows a stage, rows a
#: block (two 8-row passes); its K splits at most SLOT_MAX_SPLIT
STREAM_SLOT_BN, STREAM_SLOT_BK, STREAM_SLOT_ROWS = 256, 64, 16
#: the streaming int8 kernels (q8::kBN, kBK; sq8 the same): output
#: columns a unit, K rows a stage (four k16 slices); their K splits at
#: most STREAM_Q_MAX_SPLIT.  The slot form's blocks are the bf16 slot
#: kernel's (STREAM_SLOT_ROWS rows, one wgmma's N)
STREAM_Q_BN, STREAM_Q_BK, STREAM_Q_MAX_SPLIT = 256, 64, 8
_DTYPES = (torch.float32, torch.bfloat16)
#: fp16 is taken by the plain versions (CPU tensors) and refused on the
#: card, where the kernels have no fp16 form yet
FP16_ITEM = "ROADMAP.md Queue A: fp16 grouped and block-sparse kernels"


def _dtypes_for(t):
    """The dtypes the grouped GEMMs take for tensors on ``t``'s device:
    fp16 on the CPU only; an fp16 CUDA tensor raises NotImplementedError
    naming the queue item."""
    if t.dtype == torch.float16 and t.device.type == "cuda":
        raise NotImplementedError(
            "grouped GEMM: no fp16 form of the CUDA kernels yet "
            f"({FP16_ITEM}); train MoE models in bf16 or fp32")
    return _DTYPES + ((torch.float16,) if t.device.type == "cpu" else ())


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class GroupPlan(NamedTuple):
    """Static-shape layout of one routed batch (the reference's
    ``GroupPlan``; ``tile_rows`` is the port's addition).

    ``row_to_padded[f]`` maps flat routed element ``f`` (token-major,
    ``f = t * top_k + choice``) to its row of the group-padded array."""
    block_m: int                   # M-tile the layout is padded to
    padded_rows: int               # Mp = round_up(R, bm) + E * bm
    num_blocks: int                # Mp // bm
    num_experts: int               # E
    group_sizes: torch.Tensor      # [E] padded rows per expert (bm k, >= bm)
    block_group_ids: torch.Tensor  # [num_blocks] expert per M-tile
    row_to_padded: torch.Tensor    # [R] flat element -> padded row
    counts: torch.Tensor           # [E] routed rows per expert
    tile_rows: torch.Tensor        # [num_blocks] real rows per M-tile
    #                                (a prefix of the tile; 0 = all pad)


def make_group_plan(expert_ids, num_experts: int, block_m: int = None
                    ) -> GroupPlan:
    """``expert_ids`` [R] -> :class:`GroupPlan` (the reference's
    ``make_group_plan``): a stable argsort keeps token order within an
    expert, every expert keeps at least one tile, and the padded row count
    is static.  Device ops only, no host sync."""
    R = int(expert_ids.shape[0])
    E = int(num_experts)
    bm = int(block_m or DEFAULT_BLOCK_M)
    dev = expert_ids.device
    eids = expert_ids.to(torch.int64)
    order = torch.argsort(eids, stable=True)
    sorted_eids = eids[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, eids, torch.ones_like(eids))
    blocks_e = torch.clamp(-(-counts // bm), min=1)
    group_sizes = blocks_e * bm
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    pstart = torch.cat([zero, torch.cumsum(group_sizes, 0)])
    start = torch.cat([zero, torch.cumsum(counts, 0)])
    rank = torch.arange(R, device=dev) - start[sorted_eids]
    prow_sorted = pstart[sorted_eids] + rank
    row_to_padded = torch.empty(R, dtype=torch.int64, device=dev)
    row_to_padded[order] = prow_sorted
    padded_rows = _round_up(R, bm) + E * bm
    num_blocks = padded_rows // bm
    bidx = torch.arange(num_blocks, device=dev)
    gids = (bidx[:, None] >= torch.cumsum(blocks_e, 0)[None, :]).sum(1)
    gids = torch.clamp(gids, max=E - 1)
    # trailing tiles clamp to E - 1 past its group: no real rows
    tile_rows = torch.clamp(counts[gids] - (bidx * bm - pstart[gids]),
                            min=0, max=bm)
    i32 = torch.int32
    return GroupPlan(bm, padded_rows, num_blocks, E, group_sizes.to(i32),
                     gids.to(i32), row_to_padded.to(i32), counts.to(i32),
                     tile_rows.to(i32))


def scatter_to_groups(rows, plan: GroupPlan):
    """rows [R, D] (flat routed order) -> group-padded [Mp, D] (pad 0)."""
    out = torch.zeros((plan.padded_rows,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return out.index_copy_(0, plan.row_to_padded.long(), rows)


def gather_from_groups(padded, plan: GroupPlan):
    """group-padded [Mp, D] -> [R, D] rows in flat routed order."""
    return padded.index_select(0, plan.row_to_padded.long())


class SlotPlan(NamedTuple):
    """Decode-sized routing layout (the reference's ``SlotPlan``;
    ``row_order`` and ``slot_offsets`` are the port's addition: the rows
    of slot ``s`` are ``row_order[slot_offsets[s]:slot_offsets[s + 1]]``,
    so the kernel visits each row once, in its expert's slot)."""
    num_slots: int                 # S = min(R, E)
    active: torch.Tensor           # [S] distinct expert ids, ascending;
    #                                trailing slots repeat the last id
    valid: torch.Tensor            # [S] 1 real slot / 0 repeated slot
    eids_col: torch.Tensor         # [R, 1] row -> expert
    row_order: torch.Tensor        # [R] rows sorted by expert (stable)
    slot_offsets: torch.Tensor     # [S + 1] slot row ranges in row_order


def make_slot_plan(expert_ids, num_experts: int) -> SlotPlan:
    """``expert_ids`` [R] -> :class:`SlotPlan` (the reference's
    ``make_slot_plan``).  Device ops only, no host sync."""
    R = int(expert_ids.shape[0])
    S = min(R, int(num_experts))
    dev = expert_ids.device
    eids = expert_ids.to(torch.int64)
    order = torch.argsort(eids, stable=True)
    se = eids[order]
    first = torch.ones(R, dtype=torch.bool, device=dev)
    first[1:] = se[1:] != se[:-1]
    slot_of = torch.cumsum(first.to(torch.int64), 0) - 1      # [R]
    active = torch.zeros(S, dtype=torch.int64, device=dev)
    active[slot_of] = se
    nuniq = first.sum()
    valid = torch.arange(S, device=dev) < nuniq
    active = torch.where(valid, active, se[R - 1])
    per_slot = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(
        0, slot_of, torch.ones_like(slot_of))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(per_slot, 0)])
    i32 = torch.int32
    return SlotPlan(S, active.to(i32), valid.to(i32),
                    eids.to(i32)[:, None], order.to(i32), offsets.to(i32))


# ------------------------------------------------------------ plain versions
def ggemm_plain(x, w, plan: GroupPlan):
    """Per-group matmuls over the padded layout (the reference's
    ``_ref_ggemm``): expert e's padded rows @ ``w[e]``; trailing tiles past
    the last group give zeros.  Output in x's dtype."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    sizes = plan.group_sizes.tolist()
    r0 = 0
    for e, n in enumerate(sizes):
        out[r0:r0 + n] = x[r0:r0 + n] @ w[e].to(x.dtype)
        r0 += n
    return out


def ggemm_slots_plain(x, w, plan: SlotPlan):
    """Row-expert product (the reference's ``_ref_ggemm_rows``): one fp32
    matmul per expert, each row keeping its own expert's result; output in
    x's dtype."""
    eids = plan.eids_col[:, 0].long()
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    xf = x.float()
    for e in range(w.shape[0]):
        ye = xf @ w[e].float()
        out = torch.where((eids == e)[:, None], ye, out)
    return out.to(x.dtype)


def ggemm_t_plain(dy, w, plan: GroupPlan):
    """dx = ``dy`` [Mp, N] against ``w[e]`` transposed over each expert's
    padded rows (the reference's ``_ref_ggemm`` with ``transpose_rhs``):
    fp32 products, rounded once to dy's dtype; trailing tiles past the
    last group give zeros."""
    out = torch.zeros((dy.shape[0], w.shape[1]), dtype=dy.dtype,
                      device=dy.device)
    r0 = 0
    for e, n in enumerate(plan.group_sizes.tolist()):
        out[r0:r0 + n] = (dy[r0:r0 + n].float()
                          @ w[e].float().T).to(dy.dtype)
        r0 += n
    return out


def tgmm_plain(x, dy, plan: GroupPlan, out_dtype=None):
    """dW [E, K, N]: expert e's padded rows of ``x``, transposed, against
    the same rows of ``dy`` (the reference's ``_tgmm_kernel``), in fp32,
    rounded once to ``out_dtype`` (x's when None); an expert's padding
    rows are zeros in x, so only its routed rows add."""
    out = torch.zeros((plan.num_experts, x.shape[1], dy.shape[1]),
                      dtype=out_dtype or x.dtype, device=x.device)
    r0 = 0
    for e, n in enumerate(plan.group_sizes.tolist()):
        out[e] = (x[r0:r0 + n].float().T
                  @ dy[r0:r0 + n].float()).to(out.dtype)
        r0 += n
    return out


def dequant_experts(q, s, dtype):
    """int8 experts (q [E, K, N], s [E, K, nb]) as the kernels see them:
    dequantized in fp32 with the group width ceil(N / nb), rounded to
    ``dtype`` (x's)."""
    return block_dequantize_int8(q, s).to(dtype)


def ggemm_q_plain(x, q, s, plan: GroupPlan):
    """Plain version of the int8 group-padded form (the reference's
    ``_ref_ggemm_q``): the float plain version on the dequantized
    experts."""
    return ggemm_plain(x, dequant_experts(q, s, x.dtype), plan)


def ggemm_slots_q_plain(x, q, s, plan: SlotPlan):
    """Plain version of the int8 slot form (the reference's int8
    ``_ref_ggemm_rows`` branch, with the weight rounded to x's dtype as
    its ``_slot_q_kernel`` does)."""
    return ggemm_slots_plain(x, dequant_experts(q, s, x.dtype), plan)


# ------------------------------------------ the streaming kernels' walks
def slot_stream_splits(K: int, N: int, sms: int):
    """(nsplit, kper) of the bf16 streaming slot kernel: K cut into nsplit
    ranges of kper rows (a multiple of STREAM_SLOT_BK), enough units for
    one a multiprocessor at one block (a decode step's 8 blocks then give
    each CTA ~8 long units: more, shorter ones lost to their merges on an
    H100), at most SLOT_MAX_SPLIT and no range without a stage.  Depends
    on K, N and the SM count only, so a row's sums do not depend on R or
    the routing."""
    tiles = -(-N // STREAM_SLOT_BN)
    chunks = -(-K // STREAM_SLOT_BK)
    nsplit = max(1, min(-(-sms // tiles), SLOT_MAX_SPLIT, chunks))
    per = -(-chunks // nsplit)
    return -(-chunks // per), per * STREAM_SLOT_BK


def slot_block_bound(R: int, S: int) -> int:
    """The most blocks a slot plan of R rows in S slots can have (the
    kernel's merge counters are sized by it)."""
    return min(R, (R + (STREAM_SLOT_ROWS - 1) * S) // STREAM_SLOT_ROWS)


def slot_blocks(plan: SlotPlan, E: int):
    """The streaming slot kernel's blocks, in its order: each slot's rows
    ``row_order[slot_offsets[s]:]`` cut into blocks of at most
    STREAM_SLOT_ROWS, slots in order, as (expert or -1 outside [0, E),
    first row in row_order, rows, slot).  Host values (reads the plan)."""
    act, val = plan.active.tolist(), plan.valid.tolist()
    offs = plan.slot_offsets.tolist()
    out = []
    for s in range(plan.num_slots):
        c = max(offs[s + 1] - offs[s], 0) if val[s] else 0
        e = act[s] if 0 <= act[s] < E else -1
        for r in range(0, c, STREAM_SLOT_ROWS):
            out.append((e, offs[s] + r, min(STREAM_SLOT_ROWS, c - r), s))
    return out


def slot_stream_units(plan: SlotPlan, E: int, K: int, N: int, sms: int):
    """The kernel's work units in draw order (the STREAM_SLOT_BN-column
    N-tile fastest, then the block, then the K split), each (block, split,
    N-tile, K range)."""
    nsplit, kper = slot_stream_splits(K, N, sms)
    blocks = slot_blocks(plan, E)
    return [(b, sp, nt, (sp * kper, min(K, (sp + 1) * kper)))
            for sp in range(nsplit) for b in range(len(blocks))
            for nt in range(-(-N // STREAM_SLOT_BN))]


def _k_order_sum(acc, a, b, k0, k1):
    """acc (fp32) plus the products a[:, k] b[k] added one k at a time in K
    order, each element its own sum (no BLAS, whose sums may follow the
    row count)."""
    for k in range(k0, k1):
        acc = acc + a[:, k, None] * b[k][None, :]
    return acc


def slot_stream_walk(x, w, plan: SlotPlan, sms: int):
    """The streaming slot kernel's decomposition in plain torch: per unit,
    the block's rows in 8-row passes against W[e]'s 256 columns over the
    unit's K range in K order (fp32); each split's partial kept apart and
    the splits summed in order; one rounding to x's dtype.  Rows of an
    expert outside [0, E) get zeros."""
    R, K = x.shape
    E, _, N = w.shape
    nsplit = slot_stream_splits(K, N, sms)[0]
    blocks = slot_blocks(plan, E)
    order = plan.row_order.long()
    parts = torch.zeros(nsplit, R, N, dtype=torch.float32)
    for b, sp, nt, (k0, k1) in slot_stream_units(plan, E, K, N, sms):
        e, r0, nrow, _ = blocks[b]
        c0, c1 = nt * STREAM_SLOT_BN, min(N, (nt + 1) * STREAM_SLOT_BN)
        for p0 in range(0, nrow, 8):
            rows = order[r0 + p0:r0 + min(nrow, p0 + 8)]
            acc = torch.zeros(len(rows), c1 - c0, dtype=torch.float32)
            if e >= 0:
                acc = _k_order_sum(acc, x[rows].float(),
                                   w[e, :, c0:c1].float(), k0, k1)
            parts[sp, rows, c0:c1] = acc
    out = parts[0]
    for sp in range(1, nsplit):
        out = out + parts[sp]
    return out.to(x.dtype)


def ggemm_q_stream_splits(K: int, N: int, E: int, sms: int):
    """(nsplit, kper) of the streaming int8 kernel: K cut into nsplit
    ranges of kper rows (a multiple of STREAM_Q_BK), enough units for two
    a multiprocessor if each expert had one plan tile (Mixtral's out
    projection, 16 N-tiles x 8 experts, has 128 whole-K units for 132 SMs),
    at most STREAM_Q_MAX_SPLIT and no range without a stage.  Depends on
    K, N, E and the SM count only, so a row's sums do not depend on R or
    the routing."""
    units = -(-N // STREAM_Q_BN) * E
    chunks = -(-K // STREAM_Q_BK)
    nsplit = max(1, min(-(-2 * sms // units), STREAM_Q_MAX_SPLIT, chunks))
    per = -(-chunks // nsplit)
    return -(-chunks // per), per * STREAM_Q_BK


def _q_unit_sum(x, q, s, e, cols, qblock, k0, k1):
    """One int8 unit's fp32 partial: the rows ``x`` against W[e]'s columns
    ``cols`` dequantized in fp32 (group width ``qblock``) and rounded to
    x's dtype, the products added in K order over [k0, k1)."""
    wdq = (q[e][:, cols].float() * s[e][:, cols // qblock]).to(x.dtype)
    return _k_order_sum(torch.zeros(x.shape[0], len(cols)), x.float(),
                        wdq.float(), k0, k1)


def ggemm_q_stream_walk(x, q, s, plan: GroupPlan, sms: int):
    """The streaming int8 kernel's decomposition in plain torch: per unit
    (STREAM_Q_BN columns, plan tile, K split; N-tiles fastest), W[e]'s
    columns dequantized in fp32 with the group width ceil(N / nb) and
    rounded to x's dtype, the products added to the fp32 tile in K order
    over the split's range; the splits' partials summed in split order;
    one rounding to x's dtype; rows past the tile's real rows and tiles
    with none are zeros."""
    Mp, K = x.shape
    E, _, N = q.shape
    qblock = -(-N // s.shape[2])
    nsplit, kper = ggemm_q_stream_splits(K, N, E, sms)
    parts = torch.zeros(nsplit, Mp, N, dtype=torch.float32)
    gids, trows = plan.block_group_ids.tolist(), plan.tile_rows.tolist()
    bm = DEFAULT_BLOCK_M
    n_tiles = -(-N // STREAM_Q_BN)
    for u in range(plan.num_blocks * nsplit * n_tiles):
        nt, rest = u % n_tiles, u // n_tiles
        t, sp = rest % plan.num_blocks, rest // plan.num_blocks
        e = gids[t]
        rows = min(max(trows[t], 0), bm) if 0 <= e < E else 0
        if not rows:
            continue
        cols = torch.arange(nt * STREAM_Q_BN, min(N, (nt + 1) * STREAM_Q_BN))
        parts[sp, t * bm:t * bm + rows, cols] = _q_unit_sum(
            x[t * bm:t * bm + rows], q, s, e, cols, qblock, sp * kper,
            min(K, (sp + 1) * kper))
    out = parts[0]
    for sp in range(1, nsplit):
        out = out + parts[sp]
    return out.to(x.dtype)


def slot_q_stream_walk(x, q, s, plan: SlotPlan, sms: int):
    """The streaming int8 slot kernel's decomposition in plain torch: per
    unit (STREAM_Q_BN columns, block of :func:`slot_blocks`, K split of
    :func:`ggemm_q_stream_splits`; N-tiles fastest), the block's rows
    against W[e]'s columns dequantized in fp32 with the group width
    ceil(N / nb) and rounded to x's dtype, the products added to the fp32
    partial in K order over the split's range (:func:`_q_unit_sum`, as
    :func:`ggemm_q_stream_walk`); the splits' partials summed in split
    order; one rounding to x's dtype.  Rows of an expert outside [0, E) get
    zeros."""
    R, K = x.shape
    E, _, N = q.shape
    qblock = -(-N // s.shape[2])
    nsplit, kper = ggemm_q_stream_splits(K, N, E, sms)
    blocks = slot_blocks(plan, E)
    order = plan.row_order.long()
    n_tiles = -(-N // STREAM_Q_BN)
    parts = torch.zeros(nsplit, R, N, dtype=torch.float32)
    for u in range(len(blocks) * nsplit * n_tiles):
        nt, rest = u % n_tiles, u // n_tiles
        b, sp = rest % len(blocks), rest // len(blocks)
        e, r0, nrow, _ = blocks[b]
        if e < 0:
            continue
        rows = order[r0:r0 + nrow]
        cols = torch.arange(nt * STREAM_Q_BN, min(N, (nt + 1) * STREAM_Q_BN))
        parts[sp, rows[:, None], cols[None, :]] = _q_unit_sum(
            x[rows], q, s, e, cols, qblock, sp * kper,
            min(K, (sp + 1) * kper))
    out = parts[0]
    for sp in range(1, nsplit):
        out = out + parts[sp]
    return out.to(x.dtype)


# ------------------------------------------------------------------ kernels
_entries = {}
_sms = {}


def _sm_count(device) -> int:
    """Multiprocessors of a CUDA device (the streaming slot kernel's split
    rule reads it)."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _fn(lib, name, nargs_ptr, nargs_int, stream=True):
    """C entry point ``name`` of the built library ``lib``: ``nargs_ptr``
    pointers, then ``nargs_int`` ints, then the stream (bound once: a
    launch pays no library lookup)."""
    fn = _entries.get((lib, name))
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                       + [ctypes.c_int] * nargs_int
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
        _entries[(lib, name)] = fn
    return fn


def _call(lib, name, nargs_ptr, nargs_int, device, *args):
    """Launch ``name`` of ``lib`` on ``device``'s current stream with
    ``args`` (pointers, then ints); returns its ``cudaError_t``."""
    with torch.cuda.device(device):
        return _fn(lib, name, nargs_ptr, nargs_int)(*args, _stream(device))


def _unit_counters(device):
    """The Hopper kernels' work-unit counters (2 ints, returned to 0 by
    each launch): the split-K kernels' shared per-device counters."""
    return build.scratch(device, 0, 2)[1].data_ptr()


def hopper_route(dtype, ptrs, dims) -> bool:
    """Whether a launch on operands of ``dtype`` at addresses ``ptrs`` with
    contraction / output widths ``dims`` takes the Hopper kernels: bf16,
    every width a multiple of 8 and every base 16-byte aligned (the
    tensor maps' stride and address rule).  A shape rule: the main path's
    shapes (K, N in 1024 / 3584, 4096 / 14336) always meet it."""
    if dtype != torch.bfloat16:
        return False
    bases = widths = 0
    for p in ptrs:
        bases |= p
    for d in dims:
        widths |= d
    return bases % 16 == 0 and widths % 8 == 0


def stream_route_q(dtype, ptrs, K, N, nb) -> bool:
    """Whether an int8-expert launch takes the streaming kernels
    (``ds_ggemm_q_s``, by slot ``ds_ggemm_slots_q_s``): bf16 rows, K a multiple of 8, N of 16 and nb of 4
    (the x, code and scale rows' 16-byte strides), groups of at least two
    columns (a unit's scale box then holds at most 256 groups), every base
    16-byte aligned.  Mixtral's K, N 4096 / 14336 with nb 56 / 16 meet
    it."""
    return (dtype == torch.bfloat16 and K % 8 == 0 and N % 16 == 0
            and nb % 4 == 0 and 2 * nb <= N
            and all(p % 16 == 0 for p in ptrs))


def _check_common(what, x, w, ints):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)} (need x [M, K], w [E, K, N])")
    if x.dtype not in _dtypes_for(x) or w.dtype != x.dtype:
        raise ValueError(f"{what}: dtypes x {x.dtype}, w {w.dtype}; need "
                         f"both one of {_dtypes_for(x)}")
    _check_placed(what, x, (("w", w),), ints)


def _check_t(what, dy, w, ints):
    if dy.dim() != 2 or w.dim() != 3 or dy.shape[1] != w.shape[2]:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} against w "
                         f"{tuple(w.shape)} (need dy [M, N], w [E, K, N])")
    if dy.dtype not in _dtypes_for(dy) or w.dtype != dy.dtype:
        raise ValueError(f"{what}: dtypes dy {dy.dtype}, w {w.dtype}; need "
                         f"both one of {_dtypes_for(dy)}")
    _check_placed(what, dy, (("w", w),), ints)


def _check_q(what, x, q, s, ints):
    if x.dim() != 2 or q.dim() != 3 or s.dim() != 3 \
            or x.shape[1] != q.shape[1] or s.shape[:2] != q.shape[:2] \
            or not 1 <= s.shape[2] <= q.shape[2]:
        raise ValueError(f"{what}: x {tuple(x.shape)} against int8 experts "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)} (need x "
                         "[M, K], q [E, K, N], s [E, K, nb], 1 <= nb <= N)")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise ValueError(f"{what}: dtypes x {x.dtype}, q {q.dtype}, s "
                         f"{s.dtype}; need x one of {_DTYPES}, int8, fp32")
    _check_placed(what, x, (("q", q), ("s", s)), ints)


def _check_placed(what, x, weights, ints):
    for name, t in (("x", x),) + tuple(weights) + tuple(ints):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_group_fit(what, x, E, plan: GroupPlan):
    if plan.block_m != DEFAULT_BLOCK_M or x.shape[0] != plan.padded_rows \
            or plan.block_group_ids.shape != (plan.num_blocks,) \
            or plan.tile_rows.shape != (plan.num_blocks,) \
            or plan.num_experts != E:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not fit the "
                         f"plan (block_m {plan.block_m}, padded rows "
                         f"{plan.padded_rows}, {plan.num_experts} experts); "
                         f"the kernel's tile is {DEFAULT_BLOCK_M} rows")


def _check_slot_fit(what, x, E, plan: SlotPlan):
    R, S = x.shape[0], plan.num_slots
    if not 1 <= R <= SLOT_MAX_ROWS or S != min(R, E) \
            or plan.row_order.shape != (R,) \
            or plan.slot_offsets.shape != (S + 1,):
        raise ValueError(f"{what}: x {tuple(x.shape)} does not fit the "
                         f"plan ({S} slots over {E} experts), or R outside "
                         f"[1, {SLOT_MAX_ROWS}]")


def _group_ints(plan: GroupPlan):
    return (("block_group_ids", plan.block_group_ids),
            ("tile_rows", plan.tile_rows))


def _slot_ints(plan: SlotPlan):
    return (("active", plan.active), ("valid", plan.valid),
            ("row_order", plan.row_order),
            ("slot_offsets", plan.slot_offsets))


def _slot_scratch(what, x, K, N, int8):
    """The slot kernels' split-K workspace and tile counters for [R, N]
    outputs at depth K (the split the kernel will take on x's device)."""
    with torch.cuda.device(x.device):
        nsplit = _fn("grouped_gemm", "ds_ggemm_slots_splits", 0, 4,
                     stream=False)(
            K, N, int(int8), int(x.dtype == torch.bfloat16))
    if not 1 <= nsplit <= SLOT_MAX_SPLIT:
        raise RuntimeError(f"{what}: no K split for K {K}, N {N} on "
                           f"{x.device}")
    return build.scratch(x.device, nsplit * x.shape[0] * N, -(-N // SLOT_BN))


def ggemm_cuda(x, w, plan: GroupPlan):
    """Launch ``ds_ggemm``; raises on anything the kernel does not take."""
    _check_common("ds_ggemm", x, w, _group_ints(plan))
    Mp, K = x.shape
    E, _, N = w.shape
    _check_group_fit("ds_ggemm", x, E, plan)
    out = torch.empty((Mp, N), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), plan.block_group_ids.data_ptr(),
            plan.tile_rows.data_ptr(), out.data_ptr())
    if hopper_route(x.dtype, (ptrs[0], ptrs[1], ptrs[4]), (K, N)):
        rc = _call("grouped_gemm_hopper", "ds_ggemm_h", 6, 4, x.device,
                   *ptrs, _unit_counters(x.device), plan.num_blocks, K, N,
                   E)
        build.check(rc, "ds_ggemm")
        ds_ggemm.launches += 1
        return out
    bf16 = x.dtype == torch.bfloat16
    rc = _call("grouped_gemm", "ds_ggemm", 5, 5, x.device, *ptrs,
               plan.num_blocks, K, N, E, int(bf16))
    build.check(rc, "ds_ggemm")
    if bf16:
        ds_ggemm.unaligned_launches += 1
    else:
        ds_ggemm.launches += 1
    return out


def ggemm_t_cuda(dy, w, plan: GroupPlan):
    """Launch ``ds_ggemm_t``: dx [Mp, K] = dy [Mp, N] against ``w`` [E, K,
    N] transposed; raises on anything the kernel does not take.  dy's
    rows outside the plan's real rows are read as zeros (the layout's
    padding, where the backward's cotangent is zero)."""
    _check_t("ds_ggemm_t", dy, w, _group_ints(plan))
    Mp, N = dy.shape
    E, K, _ = w.shape
    _check_group_fit("ds_ggemm_t", dy, E, plan)
    out = torch.empty((Mp, K), dtype=dy.dtype, device=dy.device)
    ptrs = (dy.data_ptr(), w.data_ptr(), plan.block_group_ids.data_ptr(),
            plan.tile_rows.data_ptr(), out.data_ptr())
    if hopper_route(dy.dtype, (ptrs[0], ptrs[1], ptrs[4]), (K, N)):
        rc = _call("grouped_gemm_hopper", "ds_ggemm_t_h", 6, 4, dy.device,
                   *ptrs, _unit_counters(dy.device), plan.num_blocks, K, N,
                   E)
        build.check(rc, "ds_ggemm_t")
        ds_ggemm.transpose_launches += 1
        return out
    bf16 = dy.dtype == torch.bfloat16
    rc = _call("grouped_gemm", "ds_ggemm_t", 5, 5, dy.device, *ptrs,
               plan.num_blocks, K, N, E, int(bf16))
    build.check(rc, "ds_ggemm_t")
    if bf16:
        ds_ggemm.unaligned_transpose_launches += 1
    else:
        ds_ggemm.transpose_launches += 1
    return out


def _check_tgmm(x, dy, plan: GroupPlan, out_dtype):
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0] \
            or x.shape[0] != plan.padded_rows:
        raise ValueError(f"ds_tgmm: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} (need [Mp, K] and [Mp, N], Mp "
                         f"the plan's {plan.padded_rows} padded rows)")
    if x.dtype not in _dtypes_for(x) or dy.dtype != x.dtype \
            or out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"ds_tgmm: dtypes x {x.dtype}, dy {dy.dtype}, out "
                         f"{out_dtype}; need x and dy one of {_DTYPES}, out "
                         "x's or fp32")


def tgmm_cuda(x, dy, plan: GroupPlan, out_dtype=None):
    """Launch ``ds_tgmm``: dW [E, K, N] in ``out_dtype`` (x's or fp32);
    raises on anything the kernel does not take."""
    out_dtype = out_dtype or x.dtype
    _check_tgmm(x, dy, plan, out_dtype)
    _check_placed("ds_tgmm", x, (("dy", dy),),
                  (("group_sizes", plan.group_sizes),
                   ("counts", plan.counts)))
    if plan.block_m != DEFAULT_BLOCK_M:
        raise ValueError(f"ds_tgmm: the plan's block_m {plan.block_m}; the "
                         f"kernel's tile is {DEFAULT_BLOCK_M} rows")
    Mp, K = x.shape
    N, E = dy.shape[1], plan.num_experts
    out = torch.empty((E, K, N), dtype=out_dtype, device=x.device)
    ptrs = (x.data_ptr(), dy.data_ptr(), plan.group_sizes.data_ptr(),
            plan.counts.data_ptr(), out.data_ptr())
    f32 = int(out_dtype == torch.float32)
    if hopper_route(x.dtype, (ptrs[0], ptrs[1], ptrs[4]), (K, N)):
        rc = _call("grouped_gemm_hopper", "ds_tgmm_h", 6, 5, x.device,
                   *ptrs, _unit_counters(x.device), Mp, K, N, E, f32)
        build.check(rc, "ds_tgmm")
        ds_tgmm.launches += 1
        return out
    bf16 = x.dtype == torch.bfloat16
    rc = _call("grouped_gemm", "ds_tgmm", 5, 6, x.device, *ptrs, Mp, K, N,
               E, int(bf16), f32)
    build.check(rc, "ds_tgmm")
    if bf16:
        ds_tgmm.unaligned_launches += 1
    else:
        ds_tgmm.launches += 1
    return out


def ggemm_q_cuda(x, q, s, plan: GroupPlan):
    """Launch ``ds_ggemm_q`` (int8 experts q [E, K, N], scales s [E, K,
    nb]); raises on anything the kernel does not take."""
    _check_q("ds_ggemm_q", x, q, s, _group_ints(plan))
    Mp, K = x.shape
    E, _, N = q.shape
    _check_group_fit("ds_ggemm_q", x, E, plan)
    nb = s.shape[2]
    out = torch.empty((Mp, N), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr(),
            plan.block_group_ids.data_ptr(), plan.tile_rows.data_ptr(),
            out.data_ptr())
    if stream_route_q(x.dtype, ptrs[:3], K, N, nb):
        nsplit, kper = ggemm_q_stream_splits(K, N, E, _sm_count(x.device))
        ws, counters = build.scratch(
            x.device, nsplit * Mp * N if nsplit > 1 else 0,
            2 + plan.num_blocks * -(-N // STREAM_Q_BN))
        rc = _call("grouped_gemm_stream", "ds_ggemm_q_s", 8, 7, x.device,
                   *ptrs, ws.data_ptr(), counters.data_ptr(),
                   plan.num_blocks, K, N, E, nb, nsplit, kper)
        build.check(rc, "ds_ggemm_q")
        ds_ggemm.int8_launches += 1
        return out
    bf16 = x.dtype == torch.bfloat16
    rc = _call("grouped_gemm", "ds_ggemm_q", 6, 6, x.device, *ptrs,
               plan.num_blocks, K, N, E, nb, int(bf16))
    build.check(rc, "ds_ggemm_q")
    if bf16:
        ds_ggemm.unaligned_int8_launches += 1
    else:
        ds_ggemm.int8_launches += 1
    return out


def ggemm_slots_cuda(x, w, plan: SlotPlan):
    """Launch ``ds_ggemm_slots``; raises on anything the kernel does not
    take."""
    _check_common("ds_ggemm_slots", x, w, _slot_ints(plan))
    R, K = x.shape
    E, _, N = w.shape
    _check_slot_fit("ds_ggemm_slots", x, E, plan)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    S = plan.num_slots
    ptrs = (x.data_ptr(), w.data_ptr(), plan.active.data_ptr(),
            plan.valid.data_ptr(), plan.row_order.data_ptr(),
            plan.slot_offsets.data_ptr(), out.data_ptr())
    if hopper_route(x.dtype, ptrs[:2], (K, N)):
        nsplit, kper = slot_stream_splits(K, N, _sm_count(x.device))
        ws, counters = build.scratch(
            x.device, nsplit * R * N if nsplit > 1 else 0,
            2 + slot_block_bound(R, S) * -(-N // STREAM_SLOT_BN))
        rc = _call("grouped_gemm_stream", "ds_ggemm_slots_s", 9, 7,
                   x.device, *ptrs, ws.data_ptr(), counters.data_ptr(), R,
                   K, N, E, S, nsplit, kper)
        build.check(rc, "ds_ggemm_slots")
        ds_ggemm_slots.launches += 1
        return out
    bf16 = x.dtype == torch.bfloat16
    ws, counters = _slot_scratch("ds_ggemm_slots", x, K, N, False)
    rc = _call("grouped_gemm", "ds_ggemm_slots", 9, 6, x.device, *ptrs,
               ws.data_ptr(), counters.data_ptr(), R, K, N, E, S, int(bf16))
    build.check(rc, "ds_ggemm_slots")
    if bf16:
        ds_ggemm_slots.unaligned_launches += 1
    else:
        ds_ggemm_slots.launches += 1
    return out


def ggemm_slots_q_cuda(x, q, s, plan: SlotPlan):
    """Launch ``ds_ggemm_slots_q`` (int8 experts); raises on anything the
    kernel does not take.  Shapes of :func:`stream_route_q` take the
    streaming kernel (``ds_ggemm_slots_q_s``: ``ds_ggemm_q_s``'s K split,
    :func:`ggemm_q_stream_splits`, and sum order); fp32 rows and the other
    shapes ``csrc/grouped_gemm.cu``'s slot kernel, which refuses
    (cudaErrorInvalidValue) a scale layout whose 128-column tiles meet more
    groups than it stages (``kSlotSG``; Mixtral's 256-lane groups meet
    one)."""
    _check_q("ds_ggemm_slots_q", x, q, s, _slot_ints(plan))
    R, K = x.shape
    E, _, N = q.shape
    nb = s.shape[2]
    _check_slot_fit("ds_ggemm_slots_q", x, E, plan)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    S = plan.num_slots
    ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr(), plan.active.data_ptr(),
            plan.valid.data_ptr(), plan.row_order.data_ptr(),
            plan.slot_offsets.data_ptr(), out.data_ptr())
    if stream_route_q(x.dtype, ptrs[:3], K, N, nb):
        nsplit, kper = ggemm_q_stream_splits(K, N, E, _sm_count(x.device))
        ws, counters = build.scratch(
            x.device, nsplit * R * N if nsplit > 1 else 0,
            2 + slot_block_bound(R, S) * -(-N // STREAM_Q_BN))
        rc = _call("grouped_gemm_stream", "ds_ggemm_slots_q_s", 10, 8,
                   x.device, *ptrs, ws.data_ptr(), counters.data_ptr(), R, K,
                   N, E, S, nb, nsplit, kper)
        build.check(rc, "ds_ggemm_slots_q")
        ds_ggemm_slots.int8_launches += 1
        return out
    bf16 = x.dtype == torch.bfloat16
    ws, counters = _slot_scratch("ds_ggemm_slots_q", x, K, N, True)
    rc = _call("grouped_gemm", "ds_ggemm_slots_q", 10, 7, x.device, *ptrs,
               ws.data_ptr(), counters.data_ptr(), R, K, N, E, S, nb,
               int(bf16))
    build.check(rc, "ds_ggemm_slots_q")
    if bf16:
        ds_ggemm_slots.unaligned_int8_launches += 1
    else:
        ds_ggemm_slots.int8_launches += 1
    return out


def ds_ggemm(x, w, plan: GroupPlan, *, transpose_rhs=False):
    """Grouped GEMM over a :class:`GroupPlan`-padded ``x`` [Mp, K] against
    ``w`` [E, K, N] (float, or int8 experts: a ``QuantizedTensor`` or a
    ``(q, s)`` pair): row r takes ``w[expert of r's tile]``; [Mp, N] in
    x's dtype, zeros on padding tiles.  CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``transpose_rhs`` (the backward's dx
    form): ``x`` is dy [Mp, N] and the result [Mp, K] = dy against
    ``w[e]`` transposed; int8 experts raise ``ValueError`` there (the
    reference has no such form).  Not differentiable itself: see
    :func:`grouped_gemm`."""
    qs = quantized_parts(w)
    if transpose_rhs:
        if qs is not None:
            raise ValueError("int8 grouped GEMM has no transposed-RHS form "
                             "(backward is float-only)")
        if x.device.type == "cuda":
            return ggemm_t_cuda(x, w, plan)
        if x.device.type == "cpu":
            _check_t("ds_ggemm", x, w, ())
            return ggemm_t_plain(x, w, plan)
        raise ValueError(f"ds_ggemm: unsupported device {x.device}")
    if x.device.type == "cuda":
        return ggemm_cuda(x, w, plan) if qs is None \
            else ggemm_q_cuda(x, *qs, plan)
    if x.device.type == "cpu":
        if qs is None:
            _check_common("ds_ggemm", x, w, ())
            return ggemm_plain(x, w, plan)
        _check_q("ds_ggemm_q", x, *qs, ())
        return ggemm_q_plain(x, *qs, plan)
    raise ValueError(f"ds_ggemm: unsupported device {x.device}")


def ds_ggemm_slots(x, w, plan: SlotPlan):
    """Small-M grouped GEMM over raw routed rows ``x`` [R, K]
    (R <= SLOT_MAX_ROWS): row r contracts against ``w[eids[r]]`` (float,
    or int8 experts as for :func:`ds_ggemm`); [R, N] in x's dtype.  CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    qs = quantized_parts(w)
    if x.device.type == "cuda":
        return ggemm_slots_cuda(x, w, plan) if qs is None \
            else ggemm_slots_q_cuda(x, *qs, plan)
    if x.device.type == "cpu":
        if qs is None:
            _check_common("ds_ggemm_slots", x, w, ())
            return ggemm_slots_plain(x, w, plan)
        _check_q("ds_ggemm_slots_q", x, *qs, ())
        return ggemm_slots_q_plain(x, *qs, plan)
    raise ValueError(f"ds_ggemm_slots: unsupported device {x.device}")


def ds_tgmm(x, dy, plan: GroupPlan, out_dtype=None):
    """dW [E, K, N] = per expert, the sum over its rows of ``x`` [Mp, K]
    transposed against ``dy`` [Mp, N] (group-padded rows of one plan), in
    ``out_dtype`` (x's when None, or fp32).  CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        return tgmm_cuda(x, dy, plan, out_dtype)
    if x.device.type == "cpu":
        _check_tgmm(x, dy, plan, out_dtype)
        return tgmm_plain(x, dy, plan, out_dtype)
    raise ValueError(f"ds_tgmm: unsupported device {x.device}")


class GroupedGemm(torch.autograd.Function):
    """:func:`ds_ggemm` with its backward (the reference's ``_ggemm_diff``
    custom VJP): dx = ``ds_ggemm(dy, w, plan, transpose_rhs=True)`` and
    dW = :func:`ds_tgmm` in w's dtype, from the cotangent cast to x's
    dtype; the plan's integer tensors are saved beside x and w and get no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, plan: GroupPlan):
        ctx.static = (plan.block_m, plan.padded_rows, plan.num_blocks,
                      plan.num_experts)
        ctx.save_for_backward(x, w, *plan[4:])
        return ds_ggemm(x, w, plan)

    @staticmethod
    def backward(ctx, dy):
        x, w, *ints = ctx.saved_tensors
        plan = GroupPlan(*ctx.static, *ints)
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ds_ggemm(dy, w, plan, transpose_rhs=True)
        if ctx.needs_input_grad[1]:
            dw = ds_tgmm(x, dy, plan, out_dtype=w.dtype)
        return dx, dw, None


def rows_matmul(x, w, transpose_w: bool = False):
    """``x @ w`` (``transpose_w``: ``x @ w.T``) for fp32 CUDA tensors whose
    rows' bits do not depend on the rows beside them: the grouped GEMM's
    fp32 kernel (``layout_tile``, an fmaf chain in K order) over one
    group, where cuBLAS's fp32 GEMM picks its summation by the row count.
    x [..., K]; w [K, N] (``transpose_w``: [N, K], as GPT-2's tied
    ``wte``); returns [..., N] fp32.  Counted where it launches:
    ``ds_ggemm.launches`` (``transpose_w``: ``ds_ggemm.transpose_launches``).
    Raises on anything else."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError(f"rows_matmul: fp32 CUDA x and 2-D w, got "
                         f"{x.dtype} {x.device}, {w.dtype} {tuple(w.shape)}")
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    M = flat.shape[0]
    plan = make_group_plan(torch.zeros(M, dtype=torch.int64,
                                       device=x.device), 1)
    xp = scatter_to_groups(flat, plan)
    w1 = w.contiguous()[None]
    out = (ggemm_t_cuda(xp, w1, plan) if transpose_w
           else ggemm_cuda(xp, w1, plan))
    return out[:M].reshape(*lead, out.shape[-1])


def grouped_gemm(x, w, plan: GroupPlan):
    """Differentiable :func:`ds_ggemm` (the MoE layer's group-padded
    GEMM): float experts go through :class:`GroupedGemm`, int8 experts
    (no backward, as in the reference) straight to :func:`ds_ggemm`."""
    if quantized_parts(w) is not None:
        return ds_ggemm(x, w, plan)
    return GroupedGemm.apply(x, w, plan)


#: kernel launches since the count was last set to 0: the float kernels
#: (``launches``; bf16 on the Hopper kernels), the int8 ones
#: (``int8_launches``), the transposed-RHS backward form
#: (``transpose_launches``) and the dW kernel
ds_ggemm.launches = ds_ggemm.int8_launches = 0
ds_ggemm.transpose_launches = 0
ds_ggemm_slots.launches = ds_ggemm_slots.int8_launches = 0
ds_tgmm.launches = 0
#: bf16 launches that the shape rules (:func:`hopper_route`,
#: :func:`stream_route_q`) sent to the kernels of ``csrc/grouped_gemm.cu``:
#: none on the main paths
ds_ggemm.unaligned_launches = ds_ggemm.unaligned_transpose_launches = 0
ds_ggemm.unaligned_int8_launches = ds_ggemm_slots.unaligned_launches = 0
ds_ggemm_slots.unaligned_int8_launches = ds_tgmm.unaligned_launches = 0
