"""Grouped GEMM for routed experts (port of
``deepspeed_tpu/ops/pallas/grouped_gemm.py``): the megablocks-style
expert dispatch of the MoE layer's serving path.

Two forms, both against the stacked expert weights ``w`` [E, K, N]:

- :func:`ds_ggemm` — rows sorted by expert and padded per expert to a
  multiple of the M-tile (:func:`make_group_plan`,
  :func:`scatter_to_groups`, :func:`gather_from_groups`); each M-tile
  contracts against its expert's [K, N] slice.  The CUDA kernel
  (``csrc/grouped_gemm.cu`` ``ds_ggemm``) replaces ``_ggemm_kernel``
  (``grouped_gemm.py:163``, forward form).
- :func:`ds_ggemm_slots` — at most :data:`SLOT_MAX_ROWS` raw routed rows
  (no padding, no scatter): each DISTINCT routed expert's weights stream
  once (:func:`make_slot_plan`), and each row takes only its own
  expert's product.  The CUDA kernel (``ds_ggemm_slots``) replaces
  ``_slot_kernel`` (``grouped_gemm.py:433``).

The plans are plain torch ops on the tensors' device (XLA computed them
in the reference) with static shapes, so the decode path never waits on
the host: the kernels read ``block_group_ids`` / ``tile_rows`` and
``active`` / ``valid`` / ``row_order`` / ``slot_offsets`` from device
memory.  Each wrapper takes its plain version only for CPU tensors: for a
CUDA tensor it launches its kernel or raises.

The quantised (``_ggemm_q_kernel``, ``_slot_q_kernel``), transposed-RHS
and backward (``_tgmm_kernel``) forms are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.

Numerics: fp32 accumulation (tensor cores for bf16, fmaf for fp32 — no
TF32), output rounded once to ``x``'s dtype, as the reference's kernels.
"""
import ctypes
from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.kernels import build

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
_DTYPES = (torch.float32, torch.bfloat16)

_INT8_ITEM = "ROADMAP.md Queue B: int8 MoE (port slice 5)"
_TRAIN_ITEM = "ROADMAP.md Queue B: MoE training (port slice 7)"


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


# ------------------------------------------------------------------ kernels
def _fn(name, nargs_ptr, nargs_int, stream=True):
    """C entry point ``name`` of the built library: ``nargs_ptr``
    pointers, then ``nargs_int`` ints, then the stream."""
    fn = getattr(build.load("grouped_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                       + [ctypes.c_int] * nargs_int
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
    return fn


def _check_common(what, x, w, ints):
    if not torch.is_tensor(w):
        raise NotImplementedError(
            f"{what}: int8 expert weights are not ported to "
            f"deepspeed_tpu_torch yet ({_INT8_ITEM})")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)} (need x [M, K], w [E, K, N])")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{what}: dtypes x {x.dtype}, w {w.dtype}; need "
                         f"both one of {_DTYPES}")
    for name, t in (("x", x), ("w", w)) + tuple(ints):
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


def ggemm_cuda(x, w, plan: GroupPlan):
    """Launch ``ds_ggemm``; raises on anything the kernel does not take."""
    _check_common("ds_ggemm", x, w,
                  (("block_group_ids", plan.block_group_ids),
                   ("tile_rows", plan.tile_rows)))
    Mp, K = x.shape
    E, _, N = w.shape
    if plan.block_m != DEFAULT_BLOCK_M or Mp != plan.padded_rows \
            or plan.block_group_ids.shape != (plan.num_blocks,) \
            or plan.tile_rows.shape != (plan.num_blocks,) \
            or plan.num_experts != E:
        raise ValueError(f"ds_ggemm: x {tuple(x.shape)} does not fit the "
                         f"plan (block_m {plan.block_m}, padded rows "
                         f"{plan.padded_rows}, {plan.num_experts} experts); "
                         f"the kernel's tile is {DEFAULT_BLOCK_M} rows")
    out = torch.empty((Mp, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn("ds_ggemm", 5, 5)(
            x.data_ptr(), w.data_ptr(), plan.block_group_ids.data_ptr(),
            plan.tile_rows.data_ptr(), out.data_ptr(), plan.num_blocks, K,
            N, E, int(x.dtype == torch.bfloat16), _stream(x.device))
    build.check(rc, "ds_ggemm")
    ds_ggemm.launches += 1
    return out


def ggemm_slots_cuda(x, w, plan: SlotPlan):
    """Launch ``ds_ggemm_slots``; raises on anything the kernel does not
    take."""
    _check_common("ds_ggemm_slots", x, w,
                  (("active", plan.active), ("valid", plan.valid),
                   ("row_order", plan.row_order),
                   ("slot_offsets", plan.slot_offsets)))
    R, K = x.shape
    E, _, N = w.shape
    S = plan.num_slots
    if not 1 <= R <= SLOT_MAX_ROWS or S != min(R, E) \
            or plan.row_order.shape != (R,) \
            or plan.slot_offsets.shape != (S + 1,):
        raise ValueError(f"ds_ggemm_slots: x {tuple(x.shape)} does not fit "
                         f"the plan ({S} slots over {E} experts), or R "
                         f"outside [1, {SLOT_MAX_ROWS}]")
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        nsplit = _fn("ds_ggemm_slots_splits", 0, 2, stream=False)(K, N)
        if not 1 <= nsplit <= SLOT_MAX_SPLIT:
            raise RuntimeError(f"ds_ggemm_slots: no K split for K {K}, "
                               f"N {N} on {x.device}")
        ws, counters = build.scratch(x.device, nsplit * R * N,
                                -(-N // SLOT_BN))
        rc = _fn("ds_ggemm_slots", 9, 6)(
            x.data_ptr(), w.data_ptr(), plan.active.data_ptr(),
            plan.valid.data_ptr(), plan.row_order.data_ptr(),
            plan.slot_offsets.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), R, K, N, E, S,
            int(x.dtype == torch.bfloat16), _stream(x.device))
    build.check(rc, "ds_ggemm_slots")
    ds_ggemm_slots.launches += 1
    return out


def ds_ggemm(x, w, plan: GroupPlan, *, transpose_rhs=False):
    """Grouped GEMM over a :class:`GroupPlan`-padded ``x`` [Mp, K] against
    ``w`` [E, K, N]: row r takes ``w[expert of r's tile]``; [Mp, N] in x's
    dtype, zeros on padding tiles.  CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``transpose_rhs`` (the backward's form)
    raises."""
    if transpose_rhs:
        raise NotImplementedError(
            "ds_ggemm(transpose_rhs=True): the backward form is not ported "
            f"to deepspeed_tpu_torch yet ({_TRAIN_ITEM})")
    if x.device.type == "cuda":
        return ggemm_cuda(x, w, plan)
    if x.device.type == "cpu":
        _check_common("ds_ggemm", x, w, ())
        return ggemm_plain(x, w, plan)
    raise ValueError(f"ds_ggemm: unsupported device {x.device}")


def ds_ggemm_slots(x, w, plan: SlotPlan):
    """Small-M grouped GEMM over raw routed rows ``x`` [R, K]
    (R <= SLOT_MAX_ROWS): row r contracts against ``w[eids[r]]``; [R, N]
    in x's dtype.  CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cuda":
        return ggemm_slots_cuda(x, w, plan)
    if x.device.type == "cpu":
        _check_common("ds_ggemm_slots", x, w, ())
        return ggemm_slots_plain(x, w, plan)
    raise ValueError(f"ds_ggemm_slots: unsupported device {x.device}")


#: kernel launches since the count was last set to 0
ds_ggemm.launches = 0
ds_ggemm_slots.launches = 0
