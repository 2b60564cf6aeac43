"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention.py``; reference: DeepSpeed's
``deepspeed/ops/sparse_attention/`` — the ``SparsityConfig`` hierarchy in
sparsity_config.py and ``SparseSelfAttention``).

The layouts (dense / fixed / BigBird / BSLongformer / variable) are the
JAX package's numpy layout code copied call for call, ``default_rng(seed)``
and ``rng.choice(..., replace=False)`` in the same order, so every layout
is bit-identical to the reference's, per head too.  Two compute paths,
selected by ``impl`` (the reference's values, so callers' code ports as
is):

* ``"dense"`` — block-masked dense attention in plain torch, fp32 scores
  and softmax, the reference's arithmetic; memory is O(S^2).
* ``"pallas"`` — the block-skipping kernels
  (``ops/kernels/block_sparse_attention.py``): on a CUDA tensor the
  hand-written CUDA forward, dQ and dK/dV kernels of
  ``csrc/block_sparse_attention.cu``, on a CPU tensor their plain
  versions.  Blocks outside the layout are never read or multiplied, so
  cost scales with the layout's density, not S^2 — the long-sequence path.
  The name is the reference's; no Pallas runs here.

A layout is config, not data: :func:`sparse_self_attention` builds the
layout and the device plan once per (config state, S, causal, device) and
reuses them, so a call makes no host-to-device copy and no host sync.
"""
import weakref
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
    BlockSparseAttention, BlockSparsePlan)

NEG_INF = -1e30
IMPLS = ("dense", "pallas")


class SparsityConfig:
    """Base layout class (reference sparsity_config.py:22)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attended — dense baseline (reference :105)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows + fixed global columns (reference :135
    FixedSparsityConfig: num_local_blocks window, num_global_blocks summary
    columns chosen from each window's tail)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            # local windows
            for start in range(0, n, self.num_local_blocks):
                end = min(start + self.num_local_blocks, n)
                layout[h, start:end, start:end] = 1
            # global columns: last num_global_blocks of each window
            for start in range(0, n, self.num_local_blocks):
                end = min(start + self.num_local_blocks, n)
                g0 = max(end - self.num_global_blocks, start)
                layout[h, :, g0:end] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:end, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global blocks (reference :375)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            for i in range(n):
                lo, hi = max(0, i - w), min(n, i + w + 1)
                layout[h, i, lo:hi] = 1                       # sliding window
                choices = rng.choice(n, size=min(self.num_random_blocks, n),
                                     replace=False)
                layout[h, i, choices] = 1                     # random blocks
            g = min(self.num_global_blocks, n)
            layout[h, :g, :] = 1                              # global rows
            layout[h, :, :g] = 1                              # global cols
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global-attention block indices (reference
    :558)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            for i in range(n):
                lo, hi = max(0, i - w), min(n, i + w + 1)
                layout[h, i, lo:hi] = 1
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < n:
                        layout[h, idx, :] = 1
                        layout[h, :, idx] = 1
            else:
                for s, e in zip(self.global_block_indices,
                                self.global_block_end_indices):
                    layout[h, s:e, :] = 1
                    layout[h, :, s:e] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + global blocks (reference :232)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False, seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            start = 0
            wi = 0
            while start < n:
                w = self.local_window_blocks[
                    min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
                start = end
                wi += 1
            if self.num_random_blocks:
                for i in range(n):
                    choices = rng.choice(
                        n, size=min(self.num_random_blocks, n),
                        replace=False)
                    layout[h, i, choices] = 1
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < n:
                        layout[h, :, idx] = 1
                        if self.horizontal_global_attention:
                            layout[h, idx, :] = 1
            else:
                for s, e in zip(self.global_block_indices,
                                self.global_block_end_indices):
                    layout[h, :, s:e] = 1
                    if self.horizontal_global_attention:
                        layout[h, s:e, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


# ------------------------------------------------------------------- caches

# per config object: {(its attributes, S[, causal, device]): layout or plan}
_layouts = weakref.WeakKeyDictionary()
_plans = weakref.WeakKeyDictionary()


def _state(cfg) -> str:
    """The config's attributes, so a mutated config builds anew."""
    return repr(sorted(vars(cfg).items()))


def cached_layout(cfg, seq_len: int) -> np.ndarray:
    """``cfg.make_layout(seq_len)``, built once per config state and S
    (the reference pays it once under ``jit``).  Do not write to it."""
    per = _layouts.setdefault(cfg, {})
    key = (_state(cfg), seq_len)
    if key not in per:
        per[key] = cfg.make_layout(seq_len)
    return per[key]


def cached_plan(cfg, seq_len: int, causal: bool, device) -> BlockSparsePlan:
    """The kernels' device plan of ``cfg``'s layout at ``seq_len``, built
    once per (config state, S, causal, device)."""
    device = torch.device(device)
    per = _plans.setdefault(cfg, {})
    key = (_state(cfg), seq_len, bool(causal), str(device))
    if key not in per:
        per[key] = BlockSparsePlan(cached_layout(cfg, seq_len), causal,
                                   device)
    return per[key]


# ------------------------------------------------------------------- compute

def layout_to_mask(layout: np.ndarray, seq_len: int,
                   device=None) -> torch.Tensor:
    """[H, n, n] block layout -> [H, S, S] boolean attention mask."""
    block = seq_len // layout.shape[1]
    mask = np.repeat(np.repeat(layout, block, axis=1), block, axis=2)
    return torch.as_tensor(mask.astype(bool), device=device)


def _dense(q, k, v, layout, causal, scale):
    """The reference's block-masked dense path (fp32 scores, -1e30 mask,
    normaliser floored at 1e-30, fully-masked rows emit 0)."""
    S = q.shape[1]
    mask = layout_to_mask(layout, S, q.device)           # [H, S, S]
    if causal:
        mask = mask & torch.tril(torch.ones((S, S), dtype=torch.bool,
                                            device=q.device))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    # fully-masked rows emit 0 (the flash convention, shared with the
    # block-skipping kernels): a uniform softmax over -1e30 scores would
    # leak masked V into the output
    row_any = mask.any(-1)                               # [H, S]
    out = torch.where(row_any.T[None, :, :, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def sparse_self_attention(q, k, v, sparsity_config: SparsityConfig,
                          causal: bool = False, sm_scale=None,
                          impl: str = "dense"):
    """q/k/v [B, S, H, hd] -> [B, S, H, hd] under the config's block layout
    (reference SparseSelfAttention.forward); differentiable in q, k, v.

    ``impl="pallas"`` runs the block-skipping kernels forward and backward
    (:class:`BlockSparseAttention`: the CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors); ``impl="dense"`` the
    block-masked dense path.  ``sm_scale`` None means ``hd ** -0.5``."""
    if impl not in IMPLS:
        raise ValueError(f"sparse_self_attention: impl {impl!r} not in "
                         f"{IMPLS}")
    B, S, H, hd = q.shape
    if impl == "pallas":
        plan = cached_plan(sparsity_config, S, causal, q.device)
        return BlockSparseAttention.apply(q, k, v, plan, sm_scale)
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    return _dense(q, k, v, cached_layout(sparsity_config, S), causal, scale)


class SparseSelfAttention(torch.nn.Module):
    """Module mirroring the reference class (no parameters)."""

    def __init__(self, sparsity_config: SparsityConfig,
                 attn_mask_mode: str = "mul", impl: str = "dense"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"SparseSelfAttention: impl {impl!r} not in "
                             f"{IMPLS}")
        self.sparsity_config = sparsity_config
        self.attn_mask_mode = attn_mask_mode
        self.impl = impl

    def forward(self, query, key, value, causal=False):
        return sparse_self_attention(query, key, value,
                                     self.sparsity_config, causal=causal,
                                     impl=self.impl)
