"""Block-granular KV-cache accounting: a free-list allocator over a pool
of fixed-size token blocks (counterpart of
``deepspeed_tpu/serving/block_manager.py`` without the prefix cache and
the tiers).

The physical cache lives in the scheduler as a position-flat pool
``[L, num_blocks * block_size, KV, hd]``; this class owns only the
integer bookkeeping.  Block 0 is reserved as the trash block: padding
rows and padding positions point at it, so their (ignored) cache writes
never land in a live block.
"""
from typing import Dict, List, Optional


class BlockManager:
    TRASH_BLOCK = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need >= 2 "
                             "(block 0 is the reserved trash block)")
        if block_size < 1:
            raise ValueError(f"block_size={block_size}: need >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently-freed blocks are re-handed first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}     # request_id -> blocks

    @property
    def num_usable_blocks(self) -> int:
        return self.num_blocks - 1          # minus the trash block

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_allocated_blocks(self) -> int:
        return self.num_usable_blocks - self.num_free_blocks

    def utilization(self) -> float:
        return self.num_allocated_blocks / max(self.num_usable_blocks, 1)

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return max(1, -(-num_tokens // self.block_size))

    def fits_ever(self, num_tokens: int) -> bool:
        """Could a request of this total length run on an EMPTY pool?"""
        return self.blocks_for_tokens(num_tokens) <= self.num_usable_blocks

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, request_id: int, n: int) -> Optional[List[int]]:
        """Append ``n`` fresh blocks to the request's table; None (and no
        state change) when the pool can't supply them."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._tables.setdefault(request_id, []).extend(got)
        return got

    def block_table(self, request_id: int) -> List[int]:
        return self._tables.get(request_id, [])

    def free(self, request_id: int):
        """Release every block of the request (retire/evict).  Idempotent:
        a second free of the same request is a no-op."""
        self._free.extend(self._tables.pop(request_id, []))

    def check_invariant(self):
        """Allocation-accounting invariant: no block is both free and
        live, none appears twice, the trash block never leaks, and
        ``free + live == num_blocks - 1``.  Raises AssertionError."""
        live: List[int] = [b for t in self._tables.values() for b in t]
        if len(set(live)) != len(live):
            raise AssertionError(
                "block accounting: a block appears in two tables (or "
                f"twice in one): {sorted(live)}")
        if len(set(self._free)) != len(self._free):
            raise AssertionError(f"block accounting: duplicate block on "
                                 f"free list ({self._free})")
        overlap = set(live) & set(self._free)
        if overlap:
            raise AssertionError(
                f"block accounting: blocks both live and free: {overlap}")
        if self.TRASH_BLOCK in set(live) | set(self._free):
            raise AssertionError("block accounting: trash block 0 leaked "
                                 "into the allocatable set")
        if len(self._free) + len(live) != self.num_blocks - 1:
            raise AssertionError(
                f"block accounting: free({len(self._free)}) + "
                f"live({len(live)}) != {self.num_blocks - 1} "
                "(leak or double-free)")
        return True

    def position_index(self, request_id: int, pos: int) -> int:
        """Flat pool position for the request's logical token ``pos``."""
        table = self._tables[request_id]
        return table[pos // self.block_size] * self.block_size \
            + pos % self.block_size
