"""Paged KV-cache block manager: the accounting half of paged attention.

The physical KV pool is divided into fixed-size blocks of ``block_size``
token slots; every admitted request owns a *block table* — the ordered
list of block ids whose concatenation is its logical KV stream (exactly
vLLM's layout; see also rtp-llm's cache_store block buffers).  This class
is the authority for capacity: the scheduler admits a request only when
``can_admit`` says its worst-case token budget fits, and frees the blocks
on eviction.  It is pure Python — the physical gather that turns a block
table into the contiguous cache the attention kernel consumes lives in
``repro_torch.models.attention.gather_block_kv`` (the documented bridge a
paged attention kernel would replace).

Invariants maintained (and property-tested in test_serving_scheduler):
  * a block id is owned by at most one request at a time,
  * ``free_blocks + sum(len(table))`` over live requests == ``num_blocks``,
  * freeing twice, or extending an unknown request, raises,
  * ``defrag`` only relabels blocks (a permutation onto the lowest free
    ids) and returns the old->new map the physical pool must apply.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class BlockCapacityError(RuntimeError):
    """Raised when an allocation does not fit the pool."""


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` token slots."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(block_size))


@dataclasses.dataclass
class _Entry:
    table: List[int]
    n_tokens: int          # token slots actually written (for utilization)


class BlockManager:
    """Fixed-pool allocator of KV blocks with per-request block tables."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # free list kept sorted ascending so allocation is deterministic
        # (lowest ids first) and fragmentation is observable.
        self._free: List[int] = list(range(self.num_blocks))
        self._entries: Dict[str, _Entry] = {}

    # -- capacity ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        """True when a request needing ``n_tokens`` worst-case slots fits."""
        return blocks_for(n_tokens, self.block_size) <= len(self._free)

    def utilization(self) -> float:
        """Written token slots / allocated slots (1.0 = no internal waste)."""
        alloc = self.used_blocks * self.block_size
        if alloc == 0:
            return 1.0
        written = sum(e.n_tokens for e in self._entries.values())
        return written / alloc

    # -- lifecycle ---------------------------------------------------------
    def allocate(self, rid: str, n_tokens: int) -> List[int]:
        """Reserve blocks for ``n_tokens`` slots; returns the block table.

        The scheduler reserves a request's *worst case* (prompt + max new
        tokens, clamped to the ring capacity) at admission, so no later
        step can run out mid-stream — capacity-based admission gating
        with no preemption path needed."""
        if rid in self._entries:
            raise KeyError(f"request {rid!r} already has an allocation")
        need = blocks_for(n_tokens, self.block_size)
        if need > len(self._free):
            raise BlockCapacityError(
                f"need {need} blocks, only {len(self._free)} free")
        table = self._free[:need]
        del self._free[:need]
        self._entries[rid] = _Entry(table=table, n_tokens=0)
        return list(table)

    def extend(self, rid: str, n_tokens: int) -> List[int]:
        """Grow ``rid``'s table by blocks for ``n_tokens`` more slots."""
        e = self._require(rid)
        need = blocks_for(n_tokens, self.block_size)
        if need > len(self._free):
            raise BlockCapacityError(
                f"need {need} blocks, only {len(self._free)} free")
        new = self._free[:need]
        del self._free[:need]
        e.table.extend(new)
        return list(new)

    def append_tokens(self, rid: str, n: int = 1) -> None:
        """Account ``n`` written token slots (wraps at table capacity like
        the ring buffer it mirrors)."""
        e = self._require(rid)
        cap = len(e.table) * self.block_size
        e.n_tokens = min(e.n_tokens + int(n), cap)

    def free(self, rid: str) -> int:
        """Release every block of ``rid``; returns how many were freed."""
        e = self._entries.pop(rid, None)
        if e is None:
            raise KeyError(f"request {rid!r} has no allocation (double free?)")
        self._free.extend(e.table)
        self._free.sort()
        return len(e.table)

    # -- views -------------------------------------------------------------
    def block_table(self, rid: str) -> List[int]:
        return list(self._require(rid).table)

    def n_tokens(self, rid: str) -> int:
        return self._require(rid).n_tokens

    def requests(self) -> List[str]:
        return list(self._entries)

    def owner_of(self, block_id: int) -> Optional[str]:
        for rid, e in self._entries.items():
            if block_id in e.table:
                return rid
        return None

    def fragmentation(self) -> float:
        """Mean relative spread of live tables (0 = every table contiguous).

        The spread of a table occupying id range [lo, hi] with k blocks is
        (hi - lo + 1 - k) / k: extra id-space the physical gather must
        stride over."""
        if not self._entries:
            return 0.0
        spreads = []
        for e in self._entries.values():
            if not e.table:
                continue
            k = len(e.table)
            spreads.append((max(e.table) - min(e.table) + 1 - k) / k)
        return sum(spreads) / len(spreads) if spreads else 0.0

    def defrag(self) -> Dict[int, int]:
        """Relabel live blocks onto the lowest ids, tables kept in order.

        Returns the {old_id: new_id} map the physical pool must replay
        (one gather per moved block).  Deterministic: requests are
        processed in insertion order."""
        mapping: Dict[int, int] = {}
        nxt = 0
        for e in self._entries.values():
            new_table = []
            for b in e.table:
                mapping[b] = nxt
                new_table.append(nxt)
                nxt += 1
            e.table = new_table
        self._free = list(range(nxt, self.num_blocks))
        return {o: n for o, n in mapping.items() if o != n}

    def check(self) -> None:
        """Assert the pool invariants (cheap; tests call it after every op)."""
        seen = set(self._free)
        if len(seen) != len(self._free):
            raise AssertionError("duplicate ids in free list")
        total = len(self._free)
        for rid, e in self._entries.items():
            for b in e.table:
                if b in seen:
                    raise AssertionError(f"block {b} owned twice ({rid})")
                seen.add(b)
            total += len(e.table)
        if total != self.num_blocks or seen != set(range(self.num_blocks)):
            raise AssertionError("pool accounting does not cover all blocks")

    def _require(self, rid: str) -> _Entry:
        e = self._entries.get(rid)
        if e is None:
            raise KeyError(f"unknown request {rid!r}")
        return e
