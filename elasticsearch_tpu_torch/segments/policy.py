"""Tiered merge selection: the Lucene TieredMergePolicy shape (port of
`elasticsearch_tpu/segments/policy.py`).

Small sealed generations accumulate until a size tier holds `tier_size`
of them, then one merge folds the tier into the next band, so merge work
stays O(n log n) over an index's life while searches never block.

Selection is contiguous on purpose: the generation list is the flat row
order (the base first, seals appended in order), and the tie-break that
makes generational search equal to the single corpus's follows that
order. Merging a contiguous run and installing the result at the run's
place keeps the order by construction; merged generations land left of
newer seals, so same-tier generations sit side by side anyway.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence


class MergeSpec(NamedTuple):
    """One selected merge: generations [start, stop) fold into one."""

    start: int
    stop: int
    reason: str   # "tier_full" | "l0_overflow" | "tombstone_gc" | "force"


class TieredMergePolicy:
    """The next merge of a generation list, or None.

    tier_size:  merge when a contiguous run holds >= this many generations
                of one size tier (Lucene's segmentsPerTier)
    max_l0:     cap on tier-0 (freshly sealed) generations: past it the
                trailing run of them merges even below tier_size, which
                bounds a search's fan-out under a fast refresh cadence
    gc_deleted_fraction: a generation more than this fraction dead is
                compacted alone (expungeDeletes)
    """

    def __init__(self, tier_size: int = 4, max_l0: int = 8,
                 gc_deleted_fraction: float = 0.5):
        self.tier_size = max(2, int(tier_size))
        self.max_l0 = max(1, int(max_l0))
        self.gc_deleted_fraction = float(gc_deleted_fraction)

    def select(self, gens: Sequence) -> Optional[MergeSpec]:
        """The next merge over `gens` (objects with .tier, .n_rows and
        .dead_rows), or None when the set is steady. Full tiers come
        first, then the L0 overflow, then tombstone GC."""
        n = len(gens)
        if n == 0:
            return None
        # 1. a contiguous same-tier run at tier_size
        run_start, run_tier = 0, gens[0].tier
        for i in range(1, n + 1):
            tier = gens[i].tier if i < n else None
            if tier != run_tier:
                if i - run_start >= self.tier_size:
                    return MergeSpec(run_start, run_start + self.tier_size,
                                     "tier_full")
                run_start, run_tier = i, tier
        # 2. L0 overflow: merge the run of tier-0 seals around the first
        l0 = [i for i in range(n) if gens[i].tier == 0]
        if len(l0) > self.max_l0:
            start = l0[0]
            while start > 0 and gens[start - 1].tier == 0:
                start -= 1
            stop = start + 1
            while stop < n and gens[stop].tier == 0:
                stop += 1
            if stop - start >= 2:
                return MergeSpec(start, stop, "l0_overflow")
        # 3. tombstone GC (a one-generation compaction)
        for i in range(n):
            g = gens[i]
            if g.n_rows > 0 and g.dead_rows > 0 \
                    and g.dead_rows / g.n_rows > self.gc_deleted_fraction:
                return MergeSpec(i, i + 1, "tombstone_gc")
        return None

    @staticmethod
    def force(gens: Sequence) -> Optional[MergeSpec]:
        """Everything into one generation (Lucene's forceMerge(1)); None
        when already one clean generation."""
        if len(gens) > 1 or (len(gens) == 1 and gens[0].dead_rows > 0):
            return MergeSpec(0, len(gens), "force")
        return None
