"""The segment block store of vector fields: cache, composition, row
sources (port of the vector half of `elasticsearch_tpu/columnar/store.py`).

A `VectorBlock` (`columnar/blocks.py`) is extracted once per (segment,
field, live set), on first use, and cached against the Segment object
through a weak reference, so it goes when the engine drops its segment.
`vector_view` composes a reader's blocks by reference into a
`FieldRowsView`: the row map eagerly (8 bytes a row), the f32 matrix only
on demand, so an append-only refresh of a generational field reads the new
rows alone. A device generation (`segments/generation.py`) keeps a
`RowSource` over the blocks it was sealed from instead of a private copy
of its rows: merges, IVF retrains and the two-phase rescore gather rows
through it.

Thread contract: `_lock` guards the block index and the counters;
extraction runs outside it with a last-wins install (blocks are
immutable, so two racing extractors waste one extraction, never serve a
torn block).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch.columnar.blocks import (
    VectorBlock, extract_vector_block, fingerprint,
)


class _Absent:
    """Cached marker of a segment without the field, so steady syncs hit
    instead of counting an extraction that can never find a block."""

    __slots__ = ("fingerprint",)
    nbytes = 0

    def __init__(self, fp: tuple):
        self.fingerprint = fp


class SegmentBlockStore:
    """The shared vector block cache and its counters."""

    def __init__(self):
        self._lock = threading.Lock()
        # weakref.ref(segment) -> {field: block}; the ref's callback drops
        # the entry when the engine drops the segment
        self._entries: Dict[weakref.ref, Dict[str, object]] = {}
        self._counters = {"hits": 0, "extracts": 0, "evictions": 0,
                          "compositions": {"cached": 0, "delta": 0,
                                           "full": 0}}

    def block(self, view, field: str) -> Tuple[Optional[VectorBlock], bool]:
        """(the cached block of one SegmentView and field, cached?); the
        block is None for a segment without the field."""
        seg = view.segment
        fp = fingerprint(view)
        with self._lock:
            entry = self._entries.get(weakref.ref(seg))
            blk = entry.get(field) if entry is not None else None
            if blk is not None and blk.fingerprint == fp:
                self._counters["hits"] += 1
                return (None if isinstance(blk, _Absent) else blk), True
        blk = extract_vector_block(view, field)
        with self._lock:
            self._counters["extracts"] += 1
            ref = weakref.ref(seg, self._evicted)
            self._entries.setdefault(ref, {})[field] = \
                blk if blk is not None else _Absent(fp)
        return blk, False

    def _evicted(self, ref) -> None:
        with self._lock:
            entry = self._entries.pop(ref, None)
            if entry:
                self._counters["evictions"] += len(entry)

    def vector_view(self, reader, field: str) -> "FieldRowsView":
        """A reader-wide view of one vector field over its segments'
        blocks (extracted for new or changed segments only). `refresh`
        says how it was composed: every block cached, some extracted (an
        incremental refresh), or all extracted."""
        blocks: List[VectorBlock] = []
        n_cached = n_extracted = 0
        for view in reader.views:
            blk, cached = self.block(view, field)
            if cached:
                n_cached += 1
            else:
                n_extracted += 1
            if blk is not None and blk.n_rows:
                blocks.append(blk)
        mode = ("cached" if n_extracted == 0
                else "delta" if n_cached else "full")
        with self._lock:
            self._counters["compositions"][mode] += 1
        return FieldRowsView(tuple(blocks), {
            "blocks": len(blocks), "cached": n_cached,
            "extracted": n_extracted, "mode": mode})

    def stats(self) -> dict:
        """Live blocks and their bytes, hits, extractions, evictions and
        the compositions by mode."""
        with self._lock:
            live = [b for e in self._entries.values() for b in e.values()
                    if not isinstance(b, _Absent)]
            return {"blocks": len(live),
                    "bytes": sum(b.nbytes for b in live),
                    "hits": self._counters["hits"],
                    "extracts": self._counters["extracts"],
                    "evictions": self._counters["evictions"],
                    "compositions": dict(self._counters["compositions"])}

    def reset(self) -> None:
        """Drop every block and zero the counters."""
        with self._lock:
            self._entries.clear()
            self._counters.update(
                hits=0, extracts=0, evictions=0,
                compositions={"cached": 0, "delta": 0, "full": 0})


# the process-wide store: one block a (segment, field) serves every shard
# store of the process
STORE = SegmentBlockStore()


class _Part:
    """One contiguous source slice: rows `idx` of `matrix` (None: all of
    it). `shared` marks a matrix owned by the block store or the engine's
    segments, which the holder does not pin."""

    __slots__ = ("matrix", "idx", "shared")

    def __init__(self, matrix: np.ndarray, idx: Optional[np.ndarray],
                 shared: bool):
        self.matrix = matrix
        self.idx = idx
        self.shared = shared

    @property
    def n_rows(self) -> int:
        return len(self.matrix) if self.idx is None else len(self.idx)

    def take(self, local: np.ndarray) -> "_Part":
        """Narrowed to `local` positions of this part (ascending)."""
        idx = local if self.idx is None else self.idx[local]
        return _Part(self.matrix, idx, self.shared)

    def materialize(self) -> np.ndarray:
        m = self.matrix if self.idx is None else self.matrix[self.idx]
        return np.asarray(m, dtype=np.float32)


class RowSource:
    """Host vector rows resolved through shared blocks: what a generation
    keeps instead of a private copy of its rows. `gather` materializes
    rows on demand (a transient of the rows asked for)."""

    __slots__ = ("parts", "n_rows", "dims")

    def __init__(self, parts: Sequence[_Part], dims: int):
        self.parts = tuple(p for p in parts if p.n_rows)
        self.n_rows = sum(p.n_rows for p in self.parts)
        self.dims = dims

    @staticmethod
    def from_array(vectors: np.ndarray) -> "RowSource":
        """A private (pinning) source over an array, for direct
        construction."""
        vectors = np.asarray(vectors, dtype=np.float32)
        d = vectors.shape[1] if vectors.ndim == 2 else 0
        return RowSource((_Part(vectors, None, shared=False),), d)

    @staticmethod
    def concat(sources: Sequence["RowSource"]) -> "RowSource":
        parts: List[_Part] = []
        dims = 0
        for s in sources:
            parts.extend(s.parts)
            dims = dims or s.dims
        return RowSource(parts, dims)

    def gather(self, sel: Optional[np.ndarray] = None) -> np.ndarray:
        """Rows as f32 [m, d]: all of them (sel None), a bool mask over
        [0, n_rows), or ascending positions."""
        if sel is None:
            mats = [p.materialize() for p in self.parts]
            return (np.concatenate(mats, axis=0) if mats
                    else np.zeros((0, self.dims), dtype=np.float32))
        return self.select(sel).gather()

    def select(self, sel: np.ndarray) -> "RowSource":
        """The source narrowed to a bool mask over [0, n_rows) or to
        ascending positions; it shares the matrices."""
        sel = np.asarray(sel)
        if sel.dtype == bool:
            sel = np.nonzero(sel)[0]
        parts: List[_Part] = []
        off = 0
        for p in self.parts:
            n = p.n_rows
            lo, hi = np.searchsorted(sel, [off, off + n])
            if hi > lo:
                parts.append(p.take(sel[lo:hi].astype(np.int64) - off))
            off += n
        return RowSource(parts, self.dims)

    def slice(self, start: int, stop: Optional[int] = None) -> "RowSource":
        """The contiguous range [start, stop): a pure append's delta."""
        stop = self.n_rows if stop is None else stop
        parts: List[_Part] = []
        off = 0
        for p in self.parts:
            n = p.n_rows
            lo, hi = max(start - off, 0), min(stop - off, n)
            if lo < hi:
                parts.append(p if (lo, hi) == (0, n) else
                             p.take(np.arange(lo, hi, dtype=np.int64)))
            off += n
        return RowSource(parts, self.dims)

    def private_nbytes(self) -> int:
        """Host bytes this source pins beyond the shared blocks: 0 for
        every source made from the block store."""
        seen = set()
        total = 0
        for p in self.parts:
            if p.shared:
                continue
            marker = (p.matrix.__array_interface__["data"][0],
                      p.matrix.shape)
            if marker not in seen:
                seen.add(marker)
                total += p.matrix.nbytes
        return total


class FieldRowsView:
    """One vector field of a reader over its blocks: the row map eager
    (int64), the matrix on demand. `refresh` says how it was composed."""

    __slots__ = ("blocks", "row_map", "n_rows", "dims", "refresh")

    def __init__(self, blocks: Tuple[VectorBlock, ...], refresh: dict):
        self.blocks = blocks
        self.row_map = (np.concatenate([b.rows for b in blocks])
                        if blocks else np.zeros(0, dtype=np.int64))
        self.n_rows = len(self.row_map)
        self.dims = blocks[0].matrix.shape[1] if blocks else 0
        self.refresh = refresh

    def as_source(self) -> RowSource:
        return RowSource(tuple(_Part(b.matrix, b.locs, shared=True)
                               for b in self.blocks), self.dims)

    def source_slice(self, start: int,
                     stop: Optional[int] = None) -> RowSource:
        return self.as_source().slice(start, stop)

    def source_select(self, sel: np.ndarray) -> RowSource:
        return self.as_source().select(sel)

    def rows(self, start: int, stop: Optional[int] = None) -> np.ndarray:
        """Rows [start, stop) as f32: the incremental refresh's read."""
        return self.source_slice(start, stop).gather()

    def matrix(self) -> np.ndarray:
        """The whole field as f32 [n, d] (a full build only); (0, 0) when
        the field has no row."""
        if not self.blocks:
            return np.zeros((0, 0), dtype=np.float32)
        return self.as_source().gather()
