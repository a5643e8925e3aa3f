"""Sealed segments and point-in-time readers (port of the kNN slice of
`elasticsearch_tpu/index/segment.py`).

A segment holds its documents' `_id`s, their stored `_source` (without the
dense_vector and rank_vectors values), one contiguous [num_docs, dims] f32
block per vector field with a presence mask — the shape the device corpus
ingests at refresh — and, per `rank_vectors` field, one ragged f32
[total_tokens, dims] token matrix with per-doc offsets and presence.
Vectors stay numpy blocks: a million 768-d vectors (or ten million tokens)
as Python float lists in `_source` would take tens of GB of host memory, so
`_source` is re-assembled from the blocks when a hit or a GET renders it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np


class Segment:
    """Immutable sealed segment."""

    __slots__ = ("seg_id", "base", "num_docs", "ids", "sources", "vectors",
                 "tokens")

    def __init__(self, seg_id: int, base: int, ids: List[str],
                 sources: List[Optional[dict]],
                 vectors: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 tokens: Optional[Dict[str, Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]]] = None):
        self.seg_id = seg_id
        self.base = base                # global row id of local doc 0
        self.num_docs = len(ids)
        self.ids = ids                  # local doc -> _id
        self.sources = sources          # local doc -> source minus vectors
        self.vectors = vectors          # field -> (matrix [n,d] f32, present bool[n])
        # field -> (tokens [T, d] f32, offsets [n+1] int64, present bool[n]):
        # doc i's tokens are rows offsets[i]:offsets[i+1]
        self.tokens = tokens or {}

    def source(self, local: int) -> dict:
        src = dict(self.sources[local] or {})
        for field, (mat, present) in self.vectors.items():
            if present[local]:
                src[field] = mat[local].tolist()
        for field, (toks, offsets, present) in self.tokens.items():
            if present[local]:
                src[field] = toks[offsets[local]:offsets[local + 1]].tolist()
        return src


class SegmentView:
    """A segment plus its tombstones at one point in time."""

    __slots__ = ("segment", "live")

    def __init__(self, segment: Segment, deleted=None):
        self.segment = segment
        live = np.ones(segment.num_docs, dtype=bool)
        if deleted:
            live[np.fromiter(deleted, dtype=np.int64)] = False
        self.live = live


class ShardReader:
    """Point-in-time view over sealed segments (an IndexSearcher analog)."""

    def __init__(self, views: List[SegmentView]):
        self.views = views
        self._bases = [v.segment.base for v in views]

    @property
    def num_docs(self) -> int:
        return int(sum(int(v.live.sum()) for v in self.views))

    def _locate(self, row: int) -> Tuple[Segment, int]:
        i = bisect.bisect_right(self._bases, row) - 1
        seg = self.views[i].segment
        return seg, row - seg.base

    def get_id(self, row: int) -> str:
        seg, local = self._locate(row)
        return seg.ids[local]

    def get_source(self, row: int) -> dict:
        seg, local = self._locate(row)
        return seg.source(local)

    def vector_rows(self, field: str) -> Tuple[np.ndarray, np.ndarray]:
        """(matrix [m, d] f32, row_map [m] global rows) of the live documents
        holding `field`, in row order."""
        mats, rows = [], []
        for view in self.views:
            seg = view.segment
            if field not in seg.vectors:
                continue
            mat, present = seg.vectors[field]
            keep = present & view.live
            if keep.all():
                mats.append(mat)
                rows.append(np.arange(seg.num_docs, dtype=np.int64) + seg.base)
            else:
                locs = np.nonzero(keep)[0]
                mats.append(mat[locs])
                rows.append(locs.astype(np.int64) + seg.base)
        if not mats:
            return np.zeros((0, 0), dtype=np.float32), np.zeros(0, dtype=np.int64)
        if len(mats) == 1:
            return mats[0], rows[0]
        return np.concatenate(mats), np.concatenate(rows)
