"""One device generation: an immutable sealed slice of a field's corpus
(port of `elasticsearch_tpu/segments/generation.py`).

The device analog of a sealed Lucene segment: a `Corpus` padded to the
pow-2 row ladder (`ops/dispatch.bucket_gen_rows`), the engine rows of its
rows, a `columnar.RowSource` resolving its raw host rows through the
shared block store (a generation pins no private copy of its rows), and
the tombstones a delete sets instead of a rebuild.

Generations are copy-on-write: tombstoning returns a new object sharing
the device corpus, so a search dispatched against an earlier generation
set keeps reading valid tensors. A sealed generation is searched on the
exact route (`ops/knn.knn_search`, the `segments.knn` route of the
reference); the base built by a full build keeps the monolithic kernel
route (`knn_search_auto`) while it has no tombstone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import knn as knn_ops

# the route names of the reference: the full build's base, and a sealed or
# merged generation
KERNEL_BASE = "knn.exact"
KERNEL_SEALED = "segments.knn"


def row_index_of(row_map: np.ndarray) -> np.ndarray:
    """Engine row -> position in an ascending row map (-1: not in it)."""
    n = int(row_map[-1]) + 1 if len(row_map) else 0
    index = np.full(n, -1, dtype=np.int32)
    index[row_map] = np.arange(len(row_map), dtype=np.int32)
    return index


def generation_tier(n_rows: int) -> int:
    """Size tier of a generation (the TieredMergePolicy band): tier t holds
    generations whose row bucket is GEN_ROW_BUCKET_MIN << t; rows past the
    bucket cap all land in the top band."""
    bucket = dispatch.bucket_gen_rows(max(int(n_rows), 1))
    return max(0, (bucket // dispatch.GEN_ROW_BUCKET_MIN).bit_length() - 1)


class Generation:
    """Immutable device generation + host bookkeeping."""

    __slots__ = ("gen_id", "corpus", "row_map", "source", "tombstones",
                 "kernel", "router", "_live_cache", "_row_index",
                 "_live_device")

    def __init__(self, gen_id: int, corpus, row_map: np.ndarray, source,
                 tombstones: Optional[np.ndarray] = None,
                 kernel: str = KERNEL_SEALED, router=None):
        self.gen_id = gen_id
        self.corpus = corpus              # knn_ops.Corpus on the device
        self.row_map = row_map            # [n_rows] engine rows
        self.source = source              # columnar.RowSource of its rows
        self.tombstones = (np.zeros(len(row_map), dtype=bool)
                           if tombstones is None else tombstones)
        self.kernel = kernel
        self.router = router              # ann.IVFRouter (an IVF base)
        self._live_cache = None
        self._row_index = None
        self._live_device = None

    # ------------------------------------------------------------ shape
    @property
    def n_rows(self) -> int:
        return len(self.row_map)

    @property
    def n_pad(self) -> int:
        return self.corpus.matrix.shape[0]

    @property
    def tier(self) -> int:
        return generation_tier(self.n_rows)

    @property
    def dead_rows(self) -> int:
        return int(self.tombstones.sum())

    @property
    def live_rows(self) -> int:
        return self.n_rows - self.dead_rows

    @property
    def has_tombstones(self) -> bool:
        return bool(self.tombstones.any())

    @property
    def nbytes(self) -> int:
        """Resident device bytes (matrix, norms, scales, residual)."""
        c = self.corpus
        return sum(t.nbytes for t in (c.matrix, c.sq_norms, c.scales,
                                      c.residual, c.residual_scales)
                   if t is not None)

    # ----------------------------------------------------------- copies
    def with_tombstones(self, tombstones: np.ndarray) -> "Generation":
        """Copy-on-write tombstone install: shares the device corpus and
        the row source, and drops the IVF router (its layout would keep
        returning dead rows; the merge thread rebuilds it when it
        compacts)."""
        return Generation(self.gen_id, self.corpus, self.row_map,
                          self.source, tombstones=tombstones,
                          kernel=self.kernel)

    def live_mask(self) -> np.ndarray:
        """[n_rows] bool: True for rows without a tombstone."""
        if self._live_cache is None:
            self._live_cache = ~self.tombstones
        return self._live_cache

    def live_device_mask(self) -> torch.Tensor:
        """[n_pad] bool on the corpus's device: the live rows, padding
        off. Made once a generation (it is immutable)."""
        if self._live_device is None:
            m = np.zeros(self.n_pad, dtype=bool)
            m[:self.n_rows] = self.live_mask()
            self._live_device = torch.from_numpy(m).to(self.corpus.device)
        return self._live_device

    def row_index(self) -> np.ndarray:
        """Engine row -> position in this generation (-1: not in it), made
        at the generation's first filtered search."""
        if self._row_index is None:
            self._row_index = row_index_of(self.row_map)
        return self._row_index


def build_generation(gen_id: int, vectors: np.ndarray, row_map: np.ndarray,
                     metric: str, dtype: str, rescore: bool = False,
                     source=None, device="cuda") -> Generation:
    """Seal host rows into a device generation padded to the row ladder:
    the refresh's only device work, O(delta). `source` is the RowSource of
    exactly these rows (the block store's, which pins nothing); without
    one the array itself becomes a private source."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n = len(vectors)
    corpus = knn_ops.build_corpus(
        vectors, metric=metric, dtype=dtype,
        pad_to=dispatch.bucket_gen_rows(n), residual=rescore, device=device)
    if source is None:
        from elasticsearch_tpu_torch.columnar.store import RowSource
        source = RowSource.from_array(vectors)
    return Generation(gen_id, corpus, np.asarray(row_map, dtype=np.int64),
                      source, kernel=KERNEL_SEALED)
