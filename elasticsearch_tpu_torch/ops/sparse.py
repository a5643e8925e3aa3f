"""Learned-sparse retrieval (`rank_features`) on the BM25 board (port of
`elasticsearch_tpu/ops/sparse.py`).

A learned-sparse model (SPLADE, ELSER) gives each passage a map token ->
weight and scores a query's token weights by their dot product with it:
the computation BM25's impact layout already serves, a term-major add of
per-posting values into a score board, then the masked top k. So
`SparseField` subclasses `ops/bm25.py`'s `LexicalField` and overrides its
two ends:

* build: the postings come from the stored `rank_features` doc values
  (`columnar/blocks.py::SparsePostingsBlock`, kept by segment fingerprint
  as the text postings are), and the stored weights, rounded to f32, are
  the impacts: no idf or length math. The tile-padded CSR, the f32 / bf16
  / int8 impact dtypes (`index.sparse.impact_dtype`) and the boards are
  the parent's.

* search: a query is ({token: weight}, boost); each token's tiles carry
  the boost f32(f32(weight) * f32(boost)), so the kernel's impact * boost
  is stored weight * query weight. A query's plan entries are its
  in-vocabulary tokens in the query map's order, so every slot adds in
  that order, which is the order of the host walker
  (`search/queries_ext.py::WeightedTokensQuery`), and the f32 sums are
  its bits. Required matches are 1: any shared token matches.

The board calls count under `bm25_board` with the variant `sparse`. A
query of any width takes the board in one call (two launches): the
reference caps a device query at 256 tokens because it compiles a grid
of shapes, and the port compiles none.
"""

from __future__ import annotations

import numpy as np

from elasticsearch_tpu_torch.columnar import blocks as columnar
from elasticsearch_tpu_torch.ops.bm25 import LexicalField, LexicalShard

VARIANT = "sparse"


class SparseField(LexicalField):
    """One `rank_features` field's tile-padded weight layout: the parent's
    layout, boards, routes and tie-breaks, with the stored weights as the
    impacts and the query's token weights as the boosts."""

    VARIANT = VARIANT

    def sync(self, reader) -> bool:
        """(Re)build from the stored feature maps; True if rebuilt.
        Segments whose block is kept are not extracted again, and no
        corpus statistic needs a second pass."""
        version = self._version_of(reader)
        if version == self.version:
            return False
        blocks = self._sync_blocks(
            reader, version, columnar.extract_sparse_postings_block)
        terms, dfs, slot_flat, weight_flat = self._merge(blocks, "weights")
        ptr = np.zeros(len(dfs) + 1, dtype=np.int64)
        np.cumsum(dfs, out=ptr[1:])
        self.nnz = len(slot_flat)
        self._install_tiles(terms, dfs, ptr, slot_flat, weight_flat)
        self.version = version
        return True

    @staticmethod
    def _term_boosts(query):
        """A sparse query is ({token: weight}, boost): each token carries
        f32(f32(weight) * f32(boost)), in the map's order."""
        tokens, boost = query
        b = np.float32(boost)
        return ((str(t), np.float32(np.float32(w) * b))
                for t, w in tokens.items())


class SparseShard(LexicalShard):
    """Per-reader learned-sparse store: one SparseField per feature-map
    field, synced lazily, as the lexical store."""

    FIELD_CLS = SparseField
