"""Per-segment vector blocks of `dense_vector` fields, token blocks of
`rank_vectors` fields, postings blocks of text fields and learned-sparse
postings blocks of feature-map fields (port of the vector, token, postings
and sparse parts of `elasticsearch_tpu/columnar/blocks.py`).

A `VectorBlock` is one segment's live rows of one dense_vector field with
their engine rows, as positions into the segment's own array (no copy,
also with tombstones: the rows materialize only when gathered). The
vector store reads them
through `columnar/store.py`, whose cache shares them with the generations
built from them.

A `PostingsBlock` is one segment's live postings of one text field in
dense live-slot space (live docs renumbered 0..n_live-1 in ascending
local order), the input of the BM25 impact layout (`ops/bm25.py`), kept
in CSR form: one array a field, not an array pair a term. A
`SparsePostingsBlock` is the same for one `rank_features` (or
`sparse_vector`) field, the stored f32 weights in place of the freqs: the
input of the learned-sparse layout (`ops/sparse.py`).

A `ValuesBlock` is one segment's live doc values of one field as the
aggregation store (`ops/aggs.py`) reads them: the f64 view, the presence
mask, optionally the raw values, and whether any doc holds a list.

A `TokenVectorBlock` is one segment's live token matrices of one field,
metric-prepped and codec-encoded through `quant/tokens.py`, with the pooled
per-doc centroids the coarse phase indexes. Blocks are immutable and keyed
by `fingerprint(view, variant)`, which changes whenever the segment's live
set does, so a refresh re-encodes only new or changed segments. The owner
of each cache is its reader (`vectors/late_interaction.py` for tokens,
`ops/aggs.py::AggFieldStore` for values, `columnar/store.py::STORE` for
vector blocks).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.index.segment import (
    FeatureMapColumn, numeric_view,
)
from elasticsearch_tpu_torch.quant import tokens as quant_tokens

# tokens prepped and encoded per pass: bounds the f32 temporaries of a
# ten-million-token segment (encoding is row-wise, so chunking is exact)
_CHUNK_TOKENS = 1 << 20


def fingerprint(view, extra: Tuple = ()) -> tuple:
    """(seg_id, num_docs, live_count) + extra: changes when a segment's
    live content would (within one engine a live count only shrinks)."""
    seg = view.segment
    return (seg.seg_id, seg.num_docs, int(view.live.sum())) + tuple(extra)


class VectorBlock:
    """One segment's live rows of one dense_vector field: rows ``locs`` of
    the segment's own f32 ``matrix`` (``locs`` None: all of them), never
    copied, and ``rows`` their engine rows. ``nbytes`` counts what the
    block adds beyond the segment."""

    __slots__ = ("fingerprint", "matrix", "locs", "rows", "nbytes")

    def __init__(self, fp: tuple, matrix: np.ndarray,
                 locs: Optional[np.ndarray], rows: np.ndarray):
        self.fingerprint = fp
        self.matrix = matrix
        self.locs = locs
        self.rows = rows
        self.nbytes = rows.nbytes + (0 if locs is None else locs.nbytes)

    @property
    def n_rows(self) -> int:
        return len(self.rows)


def extract_vector_block(view, field: str) -> Optional[VectorBlock]:
    """Live vector rows of one segment, in row order (None when the segment
    has no such field): the per-segment half of `ShardReader.vector_rows`,
    by reference."""
    seg = view.segment
    if field not in seg.vectors:
        return None
    fp = fingerprint(view)
    mat, present = seg.vectors[field]
    mat = np.asarray(mat, dtype=np.float32)
    keep = present & view.live
    if keep.all():
        return VectorBlock(fp, mat, None,
                           np.arange(seg.num_docs, dtype=np.int64) + seg.base)
    locs = np.nonzero(keep)[0].astype(np.int64)
    return VectorBlock(fp, mat, locs, locs + seg.base)


class TokenVectorBlock:
    """One segment's live `rank_vectors` token matrices, codec-encoded
    ragged: ``data`` [total_tokens, W] packed token rows (lane-padded
    width), ``scales`` [total_tokens] per-token codec aux, ``counts`` [n]
    tokens per doc, ``pooled`` [n, dims] f32 coarse centroids, ``rows`` [n]
    engine global row ids. Only docs carrying at least one token appear."""

    __slots__ = ("fingerprint", "data", "scales", "counts", "pooled",
                 "rows", "dims", "nbytes")

    def __init__(self, fp: tuple, data, scales, counts, pooled, rows,
                 dims: int):
        self.fingerprint = fp
        self.data = data
        self.scales = scales
        self.counts = counts
        self.pooled = pooled
        self.rows = rows
        self.dims = dims
        self.nbytes = (data.nbytes + scales.nbytes + counts.nbytes
                       + pooled.nbytes + rows.nbytes)

    @property
    def n_rows(self) -> int:
        return len(self.rows)


def _live_tokens(toks: np.ndarray, offsets: np.ndarray,
                 keep: np.ndarray) -> np.ndarray:
    """The token rows of docs `keep` (ascending), in doc order; the
    segment's own matrix when every doc holding tokens is kept."""
    starts, ends = offsets[keep], offsets[keep + 1]
    if int((ends - starts).sum()) == len(toks):
        return toks
    counts = ends - starts
    idx = np.repeat(starts - np.cumsum(counts) + counts, counts) \
        + np.arange(int(counts.sum()))
    return toks[idx]


def extract_token_vector_block(view, field: str, variant: tuple
                               ) -> Optional[TokenVectorBlock]:
    """Gather, metric-prep and codec-encode one segment's live token
    matrices. variant = (encoding, metric, dims); None when the segment
    carries no such field."""
    encoding, metric, dims = variant
    seg = view.segment
    entry = seg.tokens.get(field)
    if entry is None:
        return None
    toks, offsets, present = entry
    fp = fingerprint(view, (variant,))
    keep = np.nonzero(view.live & present)[0]
    if not len(keep):
        return TokenVectorBlock(
            fp,
            np.zeros((0, quant_tokens.packed_width(encoding, dims)),
                     dtype=np.uint8),
            np.zeros(0, dtype=np.float32),
            np.zeros(0, dtype=np.int32),
            np.zeros((0, dims), dtype=np.float32),
            np.zeros(0, dtype=np.int64), dims)
    counts = (offsets[keep + 1] - offsets[keep]).astype(np.int32)
    live = _live_tokens(toks, offsets, keep)
    doc_ends = np.cumsum(counts, dtype=np.int64)
    data_parts, scale_parts, pooled = [], [], []
    d0 = t0 = 0
    while d0 < len(keep):
        # whole docs, about _CHUNK_TOKENS tokens per pass
        d1 = max(int(np.searchsorted(doc_ends, t0 + _CHUNK_TOKENS,
                                     side="right")), d0 + 1)
        t1 = int(doc_ends[d1 - 1])
        prepped = quant_tokens.prep_tokens(live[t0:t1], metric)
        lo = 0
        for c in counts[d0:d1]:
            pooled.append(quant_tokens.pool_doc(prepped[lo:lo + c], metric))
            lo += int(c)
        data, scales = quant_tokens.encode_tokens(prepped, encoding, dims)
        data_parts.append(data)
        scale_parts.append(scales)
        d0, t0 = d1, t1
    return TokenVectorBlock(
        fp, np.concatenate(data_parts), np.concatenate(scale_parts), counts,
        np.stack(pooled), keep.astype(np.int64) + seg.base, dims)


class PostingsBlock:
    """One segment's live postings of one text field: `terms` sorted,
    term j's live slots (ascending) and freqs at starts[j]:starts[j + 1],
    `lengths` [n_live] f32 field lengths. Terms without a live posting are
    left out."""

    __slots__ = ("fingerprint", "terms", "starts", "slots", "freqs",
                 "lengths", "n_live", "nbytes")

    def __init__(self, fp: tuple, terms, starts, slots, freqs, lengths,
                 n_live: int):
        self.fingerprint = fp
        self.terms = terms
        self.starts = starts
        self.slots = slots
        self.freqs = freqs
        self.lengths = lengths
        self.n_live = n_live
        self.nbytes = (starts.nbytes + slots.nbytes + freqs.nbytes
                       + lengths.nbytes)


def extract_postings_block(view, field: str) -> PostingsBlock:
    """The live postings of `field` in one segment view, renumbered to
    live slots (the reference's `SegmentView.live_postings`)."""
    seg = view.segment
    live = view.live
    n_live = int(live.sum())
    slot_of = np.cumsum(live, dtype=np.int64) - 1
    fl = seg.field_lengths.get(field)
    lengths = (fl[live].astype(np.float32) if fl is not None
               else np.zeros(n_live, dtype=np.float32))
    fp = seg.postings.get(field)
    if fp is None:
        return PostingsBlock(fingerprint(view), np.zeros(0, dtype=str),
                             np.zeros(1, dtype=np.int64),
                             np.zeros(0, dtype=np.int32),
                             np.zeros(0, dtype=np.int32), lengths, n_live)
    keep = live[fp.doc_ids]
    per_term = np.add.reduceat(keep.astype(np.int64), fp.starts[:-1]) \
        if len(fp.doc_ids) else np.zeros(len(fp.terms), dtype=np.int64)
    has = per_term > 0
    starts = np.zeros(int(has.sum()) + 1, dtype=np.int64)
    np.cumsum(per_term[has], out=starts[1:])
    return PostingsBlock(
        fingerprint(view), fp.terms[has], starts,
        slot_of[fp.doc_ids[keep]].astype(np.int32), fp.freqs[keep],
        lengths, n_live)


class SparsePostingsBlock:
    """One segment's live feature maps inverted to feature-major runs in
    dense live-slot space: `terms` (the features) sorted, feature j's live
    slots (ascending) and stored f32 weights at starts[j]:starts[j + 1].
    `n_live` spans every live doc of the segment (a doc without the field
    is in no run), so the slot space is the lexical layout's. Features
    without a live posting are left out."""

    __slots__ = ("fingerprint", "terms", "starts", "slots", "weights",
                 "n_live", "nbytes")

    def __init__(self, fp: tuple, terms, starts, slots, weights,
                 n_live: int):
        self.fingerprint = fp
        self.terms = terms
        self.starts = starts
        self.slots = slots
        self.weights = weights
        self.n_live = n_live
        self.nbytes = starts.nbytes + slots.nbytes + weights.nbytes

    @property
    def features(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """feature -> (live slots ascending int32, f32 weights): the
        reference block's form."""
        return {t: (self.slots[lo:hi], self.weights[lo:hi])
                for t, lo, hi in zip(self.terms.tolist(),
                                     self.starts[:-1].tolist(),
                                     self.starts[1:].tolist())}


def extract_sparse_postings_block(view, field: str) -> SparsePostingsBlock:
    """The live feature maps of `field` in one segment view, renumbered to
    live slots (the reference's `extract_sparse_postings_block`, from the
    column's feature-major arrays instead of a walk over its dicts)."""
    live = view.live
    n_live = int(live.sum())
    col = view.segment.doc_values.get(field)
    if not isinstance(col, FeatureMapColumn):
        return SparsePostingsBlock(fingerprint(view), np.zeros(0, dtype=str),
                                   np.zeros(1, dtype=np.int64),
                                   np.zeros(0, dtype=np.int32),
                                   np.zeros(0, dtype=np.float32), n_live)
    names, starts, docs, weights = col.by_feature()
    keep = live[docs]
    per_term = np.add.reduceat(keep.astype(np.int64), starts[:-1]) \
        if len(docs) else np.zeros(len(names), dtype=np.int64)
    has = per_term > 0
    live_starts = np.zeros(int(has.sum()) + 1, dtype=np.int64)
    np.cumsum(per_term[has], out=live_starts[1:])
    slot_of = np.cumsum(live, dtype=np.int64) - 1
    return SparsePostingsBlock(
        fingerprint(view), names[has], live_starts,
        slot_of[docs[keep]].astype(np.int32), weights[keep], n_live)


class ValuesBlock:
    """One segment's live doc values of one field: `vals` f64 [n_live]
    (NaN where absent), `present`, `objs` (the raw values, or None when
    not asked for) and `multi_valued` (a doc holds a list)."""

    __slots__ = ("fingerprint", "vals", "present", "objs", "multi_valued")

    def __init__(self, fp: tuple, vals, present, objs, multi_valued: bool):
        self.fingerprint = fp
        self.vals = vals
        self.present = present
        self.objs = objs
        self.multi_valued = multi_valued


def extract_values_block(view, field: str, want_objs: bool) -> ValuesBlock:
    """`search/service.py::numeric_values` over a segment's live docs: a
    numeric column's f64 view, else `index/segment.py::numeric_view`."""
    seg = view.segment
    live_idx = np.nonzero(view.live)[0]
    n_live = len(live_idx)
    fp = fingerprint(view, (field, want_objs))
    col = seg.doc_values.get(field)
    vals = np.full(n_live, np.nan, dtype=np.float64)
    present = np.zeros(n_live, dtype=bool)
    objs = None
    multi = False
    if col is not None and n_live:
        raw = col.values[live_idx]
        multi = any(isinstance(v, list) for v in raw.tolist())
        if want_objs:
            objs = raw
        if col.numeric is not None:
            present[:] = col.present[live_idx]
            vals[present] = col.numeric[live_idx][present]
        else:
            vals, present = numeric_view(raw.tolist())
    elif want_objs:
        objs = np.empty(n_live, dtype=object)
    return ValuesBlock(fp, vals, present, objs, multi)
