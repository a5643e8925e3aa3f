"""Sealed segments and point-in-time readers (port of the kNN and filter
slice of `elasticsearch_tpu/index/segment.py`).

A segment holds its documents' `_id`s, their stored `_source` (as sent,
less the vectors given as arrays), one contiguous [num_docs, dims] f32
block per vector field with a presence mask — the shape the device corpus
ingests at refresh — and, per `rank_vectors` field, one ragged f32
[total_tokens, dims] token matrix with per-doc offsets and presence.
Vectors loaded as arrays stay numpy blocks: a million 768-d vectors (or
ten million tokens) as Python float lists in `_source` would take tens of
GB of host memory, so such a document's `_source` renders them from the
blocks when a hit or a GET reads it.

Rows are int64 throughout: a multi-shard index's combined reader rebases
each shard's segments by shard_id * 2^40 (`indices/service.py`).

Keyword, numeric, boolean, date and ip fields keep term postings
(ascending local doc ids and term frequencies) and a doc-values column
(the values, and for numbers, dates and addresses a float64 view with a
presence mask), which the filter queries (`search/queries.py`) read; a
geo point keeps its (lat, lon) and a range type its {gte, lte} interval
as plain values. Fields are dotted paths. Text fields keep term postings with
each occurrence's position, and each document's field length (its token
count) with the segment's total, which BM25 (`search/queries.py`,
`ops/bm25.py`) reads through the reader's statistics. Feature-map fields
(`rank_features`, `sparse_vector`) keep a `FeatureMapColumn` in the
segment's doc values: integer feature codes and f64 weights, which the
learned-sparse layout (`ops/sparse.py`) and the `sparse_vector` walker
(`search/queries_ext.py`) read feature-major.
"""

from __future__ import annotations

import bisect
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def numeric_view(values) -> Tuple[np.ndarray, np.ndarray]:
    """(values f64, present) of raw doc values read as numbers: a list's
    first value, a boolean as 1.0 or 0.0, anything else not a number
    absent (NaN)."""
    vals = np.full(len(values), np.nan, dtype=np.float64)
    present = np.zeros(len(values), dtype=bool)
    for j, x in enumerate(values):
        if isinstance(x, list):
            x = x[0] if x else None
        if isinstance(x, bool):
            x = 1.0 if x else 0.0
        if isinstance(x, (int, float)):
            vals[j], present[j] = float(x), True
    return vals, present


class DocValuesColumn:
    """Per-doc values of one field within one segment: `values` (object
    array, None = missing) and, when the field's first value is a number,
    a float64 `numeric` view (a multi-valued doc contributes its first
    value) with its `present` mask; else `numeric` is None and `present`
    marks the docs holding a value."""

    __slots__ = ("values", "numeric", "present", "multi", "derived")

    def __init__(self, values: np.ndarray, numeric: Optional[np.ndarray],
                 present: np.ndarray, multi: Optional[np.ndarray] = None):
        self.values = values
        self.numeric = numeric
        self.present = present
        # numeric columns: the docs holding a list of values
        self.multi = multi
        # views made from the values at their first use and kept with the
        # sealed column: the geo queries' (lat, lon) and envelope arrays
        self.derived: Dict[str, Any] = {}

    @classmethod
    def build(cls, n: int, locals_: np.ndarray,
              values: List[Any]) -> "DocValuesColumn":
        """The column of `n` docs where doc locals_[j] holds values[j]
        (locals_ ascending), equal to the reference's per-value
        constructor but filled with numpy."""
        col = np.empty(n, dtype=object)
        col[locals_] = np.fromiter(values, dtype=object, count=len(values))
        present = np.zeros(n, dtype=bool)
        present[locals_] = True
        first = values[0] if values else None
        if not (isinstance(first, (int, float))
                and not isinstance(first, bool)):
            return cls(col, None, present)
        multi = [j for j, v in enumerate(values) if isinstance(v, list)]
        multi_mask = np.zeros(n, dtype=bool)
        if multi:
            values = list(values)
            for j in multi:
                values[j] = values[j][0]
            multi_mask[np.asarray(locals_)[multi]] = True
        numeric = np.zeros(n, dtype=np.float64)
        numeric[locals_] = np.asarray(values, dtype=np.float64)
        return cls(col, numeric, present, multi_mask)

    @classmethod
    def of_ints(cls, values: np.ndarray) -> "DocValuesColumn":
        """A column of one int a doc, every doc holding one (the rows'
        `_version` and `_primary_term`)."""
        return cls(values.astype(object), values.astype(np.float64),
                   np.ones(len(values), dtype=bool),
                   np.zeros(len(values), dtype=bool))

    def get(self, local_doc: int) -> Any:
        return self.values[local_doc]


class FeatureMapColumn:
    """Per-doc feature maps (`rank_features`, `sparse_vector`) of one field
    within one segment, kept as integer codes: doc i's map holds the
    features names[codes[offsets[i]:offsets[i + 1]]] with the weights at
    the same places, in the map's own order, as f64 (`float(v)` of the
    value sent). A doc whose value is a list of maps keeps it in `other`,
    as a plain doc value. `values[i]` (and `get(i)`) gives doc i's value as
    the reference's column holds it: its map as a dict, its list, or
    None; `numeric` is None, `present` marks the docs holding a value.

    `by_feature()` is the feature-major form the learned-sparse layout and
    the `sparse_vector` walker read: made with one integer sort on first
    use and kept, since a segment never changes."""

    __slots__ = ("names", "offsets", "codes", "weights", "present",
                 "other", "_by_feature")

    numeric = None

    def __init__(self, names: np.ndarray, offsets: np.ndarray,
                 codes: np.ndarray, weights: np.ndarray, present: np.ndarray,
                 other: Dict[int, Any]):
        self.names = names              # code -> feature name
        self.offsets = offsets          # int64 [num_docs + 1]
        self.codes = codes              # int32 [postings]
        self.weights = weights          # float64 [postings]
        self.present = present
        self.other = other
        self._by_feature = None

    @property
    def values(self) -> "FeatureMapColumn":
        return self

    def __getitem__(self, local_doc) -> Any:
        local_doc = int(local_doc)
        if local_doc in self.other:
            return self.other[local_doc]
        if not self.present[local_doc]:
            return None
        lo, hi = self.offsets[local_doc], self.offsets[local_doc + 1]
        return dict(zip(self.names[self.codes[lo:hi]].tolist(),
                        self.weights[lo:hi].tolist()))

    def get(self, local_doc: int) -> Any:
        return self[local_doc]

    def by_feature(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """(features sorted [F], starts int64 [F + 1], docs int32, weights
        f32): feature j's docs (ascending) and weights at
        starts[j]:starts[j + 1]; the weights rounded to f32 once, as the
        reference's `np.asarray(weights, float32)` rounds them."""
        if self._by_feature is None:
            order_names = np.argsort(self.names, kind="stable")
            rank = np.empty(len(self.names), dtype=np.int32)
            rank[order_names] = np.arange(len(self.names), dtype=np.int32)
            post_rank = rank[self.codes]
            # the postings are doc-major, so a stable sort by feature keeps
            # each feature's docs ascending (a radix sort on 16-bit keys,
            # which a wordpiece vocabulary fits)
            order = np.argsort(post_rank.astype(np.uint16)
                               if len(self.names) <= 1 << 16 else post_rank,
                               kind="stable")
            counts = np.bincount(post_rank, minlength=len(self.names))
            starts = np.zeros(len(self.names) + 1, dtype=np.int64)
            np.cumsum(counts, out=starts[1:])
            doc_of = np.repeat(np.arange(len(self.offsets) - 1,
                                         dtype=np.int32),
                               np.diff(self.offsets))
            self._by_feature = (self.names[order_names], starts,
                                doc_of[order],
                                self.weights[order].astype(np.float32))
        return self._by_feature


class Postings:
    """Term postings within one segment: ascending local doc ids + freqs,
    and for a text field each doc's positions: doc i's are
    pos[pos_starts[i]:pos_starts[i + 1]] (`positions` is None without)."""

    __slots__ = ("doc_ids", "freqs", "positions")

    def __init__(self, doc_ids: np.ndarray, freqs: np.ndarray,
                 positions: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        self.doc_ids = doc_ids
        self.freqs = freqs
        self.positions = positions

    @property
    def doc_freq(self) -> int:
        return len(self.doc_ids)

    def doc_positions(self, i: int) -> Optional[List[int]]:
        """The positions of the term in the i-th doc of the list."""
        if self.positions is None:
            return None
        pos, starts = self.positions
        return pos[starts[i]:starts[i + 1]].tolist()


class FieldPostings:
    """Every term's postings of one field in one segment, in CSR form:
    `terms` sorted, term j's doc ids and freqs at starts[j]:starts[j + 1].
    A float field has about one term a document; one array a field, not
    a Postings object a term, keeps a million of them cheap to build and
    hold."""

    __slots__ = ("terms", "starts", "doc_ids", "freqs", "pos", "pos_starts",
                 "term_shape")

    def __init__(self, terms: np.ndarray, starts: np.ndarray,
                 doc_ids: np.ndarray, freqs: np.ndarray,
                 pos: Optional[np.ndarray] = None,
                 pos_starts: Optional[np.ndarray] = None):
        self.terms = terms
        self.starts = starts
        self.doc_ids = doc_ids
        self.freqs = freqs
        # text fields: posting j's positions are pos[pos_starts[j]:
        # pos_starts[j + 1]], in the order the analyzer gave them
        self.pos = pos
        self.pos_starts = pos_starts
        # (lengths, char bucket counts) of the terms, made by the fuzzy
        # term enumeration (`search/queries.py::_term_shape`) at its first
        # use
        self.term_shape = None

    @classmethod
    def build(cls, locals_: np.ndarray, terms: List[str]) -> "FieldPostings":
        """From parallel (local doc, term) pairs, a doc's repeated term
        counted in its frequency."""
        t = np.asarray(terms, dtype=str)
        docs = np.asarray(locals_, dtype=np.int32)
        order = np.lexsort((docs, t))
        t, docs = t[order], docs[order]
        new_term = np.ones(len(t), dtype=bool)
        new_term[1:] = t[1:] != t[:-1]
        new_pair = new_term.copy()
        new_pair[1:] |= docs[1:] != docs[:-1]
        pair_at = np.nonzero(new_pair)[0]
        freqs = np.diff(np.append(pair_at, len(t))).astype(np.int32)
        starts = np.append(np.nonzero(new_term[pair_at])[0], len(pair_at))
        return cls(t[new_term], starts.astype(np.int64), docs[pair_at], freqs)

    @classmethod
    def build_text(cls, locals_: np.ndarray, codes: np.ndarray,
                   vocab: List[str], positions: np.ndarray
                   ) -> "FieldPostings":
        """From parallel (local doc, term code, position) token
        occurrences, code c naming vocab[c]: the postings with each
        (term, doc)'s positions in occurrence order. Only the vocabulary
        is sorted as strings; the tokens sort by integer keys."""
        words = np.asarray(vocab, dtype=str)
        word_order = np.argsort(words, kind="stable")
        rank = np.empty(len(words), dtype=np.int64)
        rank[word_order] = np.arange(len(words))
        key = (rank[np.asarray(codes, dtype=np.int64)] << 32) \
            | np.asarray(locals_, dtype=np.int64)
        order = np.argsort(key, kind="stable")
        key = key[order]
        new_pair = np.ones(len(key), dtype=bool)
        new_pair[1:] = key[1:] != key[:-1]
        pair_at = np.nonzero(new_pair)[0]
        pair_key = key[pair_at]
        pair_rank = pair_key >> 32
        new_term = np.ones(len(pair_at), dtype=bool)
        new_term[1:] = pair_rank[1:] != pair_rank[:-1]
        freqs = np.diff(np.append(pair_at, len(key))).astype(np.int32)
        starts = np.append(np.nonzero(new_term)[0], len(pair_at))
        return cls(words[word_order[pair_rank[new_term]]],
                   starts.astype(np.int64),
                   (pair_key & 0xFFFFFFFF).astype(np.int32), freqs,
                   np.asarray(positions, dtype=np.int32)[order],
                   np.append(pair_at, len(key)).astype(np.int64))

    def get(self, term: str) -> Optional[Postings]:
        j = int(np.searchsorted(self.terms, term))
        if j >= len(self.terms) or self.terms[j] != term:
            return None
        lo, hi = self.starts[j], self.starts[j + 1]
        positions = None if self.pos is None else \
            (self.pos, self.pos_starts[lo:hi + 1])
        return Postings(self.doc_ids[lo:hi], self.freqs[lo:hi], positions)


class Segment:
    """Immutable sealed segment."""

    # `__weakref__`: the vector block cache (`columnar/store.py`) keys on
    # the segment weakly, so its blocks go with the segment
    __slots__ = ("seg_id", "base", "num_docs", "ids", "sources", "vectors",
                 "tokens", "postings", "doc_values", "routings",
                 "field_lengths", "total_terms", "seq_nos", "derived",
                 "__weakref__")

    def __init__(self, seg_id: int, base: int, ids: List[str],
                 sources: List[Optional[dict]],
                 vectors: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 tokens: Optional[Dict[str, Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]]] = None,
                 postings: Optional[Dict[str, FieldPostings]] = None,
                 doc_values: Optional[Dict[str, DocValuesColumn]] = None,
                 routings: Optional[List[Optional[str]]] = None,
                 field_lengths: Optional[Dict[str, np.ndarray]] = None,
                 seq_nos: Optional[np.ndarray] = None):
        self.seg_id = seg_id
        self.base = base                # global row id of local doc 0
        self.num_docs = len(ids)
        self.ids = ids                  # local doc -> _id
        self.sources = sources          # local doc -> source minus array vectors
        self.vectors = vectors          # field -> (matrix [n,d] f32, present bool[n])
        # field -> (tokens [T, d] f32, offsets [n+1] int64, present bool[n]):
        # doc i's tokens are rows offsets[i]:offsets[i+1]
        self.tokens = tokens or {}
        self.postings = postings or {}        # field -> FieldPostings
        self.doc_values = doc_values or {}    # field -> DocValuesColumn
        # local doc -> its routing value; None when no doc has one
        self.routings = routings
        # text field -> int32 [num_docs] token counts, and their sum
        self.field_lengths = field_lengths or {}
        self.total_terms = {f: int(fl.sum())
                            for f, fl in self.field_lengths.items()}
        self.seq_nos = seq_nos          # int64 [num_docs], or None
        # views of the ids made at their first use and kept with the
        # segment (a combined reader's copy shares them): the slice hashes
        self.derived: Dict[str, Any] = {}

    def get_postings(self, field: str, term: str) -> Optional[Postings]:
        f = self.postings.get(field)
        return f.get(term) if f else None

    def source(self, local: int) -> dict:
        src = dict(self.sources[local] or {})
        for field, (mat, present) in self.vectors.items():
            if present[local] and field not in src:
                src[field] = mat[local].tolist()
        for field, (toks, offsets, present) in self.tokens.items():
            if present[local] and field not in src:
                src[field] = toks[offsets[local]:offsets[local + 1]].tolist()
        return src


class SegmentView:
    """A segment plus its tombstones at one point in time."""

    __slots__ = ("segment", "live", "all_live")

    def __init__(self, segment: Segment, deleted=None):
        self.segment = segment
        live = np.ones(segment.num_docs, dtype=bool)
        if deleted:
            live[np.fromiter(deleted, dtype=np.int64)] = False
        self.live = live
        self.all_live = not deleted


_reader_gen = itertools.count(1)


class ShardReader:
    """Point-in-time view over sealed segments (an IndexSearcher analog).
    `gen` names the view, process-wide: the node query cache keys on it,
    so a refresh that made a new reader misses."""

    def __init__(self, views: List[SegmentView]):
        self.views = views
        self._bases = [v.segment.base for v in views]
        self.gen = next(_reader_gen)

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

    def get_routing(self, row: int) -> Optional[str]:
        seg, local = self._locate(row)
        return None if seg.routings is None else seg.routings[local]

    def get_seq_no(self, row: int) -> Optional[int]:
        seg, local = self._locate(row)
        return None if seg.seq_nos is None else int(seg.seq_nos[local])

    def locate_many(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(view index, local doc) of each global row, vectorised."""
        rows = np.asarray(rows, dtype=np.int64)
        bases = np.asarray(self._bases, dtype=np.int64)
        vi = np.searchsorted(bases, rows, side="right") - 1
        return vi, rows - bases[vi]

    def get_doc_value(self, field: str, row: int) -> Any:
        """The doc value of `field` at a global row, as its column holds
        it (None when the doc has none)."""
        seg, local = self._locate(row)
        col = seg.doc_values.get(field)
        return col.get(local) if col is not None else None

    def live_global_rows(self) -> np.ndarray:
        """Every live document's global row, ascending."""
        parts = [np.nonzero(v.live)[0] + v.segment.base for v in self.views]
        if not parts:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(parts).astype(np.int64)

    def docs_with_field_count(self, field: str) -> int:
        """Live documents holding `field`: a text field's with a token,
        another field's with a doc value."""
        total = 0
        for v in self.views:
            fl = v.segment.field_lengths.get(field)
            if fl is not None:
                total += int((v.live & (fl > 0)).sum())
                continue
            dv = v.segment.doc_values.get(field)
            if dv is not None:
                total += int((v.live & dv.present).sum())
        return total

    def doc_freq(self, field: str, term: str) -> int:
        """Live documents holding `term` in `field`."""
        total = 0
        for v in self.views:
            p = v.segment.get_postings(field, term)
            if p is not None:
                total += int(v.live[p.doc_ids].sum())
        return total

    def total_term_count(self, field: str) -> int:
        """Tokens of `field` over the segments, deleted documents
        included, as the reference counts them."""
        return sum(v.segment.total_terms.get(field, 0) for v in self.views)

    def avg_field_length(self, field: str) -> float:
        docs = self.docs_with_field_count(field)
        if docs == 0:
            return 0.0
        return self.total_term_count(field) / docs

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
