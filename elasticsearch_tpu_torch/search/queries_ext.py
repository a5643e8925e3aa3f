"""The host walkers of the `late_interaction`, `sparse_vector` /
`weighted_tokens` and `rank_feature` queries (port of
`LateInteractionQuery`, `WeightedTokensQuery` and `RankFeatureQuery` in
`elasticsearch_tpu/search/queries_ext.py`).

`late_interaction`:
score = sum over query tokens of the max over a doc's tokens of their dot
product (cosine normalizes both sides per token, per the field mapping), in
f32 numpy over the raw stored tokens: no quantization and no coarse
pruning. It serves a plain `_search {query: {late_interaction}}` body, as
the reference's query phase does, and it is the oracle the device path is
recall-gated against. A hybrid `late_interaction` leg never takes it.

`sparse_vector` / `weighted_tokens`: score = the sum over the tokens a doc
shares with the query of stored weight * f32(f32(query weight) *
f32(boost)), added in f32 in the query map's order, over the segments'
feature-major columns (`index/segment.py::FeatureMapColumn`), so its rows
and f32 bits are the learned-sparse board's (`ops/sparse.py`). It serves
a plain `query` and a hybrid leg on a field that holds no feature maps.

`rank_feature`: a `rank_feature` field's value, or one feature of a
`rank_features` field (`<field>.<feature>`), through `saturation` (pivot
defaulting to the mean value), `log`, `sigmoid` or `linear`, in f64, then
times the boost, to f32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.index.mapping import RankVectorsFieldMapper
from elasticsearch_tpu_torch.index.segment import FeatureMapColumn
from elasticsearch_tpu_torch.search.queries import (
    DocSet, Query, SearchContext,
)

_KEYS = {"field", "query_tokens", "k", "boost"}


class LateInteractionQuery:
    def __init__(self, field: str, query_tokens, boost: float = 1.0):
        self.field = field
        q = np.asarray(query_tokens, dtype=np.float32)
        if q.ndim == 1:
            q = q.reshape(1, -1)
        if q.ndim != 2 or not q.size:
            raise ParsingError(
                "[late_interaction] query_tokens must be a non-empty "
                "array of vectors")
        self.query_tokens = q
        self.boost = float(boost)

    @classmethod
    def parse(cls, spec) -> "LateInteractionQuery":
        if not isinstance(spec, dict) or "field" not in spec \
                or "query_tokens" not in spec:
            raise ParsingError("[late_interaction] requires [field] and "
                               "[query_tokens]")
        for key in spec:
            if key not in _KEYS:
                raise ParsingError(f"[late_interaction] unknown field [{key}]")
        return cls(spec["field"], spec["query_tokens"],
                   boost=spec.get("boost", 1.0))

    def execute(self, reader, mapper_service) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """(rows [m] ascending, f32 scores [m]) of every live doc holding
        the field."""
        mapper = mapper_service.get(self.field)
        if not isinstance(mapper, RankVectorsFieldMapper):
            raise IllegalArgumentError(
                f"[late_interaction] field [{self.field}] is not a "
                f"rank_vectors field")
        cosine = mapper.similarity == "cosine"
        q = self.query_tokens
        if q.shape[1] != mapper.dims:
            raise IllegalArgumentError(
                f"[late_interaction] query tokens have {q.shape[1]} dims, "
                f"field [{self.field}] expects {mapper.dims}")
        if cosine:
            q = q / np.maximum(
                np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
        rows, scores = [], []
        for view in reader.views:
            seg = view.segment
            entry = seg.tokens.get(self.field)
            if entry is None:
                continue
            toks, offsets, present = entry
            for loc in np.nonzero(view.live & present)[0]:
                t = toks[offsets[loc]:offsets[loc + 1]]
                if cosine:
                    t = t / np.maximum(
                        np.linalg.norm(t, axis=-1, keepdims=True), 1e-30)
                dots = q @ t.T                           # [Tq, Td] f32
                rows.append(seg.base + int(loc))
                scores.append(float(dots.max(axis=1).sum()) * self.boost)
        return (np.asarray(rows, dtype=np.int64),
                np.asarray(scores, dtype=np.float32))

    def to_dict(self):
        return {"late_interaction": {
            "field": self.field,
            "query_tokens": self.query_tokens.tolist()}}



class RankFeatureQuery(Query):
    def __init__(self, field: str, saturation=None, log=None, sigmoid=None,
                 linear=None, boost: float = 1.0):
        self.field = field
        self.saturation = saturation
        self.log = log
        self.sigmoid = sigmoid
        self.linear = linear
        self.boost = boost

    def _feature_values(self, ctx: SearchContext
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows ascending, f64 values) of the live docs holding the
        feature: a number (a list gives its first), or the feature's
        weight in a doc's `rank_features` map."""
        root, _, feature = self.field.partition(".")
        mapper = ctx.mapper_service.get(root)
        use_map = bool(feature) and mapper is not None \
            and mapper.type_name == "rank_features"
        lookup = root if use_map else self.field
        rows: List[np.ndarray] = []
        vals: List[np.ndarray] = []
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(lookup)
            if col is None:
                continue
            value = np.zeros(seg.num_docs, dtype=np.float64)
            has = np.zeros(seg.num_docs, dtype=bool)
            walk = np.nonzero(col.present)[0]
            if use_map and isinstance(col, FeatureMapColumn):
                code = np.nonzero(col.names == feature)[0]
                if len(code):
                    hit = np.nonzero(col.codes == code[0])[0]
                    docs = np.searchsorted(col.offsets, hit,
                                           side="right") - 1
                    value[docs] = col.weights[hit]
                    has[docs] = True
                walk = np.asarray(sorted(col.other), dtype=np.int64)
            elif col.numeric is not None:
                value, has = col.numeric, col.present
                walk = walk[:0]
            # any other value, as the reference reads it
            for loc in walk[view.live[walk]]:
                v = col.values[loc]
                if use_map and isinstance(v, dict):
                    v = v.get(feature)
                if isinstance(v, list):
                    v = v[0] if v else None
                if v is None:
                    continue
                value[loc] = float(v)
                has[loc] = True
            keep = np.nonzero(has & view.live)[0]
            rows.append(keep + seg.base)
            vals.append(value[keep])
        if not rows:
            return np.zeros(0, dtype=np.int64), np.zeros(0)
        return np.concatenate(rows).astype(np.int64), np.concatenate(vals)

    def execute(self, ctx: SearchContext) -> DocSet:
        rows, v = self._feature_values(ctx)
        if self.log is not None:
            score = np.log(float(self.log.get("scaling_factor", 1.0)) + v)
        elif self.sigmoid is not None:
            k = float(self.sigmoid["pivot"])
            a = float(self.sigmoid["exponent"])
            score = v ** a / (k ** a + v ** a)
        elif self.linear is not None:
            score = v
        else:
            pivot = float((self.saturation or {}).get(
                "pivot", max(float(np.mean(v)) if len(v) else 1.0, 1e-9)))
            score = v / (v + pivot)
        return DocSet(rows, (self.boost * score).astype(np.float32))

    def to_dict(self):
        return {"rank_feature": {"field": self.field}}


class WeightedTokensQuery(Query):
    """`sparse_vector` / `weighted_tokens`: score = the sum over the
    tokens a doc shares with the query of stored weight * query weight *
    boost, the learned-sparse dot product over the field's feature maps.
    Each token adds, in the query map's order, its f32 weights times
    f32(f32(weight) * f32(boost)) into f32 sums: the board's order and
    bits (`ops/sparse.py`)."""

    def __init__(self, field: str, tokens: Dict, boost: float = 1.0):
        self.field = field
        self.tokens = {str(k): float(v) for k, v in tokens.items()}
        self.boost = float(boost)

    def execute(self, ctx: SearchContext) -> DocSet:
        rows: List[np.ndarray] = []
        scores: List[np.ndarray] = []
        boost = np.float32(self.boost)
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(self.field)
            if not isinstance(col, FeatureMapColumn):
                continue
            names, starts, docs, weights = col.by_feature()
            acc = np.zeros(seg.num_docs, dtype=np.float32)
            counts = np.zeros(seg.num_docs, dtype=np.int32)
            for t, w in self.tokens.items():       # the query map's order
                j = int(np.searchsorted(names, t))
                if j == len(names) or names[j] != t:
                    continue
                d = docs[starts[j]:starts[j + 1]]
                wt = weights[starts[j]:starts[j + 1]]
                if not view.all_live:
                    live = view.live[d]
                    d, wt = d[live], wt[live]
                acc[d] += wt * np.float32(np.float32(w) * boost)
                counts[d] += 1
            keep = np.nonzero(counts)[0]
            rows.append(keep.astype(np.int64) + seg.base)
            scores.append(acc[keep])
        if not rows:
            return DocSet.empty()
        return DocSet(np.concatenate(rows), np.concatenate(scores))

    def to_dict(self):
        return {"sparse_vector": {"field": self.field,
                                  "query_vector": dict(self.tokens)}}
