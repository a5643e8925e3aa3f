"""Filter queries over a ShardReader (port of the filter subset of
`elasticsearch_tpu/search/queries.py`).

Every query evaluates vectorized on the host:

    execute(ctx) -> DocSet(rows: int64[] ascending, scores: float32[] | None)

Boolean composition is set algebra on sorted row arrays with score
summing, with the reference's query/filter-context semantics (filter and
must_not clauses never score). Term-level queries on keyword, numeric and
boolean fields score their constant boost; they read the segments' term
postings, and numeric ranges read the float64 doc-values column.

Ported kinds: `match_all`, `match_none`, `term`, `terms`, `range`,
`exists`, `ids`, `constant_score`, `bool`, and the port's
`late_interaction` walker. Any other kind is a 400. The node query cache
of filter-context rows is not ported: a filter clause runs every time,
which gives the same rows.
"""

from __future__ import annotations

import difflib
from typing import Any, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError, QueryShardError,
)
from elasticsearch_tpu_torch.index.mapping import (
    BooleanFieldMapper, MapperService, _NumericMapper,
)
from elasticsearch_tpu_torch.index.segment import ShardReader

DEFAULT_MAX_TERMS_COUNT = 65536


class DocSet:
    """Sorted matching rows + aligned scores (None in filter context)."""

    __slots__ = ("rows", "scores")

    def __init__(self, rows: np.ndarray, scores: Optional[np.ndarray] = None):
        self.rows = rows
        self.scores = scores

    @staticmethod
    def empty() -> "DocSet":
        return DocSet(np.zeros(0, dtype=np.int64),
                      np.zeros(0, dtype=np.float32))

    def with_scores(self) -> "DocSet":
        if self.scores is None:
            return DocSet(self.rows, np.zeros(len(self.rows),
                                              dtype=np.float32))
        return self


def _constant(rows: np.ndarray, boost: float) -> DocSet:
    return DocSet(rows, np.full(len(rows), boost, dtype=np.float32))


class SearchContext:
    """Per-shard execution context: the point-in-time reader, the mapping,
    the device vector store (kNN) and the flat index settings."""

    def __init__(self, reader: ShardReader, mapper_service: MapperService,
                 vector_store=None, index_settings: Optional[dict] = None):
        self.reader = reader
        self.mapper_service = mapper_service
        self.vector_store = vector_store
        self.index_settings = index_settings or {}
        self._all_rows: Optional[np.ndarray] = None

    def all_rows(self) -> np.ndarray:
        if self._all_rows is None:
            self._all_rows = self.reader.live_global_rows()
        return self._all_rows


class Query:
    def execute(self, ctx: SearchContext) -> DocSet:
        raise NotImplementedError


# --------------------------------------------------------- sorted-set algebra
# numpy forms of the reference's native streaming merges

def intersect_sorted(a: np.ndarray, b: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Positions (ia, ib) where two sorted unique int64 arrays meet: the
    `np.intersect1d(..., return_indices=True)` result, by a binary search
    of the shorter array's values in the longer one (no sort)."""
    if len(a) > len(b):
        ib, ia = intersect_sorted(b, a)
        return ia, ib
    if not len(a) or not len(b):
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    at = np.minimum(np.searchsorted(b, a), len(b) - 1)
    hit = b[at] == a
    return np.nonzero(hit)[0], at[hit]


def in_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`np.isin(a, b)` for sorted unique int64 arrays."""
    out = np.zeros(len(a), dtype=bool)
    out[intersect_sorted(a, b)[0]] = True
    return out


def union_sum(a: np.ndarray, sa: Optional[np.ndarray], b: np.ndarray,
              sb: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Union of sorted unique int64 row arrays, summing aligned scores on
    rows present in both (bool-should accumulation)."""
    rows = np.union1d(a, b)
    scores = np.zeros(len(rows), dtype=np.float32)
    if sa is not None and len(a):
        scores[np.searchsorted(rows, a)] += sa
    if sb is not None and len(b):
        scores[np.searchsorted(rows, b)] += sb
    return rows, scores


# -------------------------------------------------------------- leaf queries

class MatchAllQuery(Query):
    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        return _constant(ctx.all_rows(), self.boost)


class MatchNoneQuery(Query):
    def execute(self, ctx: SearchContext) -> DocSet:
        return DocSet.empty()


def _id_rows(ctx: SearchContext, ids) -> np.ndarray:
    """Live rows of the given `_id`s, ascending. The id → row map is
    built once per reader."""
    reader = ctx.reader
    cache = getattr(reader, "_id_row_cache", None)
    if cache is None:
        cache = {}
        for v in reader.views:
            seg = v.segment
            for local in np.nonzero(v.live)[0]:
                cache[seg.ids[local]] = seg.base + int(local)
        reader._id_row_cache = cache
    rows = sorted(r for r in (cache.get(str(i)) for i in ids)
                  if r is not None)
    return np.asarray(rows, dtype=np.int64)


def _term_rows(ctx: SearchContext, field: str, term: str) -> np.ndarray:
    """Live rows holding `term` in `field`, ascending."""
    parts = []
    for view in ctx.reader.views:
        fp = view.segment.postings.get(field)
        p = fp.get(term) if fp is not None else None
        if p is None:
            continue
        ids = p.doc_ids if view.all_live \
            else p.doc_ids[view.live[p.doc_ids]]
        parts.append(np.add(ids, view.segment.base, dtype=np.int64))
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(parts)


def _index_term_for(mapper, value: Any) -> Optional[str]:
    """A query value as the field's indexed term (None: matches nothing)."""
    if mapper is None:
        return str(value)
    try:
        terms = mapper.index_terms(value)
    except Exception:
        return None
    return terms[0] if terms else None


class TermQuery(Query):
    def __init__(self, field: str, value: Any, boost: float = 1.0):
        self.field = field
        self.value = value
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        if self.field == "_id":
            return _constant(_id_rows(ctx, [self.value]), self.boost)
        term = _index_term_for(ctx.mapper_service.get(self.field),
                               self.value)
        if term is None:
            return DocSet.empty()
        # non-text fields score the constant boost, not BM25
        return _constant(_term_rows(ctx, self.field, term), self.boost)


class TermsQuery(Query):
    def __init__(self, field: str, values: List[Any], boost: float = 1.0):
        self.field = field
        self.values = values
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        max_terms = int(ctx.index_settings.get("index.max_terms_count",
                                               DEFAULT_MAX_TERMS_COUNT))
        if len(self.values) > max_terms:
            raise IllegalArgumentError(
                f"The number of terms [{len(self.values)}] used in the "
                f"Terms Query request has exceeded the allowed maximum "
                f"of [{max_terms}]. This maximum can be set by changing "
                f"the [index.max_terms_count] index level setting.")
        if self.field == "_id":
            return _constant(_id_rows(ctx, self.values), self.boost)
        mapper = ctx.mapper_service.get(self.field)
        parts = []
        for v in self.values:
            term = _index_term_for(mapper, v)
            if term is not None:
                parts.append(_term_rows(ctx, self.field, term))
        if not parts:
            return DocSet.empty()
        return _constant(np.unique(np.concatenate(parts)), self.boost)


def _str_in_range(v, gte, gt, lte, lt) -> bool:
    s = str(v)
    if gte is not None and s < str(gte):
        return False
    if gt is not None and s <= str(gt):
        return False
    if lte is not None and s > str(lte):
        return False
    if lt is not None and s >= str(lt):
        return False
    return True


class RangeQuery(Query):
    """Numeric bounds over the float64 doc-values column (a multi-valued
    doc compares its first value, as in the reference); string bounds
    over the string doc values of a keyword field."""

    def __init__(self, field: str, gte=None, gt=None, lte=None, lt=None,
                 boost: float = 1.0):
        self.field = field
        self.gte, self.gt, self.lte, self.lt = gte, gt, lte, lt
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        lo, hi = -np.inf, np.inf
        lo_inc = hi_inc = True
        numeric_bounds = True
        try:
            if self.gte is not None:
                lo = float(self.gte)
            if self.gt is not None:
                lo, lo_inc = float(self.gt), False
            if self.lte is not None:
                hi = float(self.lte)
            if self.lt is not None:
                hi, hi_inc = float(self.lt), False
        except (ValueError, TypeError) as e:
            # on a numeric or boolean field an unparseable bound is the
            # caller's error; keyword and unmapped fields compare strings
            if isinstance(ctx.mapper_service.get(self.field),
                          (_NumericMapper, BooleanFieldMapper)):
                raise IllegalArgumentError(
                    f"failed to parse range bound on field "
                    f"[{self.field}]: {e}")
            numeric_bounds = False

        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(self.field)
            if col is None:
                continue
            if col.numeric is None or not numeric_bounds:
                locs = [i for i in np.nonzero(col.present & view.live)[0]
                        if _str_in_range(col.values[i], self.gte, self.gt,
                                         self.lte, self.lt)]
                if locs:
                    parts.append(np.asarray(locs, dtype=np.int64) + seg.base)
                continue
            vals = col.numeric
            mask = col.present if view.all_live else col.present & view.live
            # an infinite bound holds for every (finite) value
            if lo != -np.inf:
                mask = mask & ((vals >= lo) if lo_inc else (vals > lo))
            if hi != np.inf:
                mask = mask & ((vals <= hi) if hi_inc else (vals < hi))
            parts.append(np.nonzero(mask)[0] + seg.base)
        if not parts:
            return DocSet.empty()
        return _constant(np.sort(np.concatenate(parts)), self.boost)


class ExistsQuery(Query):
    _META_ALWAYS = {"_id", "_index", "_type", "_seq_no", "_primary_term",
                    "_version"}

    def __init__(self, field: str, boost: float = 1.0):
        self.field = field
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        field = self.field
        if field == "_source":
            raise QueryShardError("Cannot run exists query on [_source]")
        if field in self._META_ALWAYS:
            return _constant(ctx.all_rows(), self.boost)
        prefix = field + "."
        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            mask = None
            # the field's columns, and its sub-fields' (an object field
            # exists wherever one of its properties does)
            for store, extract in ((seg.doc_values, lambda c: c.present),
                                   (seg.vectors, lambda v: v[1]),
                                   (seg.tokens, lambda t: t[2])):
                for name, col in store.items():
                    if name == field or name.startswith(prefix):
                        m = extract(col)
                        mask = m.copy() if mask is None else (mask | m)
            if mask is None:
                continue
            locs = np.nonzero(mask & view.live)[0]
            if len(locs):
                parts.append(locs.astype(np.int64) + seg.base)
        if not parts and ctx.mapper_service.get(field) is not None:
            # a mapped field without a live column value: the stored
            # sources say which docs hold it
            parts = [self._source_walk(ctx, field.split("."))]
        rows = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return _constant(np.sort(rows), self.boost)

    @staticmethod
    def _source_walk(ctx: SearchContext, path: List[str]) -> np.ndarray:
        hits = []
        for row in ctx.all_rows():
            node = ctx.reader.get_source(int(row)) or {}
            for p in path:
                node = node.get(p) if isinstance(node, dict) else None
                if node is None:
                    break
            if node is not None:
                hits.append(int(row))
        return np.asarray(hits, dtype=np.int64)


class IdsQuery(Query):
    def __init__(self, values: List[str], boost: float = 1.0):
        self.values = values
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        return _constant(_id_rows(ctx, set(map(str, self.values))),
                         self.boost)


class ConstantScoreQuery(Query):
    def __init__(self, filter_query: Query, boost: float = 1.0):
        self.filter_query = filter_query
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        return _constant(self.filter_query.execute(ctx).rows, self.boost)


class LateInteractionFilterQuery(Query):
    """The `late_interaction` walker (`search/queries_ext.py`) as a
    clause of this module's queries."""

    def __init__(self, spec):
        from elasticsearch_tpu_torch.search.queries_ext import (
            LateInteractionQuery)
        self.inner = LateInteractionQuery.parse(spec)

    def execute(self, ctx: SearchContext) -> DocSet:
        rows, scores = self.inner.execute(ctx.reader, ctx.mapper_service)
        return DocSet(rows, scores)


# --------------------------------------------------------- bool composition

def resolve_msm(msm, n_clauses: int) -> int:
    """minimum_should_match: an int, a numeric string, or 'N%' of the
    clauses; negative values mean 'all but N'."""
    if msm is None:
        return 1
    if isinstance(msm, int):
        value = msm
    else:
        s = str(msm).strip()
        try:
            if s.endswith("%"):
                pct = int(s[:-1])
                value = (n_clauses * pct) // 100 if pct >= 0 else \
                    n_clauses + (n_clauses * pct) // 100
            else:
                value = int(s)
        except ValueError:
            raise ParsingError(f"invalid minimum_should_match [{msm}]")
    if value < 0:
        value = n_clauses + value
    return max(min(value, n_clauses), 0)


def _combine_should(sets: List[DocSet], minimum_match: int) -> DocSet:
    """Union with score summing; keep docs matching >= minimum_match
    clauses."""
    if not sets:
        return DocSet.empty()
    if minimum_match <= 1:
        rows, scores = sets[0].rows, sets[0].scores
        for s in sets[1:]:
            rows, scores = union_sum(rows, scores, s.rows, s.scores)
        return DocSet(rows, scores if scores is not None
                      else np.zeros(len(rows), dtype=np.float32))
    rows = np.unique(np.concatenate([s.rows for s in sets]))
    scores = np.zeros(len(rows), dtype=np.float32)
    counts = np.zeros(len(rows), dtype=np.int32)
    for s in sets:
        if len(s.rows) == 0:
            continue
        idx = np.searchsorted(rows, s.rows)
        np.add.at(scores, idx, s.scores if s.scores is not None else 0.0)
        np.add.at(counts, idx, 1)
    keep = counts >= minimum_match
    return DocSet(rows[keep], scores[keep])


class BoolQuery(Query):
    """must / filter / should / must_not with the reference's semantics:
    filter and must_not never score; should adds to the score;
    minimum_should_match defaults to 1 when there are no must or filter
    clauses, else 0."""

    def __init__(self, must: List[Query] = (), filter: List[Query] = (),
                 should: List[Query] = (), must_not: List[Query] = (),
                 minimum_should_match=None, boost: float = 1.0):
        self.must = list(must)
        self.filter = list(filter)
        self.should = list(should)
        self.must_not = list(must_not)
        self.minimum_should_match = minimum_should_match
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        rows: Optional[np.ndarray] = None
        scores: Optional[np.ndarray] = None

        for q in self.must:
            s = q.execute(ctx).with_scores()
            if rows is None:
                rows, scores = s.rows, s.scores.copy()
            else:
                i1, i2 = intersect_sorted(rows, s.rows)
                rows = rows[i1]
                scores = scores[i1] + s.scores[i2]

        for q in self.filter:
            f_rows = q.execute(ctx).rows
            if rows is None:
                rows = f_rows
                scores = np.zeros(len(rows), dtype=np.float32)
            else:
                i1, _ = intersect_sorted(rows, f_rows)
                rows = rows[i1]
                scores = scores[i1]

        msm = self.minimum_should_match
        if msm is not None:
            msm = resolve_msm(msm, len(self.should))
        if self.should:
            should_set = _combine_should(
                [q.execute(ctx).with_scores() for q in self.should],
                msm if msm is not None else 1)
            if rows is None:
                rows, scores = should_set.rows, should_set.scores
            elif msm is None or msm == 0:
                # optional should: add scores where they match
                idx = np.searchsorted(should_set.rows, rows)
                idx = np.clip(idx, 0, max(len(should_set.rows) - 1, 0))
                if len(should_set.rows):
                    hit = should_set.rows[idx] == rows
                    scores[hit] += should_set.scores[idx][hit]
            else:
                i1, i2 = intersect_sorted(rows, should_set.rows)
                rows = rows[i1]
                scores = scores[i1] + should_set.scores[i2]

        if rows is None:
            rows = ctx.all_rows()
            scores = np.zeros(len(rows), dtype=np.float32)

        for q in self.must_not:
            s = q.execute(ctx)
            keep = ~in_sorted(rows, s.rows)
            rows, scores = rows[keep], scores[keep]

        return DocSet(rows, scores * self.boost)


# ------------------------------------------------------------------ parser

PORTED_KINDS = ("match_all", "match_none", "term", "terms", "range",
                "exists", "ids", "constant_score", "bool",
                "late_interaction")

# every kind the reference's parser knows (its did-you-mean list)
_KNOWN_KINDS = (
    "match", "match_all", "match_none", "match_phrase", "match_phrase_prefix",
    "multi_match", "term", "terms", "range", "bool", "exists", "prefix",
    "wildcard", "regexp", "fuzzy", "ids", "query_string",
    "simple_query_string", "nested", "knn", "constant_score",
    "function_score", "script_score", "dis_max", "boosting",
    "more_like_this", "terms_set", "span_term", "span_near", "intervals",
    "percolate", "rank_feature", "shape", "geo_shape", "geo_distance",
    "geo_bounding_box", "late_interaction")


def _single(spec: Any, kind: str) -> Tuple[str, Any]:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingError(
            f"[{kind}] query malformed, expected a single field")
    return next(iter(spec.items()))


def parse_query(body: Optional[dict]) -> Query:
    """The JSON query DSL → a Query, for the ported kinds."""
    if body is None:
        return MatchAllQuery()
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingError(
            f"query must be an object with exactly one key, got {body!r}")
    kind, spec = next(iter(body.items()))

    if kind == "match_all":
        return MatchAllQuery(boost=float(spec.get("boost", 1.0))
                             if isinstance(spec, dict) else 1.0)
    if kind == "match_none":
        return MatchNoneQuery()
    if kind == "term":
        field, v = _single(spec, "term")
        if isinstance(v, dict):
            return TermQuery(field, v.get("value"),
                             float(v.get("boost", 1.0)))
        return TermQuery(field, v)
    if kind == "terms":
        spec = dict(spec)
        boost = float(spec.pop("boost", 1.0))
        field, values = _single(spec, "terms")
        if not isinstance(values, list):
            raise ParsingError("[terms] query requires an array of values")
        return TermsQuery(field, values, boost)
    if kind == "range":
        field, v = _single(spec, "range")
        return RangeQuery(field, gte=v.get("gte", v.get("from")),
                          gt=v.get("gt"), lte=v.get("lte", v.get("to")),
                          lt=v.get("lt"), boost=float(v.get("boost", 1.0)))
    if kind == "exists":
        return ExistsQuery(spec["field"])
    if kind == "ids":
        return IdsQuery(spec.get("values", []))
    if kind == "bool":
        def clause(name):
            c = spec.get(name, [])
            if isinstance(c, dict):
                c = [c]
            return [parse_query(q) for q in c]

        return BoolQuery(must=clause("must"), filter=clause("filter"),
                         should=clause("should"),
                         must_not=clause("must_not"),
                         minimum_should_match=spec.get(
                             "minimum_should_match"),
                         boost=float(spec.get("boost", 1.0)))
    if kind == "constant_score":
        return ConstantScoreQuery(parse_query(spec["filter"]),
                                  float(spec.get("boost", 1.0)))
    if kind == "late_interaction":
        return LateInteractionFilterQuery(spec)
    if kind in _KNOWN_KINDS:
        raise ParsingError(
            f"[{kind}] query is not supported by this build: only "
            f"[{', '.join(PORTED_KINDS)}] queries are ported")
    hint = difflib.get_close_matches(str(kind), _KNOWN_KINDS, n=1)
    suffix = f" did you mean [{hint[0]}]?" if hint else ""
    raise ParsingError(f"unknown query [{kind}]{suffix}")
