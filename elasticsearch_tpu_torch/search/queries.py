"""Queries over a ShardReader (port of the filter and text subset of
`elasticsearch_tpu/search/queries.py`).

Every query evaluates vectorized on the host:

    execute(ctx) -> DocSet(rows: int64[] ascending, scores: float32[] | None)

Boolean composition is set algebra on sorted row arrays with score
summing (`native.intersect_sorted` / `native.union_sum`), with the
reference's query/filter-context semantics (filter and must_not clauses
never score). Term-level queries on keyword, numeric, boolean, date and
ip fields score their constant boost; they read the segments' term
postings, and numeric, date and ip ranges read the float64 doc-values
column (bounds in the field's unit: date math and rounding for dates,
the 128-bit space for addresses). On a range type `term` is membership
and `range` an interval relation (`intersects`, `within`, `contains`),
each a scan of the stored intervals; `exists` on an object matches
where any of its fields exists. Text queries score
BM25 (k1 = 1.2, b = 0.75) as the reference does:

    idf   = ln(1 + (N - df + 0.5) / (df + 0.5))
    tf    = f / (f + k1 * (1 - b + b * len / avg_len))
    score = boost * idf * (k1 + 1) * tf

through `native.bm25_score`, over the reader's corpus statistics (a
multi-shard index's combined reader gives corpus-wide ones).

Ported kinds: `match_all`, `match_none`, `term` and `terms` (BM25 on a
text field), `match` (`operator`, `minimum_should_match`, `boost`),
`match_phrase` (`slop`), `multi_match` (`best_fields`, `most_fields`,
`cross_fields`, `phrase`, `phrase_prefix`, scored as the reference scores
them: the best or the sum of per-field `match` scores), `range`,
`exists`, `ids`, `constant_score`, `bool`, and the host walkers of
`search/queries_ext.py`: `late_interaction`, `sparse_vector` /
`weighted_tokens` (the learned-sparse dot product) and `rank_feature`.
`fuzziness`, the `bool_prefix` type and any
other kind are a 400.

A `bool`'s `filter` clauses run through the node query cache
(`search/caches.py::QueryCache`), keyed on the reader's `gen` and the
clause's canonical form, `json.dumps(q.to_dict(), sort_keys=True,
default=str)`: every query class gives the reference's `to_dict`, so
equivalent sources share one entry, as they do there. The reference's
form leaves out `match`'s `minimum_should_match` and `multi_match`'s
`operator`; a clause that sets them (`key_is_exact` false) is evaluated
every time rather than served another clause's rows.
"""

from __future__ import annotations

import difflib
import fnmatch
import itertools
import json
import math
from typing import Any, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError, QueryShardError,
)
from elasticsearch_tpu_torch.index.mapping import (
    BooleanFieldMapper, DateFieldMapper, DateNanosFieldMapper, IpFieldMapper,
    MapperService, RangeFieldMapperBase, TextFieldMapper, _NumericMapper,
    parse_date_millis, parse_date_nanos,
)
from elasticsearch_tpu_torch.index.segment import ShardReader

DEFAULT_MAX_TERMS_COUNT = 65536
BM25_K1 = 1.2
BM25_B = 0.75


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
    the device vector store (kNN), the flat index settings and the node
    query cache (None caches nothing). `deadline_at` is an absolute
    deadline (time.monotonic seconds) the kNN legs pass into the batcher,
    and `knn_phases` the kNN engine's phases of this search (for the
    profile)."""

    def __init__(self, reader: ShardReader, mapper_service: MapperService,
                 vector_store=None, index_settings: Optional[dict] = None,
                 query_cache=None):
        self.reader = reader
        self.mapper_service = mapper_service
        self.vector_store = vector_store
        self.index_settings = index_settings or {}
        self.query_cache = query_cache
        self.deadline_at: Optional[float] = None
        self.knn_phases: Optional[dict] = None
        self._all_rows: Optional[np.ndarray] = None

    def all_rows(self) -> np.ndarray:
        if self._all_rows is None:
            self._all_rows = self.reader.live_global_rows()
        return self._all_rows


class Query:
    def execute(self, ctx: SearchContext) -> DocSet:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def key_is_exact(self) -> bool:
        """Whether `to_dict` holds every option that changes the rows. The
        reference's form leaves some out, and the query cache keys on it,
        so a clause whose form is lossy is evaluated, never cached."""
        return True


def in_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`np.isin(a, b)` for sorted unique int64 arrays."""
    out = np.zeros(len(a), dtype=bool)
    out[native.intersect_sorted(a, b)[0]] = True
    return out


# -------------------------------------------------------------- leaf queries

class MatchAllQuery(Query):
    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        return _constant(ctx.all_rows(), self.boost)

    def to_dict(self):
        return {"match_all": {}}


class MatchNoneQuery(Query):
    def execute(self, ctx: SearchContext) -> DocSet:
        return DocSet.empty()

    def to_dict(self):
        return {"match_none": {}}


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


def _term_postings(ctx: SearchContext, field: str, term: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(live rows, freqs) of `term` in `field`, ascending."""
    rows_parts, freq_parts = [], []
    for view in ctx.reader.views:
        p = view.segment.get_postings(field, term)
        if p is None:
            continue
        if view.all_live:
            ids, freqs = p.doc_ids, p.freqs
        else:
            live = view.live[p.doc_ids]
            ids, freqs = p.doc_ids[live], p.freqs[live]
        rows_parts.append(np.add(ids, view.segment.base, dtype=np.int64))
        freq_parts.append(freqs)
    if not rows_parts:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
    return np.concatenate(rows_parts), np.concatenate(freq_parts)


def _sorted_postings(ctx: SearchContext, field: str, term: str):
    rows, freqs = _term_postings(ctx, field, term)
    order = np.argsort(rows, kind="stable")
    return rows[order], freqs[order]


def _field_lengths_for(ctx: SearchContext, field: str,
                       rows: np.ndarray) -> np.ndarray:
    out = np.zeros(len(rows), dtype=np.float32)
    for view in ctx.reader.views:
        seg = view.segment
        fl = seg.field_lengths.get(field)
        if fl is None:
            continue
        in_seg = (rows >= seg.base) & (rows < seg.base + seg.num_docs)
        out[in_seg] = fl[rows[in_seg] - seg.base]
    return out


def bm25_scores(ctx: SearchContext, field: str, rows: np.ndarray,
                freqs: np.ndarray, boost: float = 1.0) -> np.ndarray:
    """BM25 of one term's postings (`rows` its live rows, ascending)."""
    n = max(ctx.reader.docs_with_field_count(field), 1)
    df = len(rows)
    idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
    avg_len = ctx.reader.avg_field_length(field) or 1.0
    lengths = _field_lengths_for(ctx, field, rows)
    return native.bm25_score(freqs, lengths, idf, avg_len,
                             BM25_K1, BM25_B, boost)


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
        mapper = ctx.mapper_service.get(self.field)
        if isinstance(mapper, RangeFieldMapperBase):
            # membership: the value lies inside the stored interval
            v = mapper.query_bound(self.value)
            return _scan_range_docs(ctx, self.field,
                                    lambda lo, hi: lo <= v <= hi, self.boost)
        if isinstance(mapper, TextFieldMapper):
            # a term on a text field matches its token as given, BM25
            rows, freqs = _sorted_postings(ctx, self.field, str(self.value))
            return DocSet(rows, bm25_scores(ctx, self.field, rows, freqs,
                                            self.boost))
        term = _index_term_for(mapper, self.value)
        if term is None:
            return DocSet.empty()
        # non-text fields score the constant boost, not BM25
        return _constant(_term_postings(ctx, self.field, term)[0],
                         self.boost)

    def to_dict(self):
        return {"term": {self.field: {"value": self.value,
                                      "boost": self.boost}}}


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
            term = str(v) if isinstance(mapper, TextFieldMapper) \
                else _index_term_for(mapper, v)
            if term is not None:
                parts.append(_term_postings(ctx, self.field, term)[0])
        if not parts:
            return DocSet.empty()
        return _constant(np.unique(np.concatenate(parts)), self.boost)

    def to_dict(self):
        return {"terms": {self.field: self.values}}


class MatchQuery(Query):
    """`match`: the text analyzed by the field's search analyzer, one
    BM25 clause a term (a repeated term counts twice), combined as
    `bool.should` with `operator: and` requiring every clause, else
    `minimum_should_match` (default 1). On a non-text field the value is
    its one index term."""

    def __init__(self, field: str, text: Any, operator: str = "or",
                 minimum_should_match=None, boost: float = 1.0):
        self.field = field
        self.text = text
        self.operator = str(operator).lower()
        self.minimum_should_match = minimum_should_match
        self.boost = boost

    def _analyzed_terms(self, ctx: SearchContext) -> List[str]:
        mapper = ctx.mapper_service.get(self.field)
        if isinstance(mapper, TextFieldMapper):
            return mapper.search_analyzer.terms(str(self.text))
        term = str(self.text) if mapper is None \
            else _index_term_for(mapper, self.text)
        return [term] if term is not None else []

    def execute(self, ctx: SearchContext) -> DocSet:
        terms = self._analyzed_terms(ctx)
        if not terms:
            return DocSet.empty()
        clause_sets = []
        for t in terms:
            rows, freqs = _sorted_postings(ctx, self.field, t)
            clause_sets.append(DocSet(rows, bm25_scores(
                ctx, self.field, rows, freqs, self.boost)))
        if self.operator == "and":
            required = len(clause_sets)
        else:
            required = resolve_msm(self.minimum_should_match,
                                   len(clause_sets))
        return _combine_should(clause_sets, required)

    def to_dict(self):
        return {"match": {self.field: {"query": self.text,
                                       "operator": self.operator}}}

    def key_is_exact(self) -> bool:
        # the form leaves out minimum_should_match, which `and` overrides
        return self.minimum_should_match is None or self.operator == "and"


class MatchPhraseQuery(Query):
    """`match_phrase`: docs holding every analyzed term with each next
    term 1 to 1 + slop positions after the one before, scored as the sum
    of the terms' BM25 (the reference's approximation of Lucene's phrase
    score). On a non-text field it is a `term` query."""

    def __init__(self, field: str, text: str, slop: int = 0,
                 boost: float = 1.0):
        self.field = field
        self.text = text
        self.slop = slop
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        mapper = ctx.mapper_service.get(self.field)
        if not isinstance(mapper, TextFieldMapper):
            return TermQuery(self.field, self.text, self.boost).execute(ctx)
        terms = mapper.search_analyzer.terms(str(self.text))
        if not terms:
            return DocSet.empty()
        rows_out = []
        for view in ctx.reader.views:
            seg = view.segment
            plists = [seg.get_postings(self.field, t) for t in terms]
            if any(p is None for p in plists):
                continue
            # candidates: docs holding every term
            cand = plists[0].doc_ids
            for p in plists[1:]:
                cand = np.intersect1d(cand, p.doc_ids, assume_unique=True)
            for local in cand:
                if not view.live[local]:
                    continue
                pos_sets = []
                for p in plists:
                    pl = p.doc_positions(int(np.searchsorted(p.doc_ids,
                                                             local)))
                    if pl is None:
                        break
                    pos_sets.append(set(pl))
                else:
                    if _phrase_match(pos_sets, self.slop):
                        rows_out.append(seg.base + int(local))
        if not rows_out:
            return DocSet.empty()
        rows = np.asarray(sorted(rows_out), dtype=np.int64)
        total = np.zeros(len(rows), dtype=np.float32)
        for t in terms:
            trows, tfreqs = _sorted_postings(ctx, self.field, t)
            ts = bm25_scores(ctx, self.field, trows, tfreqs, self.boost)
            idx = np.clip(np.searchsorted(trows, rows), 0, len(trows) - 1)
            hit = trows[idx] == rows
            total[hit] += ts[idx][hit]
        return DocSet(rows, total)

    def to_dict(self):
        return {"match_phrase": {self.field: {"query": self.text,
                                              "slop": self.slop}}}


def _phrase_match(pos_sets: List[set], slop: int) -> bool:
    return any(_phrase_from(pos_sets, 1, start, slop)
               for start in pos_sets[0])


def _phrase_from(pos_sets, i, prev, slop) -> bool:
    if i == len(pos_sets):
        return True
    for p in pos_sets[i]:
        if 0 < p - prev <= 1 + slop and _phrase_from(pos_sets, i + 1, p,
                                                     slop):
            return True
    return False


class MultiMatchQuery(Query):
    """`multi_match`: one `match` a field (`field^boost` and wildcard
    field patterns over the text and keyword fields), the best field's
    score for `best_fields`, else their sum, as the reference scores
    every other type."""

    def __init__(self, query: str, fields: List[str],
                 mm_type: str = "best_fields", operator: str = "or",
                 boost: float = 1.0):
        self.query = query
        self.fields = fields
        self.mm_type = mm_type
        self.operator = operator
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        def split_boost(f):
            if "^" in f:
                name, b = f.split("^", 1)
                return name, float(b)
            return f, 1.0

        resolved: List[str] = []
        for f in self.fields:
            name, _b = split_boost(f)
            if "*" in name:
                suffix = f[len(name):]
                for path, m in ctx.mapper_service.all_mappers():
                    if m.type_name in ("text", "keyword") \
                            and fnmatch.fnmatch(path, name):
                        resolved.append(path + suffix)
            else:
                resolved.append(f)
        sets = []
        for f in resolved:
            name, fboost = split_boost(f)
            sets.append(MatchQuery(name, self.query, operator=self.operator,
                                   boost=self.boost * fboost).execute(ctx))
        if not sets:
            return DocSet.empty()
        if self.mm_type == "best_fields":
            return _combine_max(sets)
        return _combine_should(sets, 1)

    def to_dict(self):
        return {"multi_match": {"query": self.query, "fields": self.fields,
                                "type": self.mm_type}}

    def key_is_exact(self) -> bool:
        # the form leaves out the operator
        return str(self.operator).lower() != "and"


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


def _scan_range_docs(ctx: SearchContext, field: str, predicate,
                     boost: float) -> DocSet:
    """The live docs holding a range-type value (a multi-valued doc: any
    of them) whose stored interval [gte, lte] satisfies predicate(lo,
    hi)."""
    parts = []
    for view in ctx.reader.views:
        seg = view.segment
        col = seg.doc_values.get(field)
        if col is None:
            continue
        locs = [i for i in np.nonzero(col.present & view.live)[0]
                if any(isinstance(x, dict)
                       and predicate(x.get("gte", -np.inf),
                                     x.get("lte", np.inf))
                       for x in (col.values[i]
                                 if isinstance(col.values[i], list)
                                 else [col.values[i]]))]
        if locs:
            parts.append(np.asarray(locs, dtype=np.int64) + seg.base)
    if not parts:
        return DocSet.empty()
    return _constant(np.sort(np.concatenate(parts)), boost)


class RangeQuery(Query):
    """Numeric bounds over the float64 doc-values column (a multi-valued
    doc compares its first value, as in the reference), each bound in the
    field's unit: epoch millis for `date` (date math, `now`, a gt / lte
    bound rounded up to the end of its unit), epoch nanos for
    `date_nanos`, the 128-bit integer for `ip`. On a range type the query
    interval meets each stored one under `relation` (`intersects`,
    `within`, `contains`). String bounds compare the string doc values of
    a keyword or unmapped field; an unparseable bound on a typed field is
    the reference's 400."""

    def __init__(self, field: str, gte=None, gt=None, lte=None, lt=None,
                 boost: float = 1.0, relation: str = "intersects"):
        self.field = field
        self.gte, self.gt, self.lte, self.lt = gte, gt, lte, lt
        self.boost = boost
        self.relation = relation

    def _coerce_bound(self, mapper, value, round_up: bool = False) -> float:
        if isinstance(mapper, DateNanosFieldMapper):
            if isinstance(value, str) and ("||" in value
                                           or value.startswith("now")
                                           or round_up):
                return float(parse_date_millis(value, round_up=round_up)
                             * 1_000_000)
            return float(parse_date_nanos(value))
        if isinstance(mapper, DateFieldMapper):
            # a custom pattern with names parses through the mapper
            fmt = str(mapper.params.get("format", ""))
            if isinstance(value, str) and fmt \
                    and ("E" in fmt or "MMM" in fmt):
                try:
                    return float(mapper._parse(value))
                except Exception:
                    pass
            return float(parse_date_millis(value, round_up=round_up))
        if isinstance(mapper, IpFieldMapper):
            return float(mapper.coerce(value))
        if isinstance(mapper, RangeFieldMapperBase):
            return mapper.query_bound(value, round_up=round_up)
        return float(value)

    def execute(self, ctx: SearchContext) -> DocSet:
        mapper = ctx.mapper_service.get(self.field)
        lo, hi = -np.inf, np.inf
        lo_inc = hi_inc = True
        numeric_bounds = True
        try:
            if self.gte is not None:
                lo = self._coerce_bound(mapper, self.gte)
            if self.gt is not None:
                lo, lo_inc = self._coerce_bound(mapper, self.gt,
                                                round_up=True), False
            if self.lte is not None:
                hi = self._coerce_bound(mapper, self.lte, round_up=True)
            if self.lt is not None:
                hi, hi_inc = self._coerce_bound(mapper, self.lt), False
        except (ValueError, TypeError) as e:
            # on a typed field an unparseable bound is the caller's error;
            # keyword and unmapped fields compare strings
            if isinstance(mapper, (_NumericMapper, DateFieldMapper,
                                   IpFieldMapper, RangeFieldMapperBase,
                                   BooleanFieldMapper)):
                raise IllegalArgumentError(
                    f"failed to parse range bound on field "
                    f"[{self.field}]: {e}")
            numeric_bounds = False

        if isinstance(mapper, RangeFieldMapperBase):
            step = mapper.discrete
            qlo = lo if lo_inc else (lo + 1 if step
                                     else float(np.nextafter(lo, np.inf)))
            qhi = hi if hi_inc else (hi - 1 if step
                                     else float(np.nextafter(hi, -np.inf)))
            if self.relation == "within":       # stored inside the query
                pred = lambda slo, shi: slo >= qlo and shi <= qhi
            elif self.relation == "contains":   # stored around the query
                pred = lambda slo, shi: slo <= qlo and shi >= qhi
            else:                               # intersects
                pred = lambda slo, shi: slo <= qhi and shi >= qlo
            return _scan_range_docs(ctx, self.field, pred, self.boost)

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

    def to_dict(self):
        body = {}
        for k in ("gte", "gt", "lte", "lt"):
            v = getattr(self, k)
            if v is not None:
                body[k] = v
        return {"range": {self.field: body}}

    def key_is_exact(self) -> bool:
        # the form leaves out the relation
        return self.relation == "intersects"


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
        if not parts and (ctx.mapper_service.get(field) is not None
                          or ctx.mapper_service.maps_object(field)):
            # a mapped field or object without a live column value: the
            # stored sources say which docs hold it
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

    def to_dict(self):
        return {"exists": {"field": self.field}}


class IdsQuery(Query):
    def __init__(self, values: List[str], boost: float = 1.0):
        self.values = values
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        return _constant(_id_rows(ctx, set(map(str, self.values))),
                         self.boost)

    def to_dict(self):
        return {"ids": {"values": self.values}}


class ConstantScoreQuery(Query):
    def __init__(self, filter_query: Query, boost: float = 1.0):
        self.filter_query = filter_query
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        return _constant(self.filter_query.execute(ctx).rows, self.boost)

    def to_dict(self):
        return {"constant_score": {"filter": self.filter_query.to_dict(),
                                   "boost": self.boost}}

    def key_is_exact(self) -> bool:
        return self.filter_query.key_is_exact()


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

    def to_dict(self):
        return self.inner.to_dict()


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
            rows, scores = native.union_sum(rows, scores, s.rows, s.scores)
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


def _combine_max(sets: List[DocSet]) -> DocSet:
    rows = np.unique(np.concatenate([s.rows for s in sets]))
    scores = np.zeros(len(rows), dtype=np.float32)
    for s in sets:
        if len(s.rows) == 0:
            continue
        idx = np.searchsorted(rows, s.rows)
        np.maximum.at(scores, idx,
                      s.scores if s.scores is not None else 0.0)
    return DocSet(rows, scores)


def _cached_filter_rows(ctx: SearchContext, q: Query) -> np.ndarray:
    """A filter clause's rows through the node query cache: filters never
    score, so the rows are the whole result. Nothing caches without a
    cache, without a reader `gen`, or when the clause has no `to_dict`,
    as in the reference; nor, unlike the reference, when its `to_dict`
    leaves out an option that changes the rows (`key_is_exact`)."""
    cache = ctx.query_cache
    if cache is None or not q.key_is_exact():
        return q.execute(ctx).rows
    try:
        source = json.dumps(q.to_dict(), sort_keys=True, default=str)
    except Exception:
        return q.execute(ctx).rows
    gen = getattr(ctx.reader, "gen", None)
    if gen is None:
        return q.execute(ctx).rows
    rows = cache.get_rows(gen, source)
    if rows is None:
        rows = q.execute(ctx).rows
        cache.put_rows(gen, source, rows)
    return rows


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
                i1, i2 = native.intersect_sorted(rows, s.rows)
                rows = rows[i1]
                scores = scores[i1] + s.scores[i2]

        for q in self.filter:
            f_rows = _cached_filter_rows(ctx, q)
            if rows is None:
                rows = f_rows
                scores = np.zeros(len(rows), dtype=np.float32)
            else:
                i1, _ = native.intersect_sorted(rows, f_rows)
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
                i1, i2 = native.intersect_sorted(rows, should_set.rows)
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

    def to_dict(self):
        out = {}
        if self.must:
            out["must"] = [q.to_dict() for q in self.must]
        if self.filter:
            out["filter"] = [q.to_dict() for q in self.filter]
        if self.should:
            out["should"] = [q.to_dict() for q in self.should]
        if self.must_not:
            out["must_not"] = [q.to_dict() for q in self.must_not]
        if self.minimum_should_match is not None:
            out["minimum_should_match"] = self.minimum_should_match
        return {"bool": out}

    def key_is_exact(self) -> bool:
        return all(q.key_is_exact() for q in itertools.chain(
            self.must, self.filter, self.should, self.must_not))


# ------------------------------------------------------------------ parser

PORTED_KINDS = ("match_all", "match_none", "term", "terms", "match",
                "match_phrase", "multi_match", "range", "exists", "ids",
                "constant_score", "bool", "knn", "late_interaction",
                "rank_feature", "sparse_vector", "weighted_tokens")

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
    if kind == "match":
        field, v = _single(spec, "match")
        if not isinstance(v, dict):
            return MatchQuery(field, v)
        if v.get("fuzziness") is not None:
            raise ParsingError("[match] query option [fuzziness] is not "
                               "supported by this build")
        return MatchQuery(field, v.get("query"), v.get("operator", "or"),
                          v.get("minimum_should_match"),
                          float(v.get("boost", 1.0)))
    if kind == "match_phrase":
        field, v = _single(spec, "match_phrase")
        if isinstance(v, dict):
            return MatchPhraseQuery(field, v.get("query"),
                                    int(v.get("slop", 0)),
                                    float(v.get("boost", 1.0)))
        return MatchPhraseQuery(field, v)
    if kind == "multi_match":
        mmt = spec.get("type", "best_fields")
        if spec.get("slop") is not None and mmt in ("bool_prefix",
                                                    "cross_fields"):
            raise ParsingError(f"[slop] not allowed for type [{mmt}]")
        if mmt == "bool_prefix" or spec.get("fuzziness") is not None:
            what = ("type [bool_prefix]" if mmt == "bool_prefix"
                    else "option [fuzziness]")
            raise ParsingError(f"[multi_match] query {what} is not "
                               f"supported by this build")
        return MultiMatchQuery(spec.get("query"), spec.get("fields", []),
                               mmt, spec.get("operator", "or"))
    if kind == "range":
        field, v = _single(spec, "range")
        return RangeQuery(field, gte=v.get("gte", v.get("from")),
                          gt=v.get("gt"), lte=v.get("lte", v.get("to")),
                          lt=v.get("lt"), boost=float(v.get("boost", 1.0)),
                          relation=v.get("relation", "intersects").lower())
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
    if kind == "knn":
        # the clause's own defaults, the reference's: k 10, num_candidates
        # k (the top-level `knn` defaults k to num_candidates)
        from elasticsearch_tpu_torch.search.knn_query import KnnQuery
        return KnnQuery(field=spec["field"],
                        query_vector=spec["query_vector"],
                        k=int(spec.get("k", 10)),
                        num_candidates=int(spec.get("num_candidates",
                                                    spec.get("k", 10))),
                        filter_query=(parse_query(spec["filter"])
                                      if "filter" in spec else None),
                        boost=float(spec.get("boost", 1.0)))
    if kind == "late_interaction":
        return LateInteractionFilterQuery(spec)
    if kind in ("rank_feature", "sparse_vector", "weighted_tokens"):
        from elasticsearch_tpu_torch.search import queries_ext
        if kind == "rank_feature":
            return queries_ext.RankFeatureQuery(
                spec["field"], saturation=spec.get("saturation"),
                log=spec.get("log"), sigmoid=spec.get("sigmoid"),
                linear=spec.get("linear"),
                boost=float(spec.get("boost", 1.0)))
        if kind == "sparse_vector":
            return queries_ext.WeightedTokensQuery(
                spec["field"], dict(spec.get("query_vector") or {}),
                float(spec.get("boost", 1.0)))
        field, v = _single(spec, kind)
        return queries_ext.WeightedTokensQuery(
            field, dict(v.get("tokens") or {}), float(v.get("boost", 1.0)))
    if kind in _KNOWN_KINDS:
        raise ParsingError(
            f"[{kind}] query is not supported by this build: only "
            f"[{', '.join(PORTED_KINDS)}] queries are ported")
    hint = difflib.get_close_matches(str(kind), _KNOWN_KINDS, n=1)
    suffix = f" did you mean [{hint[0]}]?" if hint else ""
    raise ParsingError(f"unknown query [{kind}]{suffix}")
