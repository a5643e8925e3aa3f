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
text field), `match` (`operator`, `minimum_should_match`, `boost`,
`fuzziness`), `match_phrase` (`slop`), `match_phrase_prefix`,
`match_bool_prefix`, `multi_match` (`best_fields`, `most_fields`,
`cross_fields`, `phrase`, `phrase_prefix`, `bool_prefix`, scored as the
reference scores them: the best or the sum of per-field scores), `range`,
`exists`, `ids`, `prefix`, `wildcard`, `regexp`, `fuzzy`, `span_multi`,
`query_string` / `simple_query_string` (`field:value`, quoted phrases,
AND / OR / NOT, `+` / `-`, ranges, wildcards and `/regexp/`),
`constant_score`, `bool`, `dis_max`, `boosting`, `function_score`
(`weight`, `field_value_factor`, every `score_mode` and `boost_mode`),
`script_score` (`search/script_score.py`), and the host walkers of
`search/queries_ext.py`: `late_interaction`, `sparse_vector` /
`weighted_tokens` (the learned-sparse dot product), `rank_feature`,
`more_like_this`, `terms_set`, the span kinds, `intervals`, `pinned`,
`wrapper`, the geo queries, `distance_feature`, `nested`, the
parent-join kinds (`has_child`, `has_parent`, `parent_id`) and
`percolate`; `shape`, no kind of the reference, is its `unknown query`
error.

The multi-term kinds enumerate a field's terms, the sorted array each
segment keeps (`FieldPostings.terms`): a prefix is a `searchsorted`
range, a wildcard a pass over the range of its literal prefix, a regexp
a pass over every term, and an edit distance (OSA: a transposition is one
edit) runs only on the terms that a length and a character-count bound
leave (`_fuzzy_terms`). The answer is the reference's: the sorted union
of the matching terms over the segments. `search.allow_expensive_queries:
false` (the context's `allow_expensive`) refuses them, and `range` on a
text or keyword field, with the reference's messages.

A `bool`'s `filter` clauses run through the node query cache
(`search/caches.py::QueryCache`), keyed on the reader's `gen` and the
clause's canonical form, `json.dumps(q.to_dict(), sort_keys=True,
default=str)`: every query class gives the reference's `to_dict`, so
equivalent sources share one entry, as they do there. The reference's
form leaves out `match`'s `minimum_should_match` and `fuzziness`,
`multi_match`'s `operator`, `match_bool_prefix`'s options,
`query_string`'s fields and operator and `function_score`'s modes; a
clause that sets them (`key_is_exact` false) is evaluated every time
rather than served another clause's rows.
"""

from __future__ import annotations

import difflib
import fnmatch
import itertools
import json
import math
import re
from typing import Any, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError, QueryShardError,
)
from elasticsearch_tpu_torch.index.analysis import DEFAULT_REGISTRY
from elasticsearch_tpu_torch.index.mapping import (
    BooleanFieldMapper, DateFieldMapper, DateNanosFieldMapper, IpFieldMapper,
    KeywordFieldMapper, MapperService, RangeFieldMapperBase, TextFieldMapper,
    _NumericMapper, parse_date_millis, parse_date_nanos,
)
from elasticsearch_tpu_torch.index.segment import ShardReader

DEFAULT_MAX_TERMS_COUNT = 65536
DEFAULT_MAX_REGEX_LENGTH = 1000
# the expansions `match_phrase_prefix` takes of its last term
PHRASE_PREFIX_EXPANSIONS = 50
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
    query cache (None caches nothing); `allow_expensive` is the node's
    `search.allow_expensive_queries`. `deadline_at` is an absolute
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
        # `search.allow_expensive_queries`, set by the node
        self.allow_expensive = True
        # a `knn` clause scores on the store's exact route (`_explain`)
        self.knn_exact = False
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


def id_row_map(reader: ShardReader) -> dict:
    """`_id` -> live row of a reader, built once a reader (its segments'
    id lists zipped with their rows)."""
    cache = getattr(reader, "_id_row_cache", None)
    if cache is None:
        cache = {}
        for v in reader.views:
            seg = v.segment
            if v.all_live:
                cache.update(zip(seg.ids, range(seg.base,
                                                seg.base + seg.num_docs)))
            else:
                locs = np.nonzero(v.live)[0]
                cache.update(zip([seg.ids[i] for i in locs.tolist()],
                                 (locs + seg.base).tolist()))
        reader._id_row_cache = cache
    return cache


def _id_rows(ctx: SearchContext, ids) -> np.ndarray:
    """Live rows of the given `_id`s, ascending."""
    cache = id_row_map(ctx.reader)
    rows = sorted(r for r in (cache.get(str(i)) for i in ids)
                  if r is not None)
    return np.asarray(rows, dtype=np.int64)


def _term_postings(ctx: SearchContext, field: str, term: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(live rows, freqs) of `term` in `field`, ascending."""
    field = ctx.mapper_service.resolve_field(field)
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


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [lo[i], hi[i])."""
    n = hi - lo
    total = int(n.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.repeat(lo - np.concatenate(([0], np.cumsum(n)[:-1])), n)
    return starts + np.arange(total, dtype=np.int64)


def _rows_of_terms(ctx: SearchContext, field: str,
                   terms: List[str]) -> np.ndarray:
    """The live rows holding any of `terms` in `field`, ascending: each
    segment's postings ranges of the terms it holds, gathered at once."""
    field = ctx.mapper_service.resolve_field(field)
    want = np.asarray(terms, dtype=str)
    parts = []
    for view in ctx.reader.views:
        fp = view.segment.postings.get(field)
        if fp is None or not len(fp.terms):
            continue
        j = _held(fp.terms, want)
        if not len(j):
            continue
        docs = fp.doc_ids[_ranges(fp.starts[j], fp.starts[j + 1])]
        if not view.all_live:
            docs = docs[view.live[docs]]
        parts.append(docs.astype(np.int64) + view.segment.base)
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(parts))


def _held(sorted_terms: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The positions in `sorted_terms` of the wanted terms it holds."""
    j = np.searchsorted(sorted_terms, want)
    ok = j < len(sorted_terms)
    j, w = j[ok], want[ok]
    return np.unique(j[sorted_terms[j] == w])


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
    field = ctx.mapper_service.resolve_field(field)
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
    """`terms`: the constant boost on the docs holding any of the values.
    `index.max_terms_count` bounds a caller's list only, not the terms a
    multi-term query expands to."""

    def __init__(self, field: str, values: List[Any], boost: float = 1.0,
                 user_supplied: bool = True):
        self.field = field
        self.values = values
        self.boost = boost
        self.user_supplied = user_supplied

    def execute(self, ctx: SearchContext) -> DocSet:
        max_terms = int(ctx.index_settings.get("index.max_terms_count",
                                               DEFAULT_MAX_TERMS_COUNT))
        if self.user_supplied and len(self.values) > max_terms:
            raise IllegalArgumentError(
                f"The number of terms [{len(self.values)}] used in the "
                f"Terms Query request has exceeded the allowed maximum "
                f"of [{max_terms}]. This maximum can be set by changing "
                f"the [index.max_terms_count] index level setting.")
        if self.field == "_id":
            return _constant(_id_rows(ctx, self.values), self.boost)
        mapper = ctx.mapper_service.get(self.field)
        terms = [t for t in (str(v) if isinstance(mapper, TextFieldMapper)
                             else _index_term_for(mapper, v)
                             for v in self.values) if t is not None]
        if not terms:
            return DocSet.empty()
        return _constant(_rows_of_terms(ctx, self.field, terms), self.boost)

    def to_dict(self):
        return {"terms": {self.field: self.values}}


class MatchQuery(Query):
    """`match`: the text analyzed by the field's search analyzer, one
    BM25 clause a term (a repeated term counts twice), combined as
    `bool.should` with `operator: and` requiring every clause, else
    `minimum_should_match` (default 1). On a non-text field the value is
    its one index term. With `fuzziness` each term is replaced by the
    field's terms within its edit distance (`_fuzzy_expand`), each one
    clause."""

    def __init__(self, field: str, text: Any, operator: str = "or",
                 minimum_should_match=None, boost: float = 1.0,
                 fuzziness=None):
        self.field = field
        self.text = text
        self.operator = str(operator).lower()
        self.minimum_should_match = minimum_should_match
        self.boost = boost
        self.fuzziness = fuzziness

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
        if self.fuzziness is not None:
            expanded = []
            for t in terms:
                expanded.extend(_fuzzy_expand(
                    ctx, ctx.mapper_service.resolve_field(self.field), t,
                    self.fuzziness))
            terms = expanded or terms
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
        # the form leaves out fuzziness, and minimum_should_match, which
        # `and` overrides
        return self.fuzziness is None and (
            self.minimum_should_match is None or self.operator == "and")


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
    field patterns over the text and keyword fields), or for `bool_prefix`
    one `match_bool_prefix` a field (with the operator,
    `minimum_should_match`, `analyzer` and `fuzziness`); the best field's
    score for `best_fields`, else their sum, as the reference scores
    every other type. As in the reference, `fuzziness` acts on
    `bool_prefix` only."""

    def __init__(self, query: str, fields: List[str],
                 mm_type: str = "best_fields", operator: str = "or",
                 boost: float = 1.0, analyzer: Optional[str] = None,
                 minimum_should_match=None, fuzziness=None):
        self.query = query
        self.fields = fields
        self.mm_type = mm_type
        self.operator = operator
        self.boost = boost
        self.analyzer = analyzer
        self.minimum_should_match = minimum_should_match
        self.fuzziness = fuzziness

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
            if self.mm_type == "bool_prefix":
                sets.append(MatchBoolPrefixQuery(
                    name, self.query, boost=self.boost * fboost,
                    operator=self.operator,
                    minimum_should_match=self.minimum_should_match,
                    analyzer=self.analyzer,
                    fuzziness=self.fuzziness).execute(ctx))
            else:
                sets.append(MatchQuery(name, self.query,
                                       operator=self.operator,
                                       boost=self.boost * fboost
                                       ).execute(ctx))
        if not sets:
            return DocSet.empty()
        if self.mm_type == "best_fields":
            return _combine_max(sets)
        return _combine_should(sets, 1)

    def to_dict(self):
        return {"multi_match": {"query": self.query, "fields": self.fields,
                                "type": self.mm_type}}

    def key_is_exact(self) -> bool:
        # the form leaves out the operator, and bool_prefix's options
        if self.mm_type == "bool_prefix":
            return str(self.operator).lower() == "or" and (
                self.minimum_should_match is None and self.analyzer is None
                and self.fuzziness is None)
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
    field = ctx.mapper_service.resolve_field(field)
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
        if isinstance(mapper, (TextFieldMapper, KeywordFieldMapper)) \
                and getattr(ctx, "allow_expensive", True) is False:
            raise IllegalArgumentError(
                "[range] queries on [text] or [keyword] fields cannot be "
                "executed when 'search.allow_expensive_queries' is set to "
                "false.")
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

        field = ctx.mapper_service.resolve_field(self.field)
        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(field)
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
        field = ctx.mapper_service.resolve_field(self.field)
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


# ------------------------------------------------------ multi-term queries

def _term_arrays(ctx: SearchContext, field: str):
    """Each segment's sorted term array of `field` (the postings)."""
    for view in ctx.reader.views:
        fp = view.segment.postings.get(field)
        if fp is not None and len(fp.terms):
            yield fp


def _pattern_terms(ctx: SearchContext, field: str, select) -> List[str]:
    """The sorted union over the segments of the terms of `field` that
    `select` keeps: select(FieldPostings) gives the kept terms of one
    segment as an array."""
    parts = [select(fp) for fp in _term_arrays(ctx, field)]
    parts = [p for p in parts if len(p)]
    if not parts:
        return []
    return np.unique(np.concatenate(parts)).tolist()


def _prefix_range(terms: np.ndarray, prefix: str) -> Tuple[int, int]:
    """The [lo, hi) positions of the sorted terms that start with
    `prefix`: those from `prefix` up to the prefix with its last code
    point raised by one."""
    if not prefix:
        return 0, len(terms)
    lo = int(np.searchsorted(terms, prefix))
    last = ord(prefix[-1])
    if last >= 0x10FFFF:
        hi = lo + int(np.char.startswith(terms[lo:], prefix).sum())
    else:
        hi = int(np.searchsorted(terms, prefix[:-1] + chr(last + 1)))
    return lo, hi


def _prefix_select(prefix: str):
    def select(fp):
        lo, hi = _prefix_range(fp.terms, prefix)
        return fp.terms[lo:hi]
    return select


def _regex_select(pattern, literal_prefix: str = ""):
    """Terms a compiled pattern matches, tried only within the range of
    the pattern's literal prefix."""
    def select(fp):
        lo, hi = _prefix_range(fp.terms, literal_prefix)
        window = fp.terms[lo:hi]
        keep = [i for i, t in enumerate(window.tolist())
                if pattern.match(t) is not None]
        return window[keep]
    return select


def _check_expensive(ctx: SearchContext, qtype: str, extra: str = "") -> None:
    """The `search.allow_expensive_queries` gate."""
    if getattr(ctx, "allow_expensive", True) is False:
        raise IllegalArgumentError(
            f"[{qtype}] queries cannot be executed when "
            f"'search.allow_expensive_queries' is set to false.{extra}")


def _expansion_set(ctx: SearchContext, field: str, terms: List[str],
                   boost: float) -> DocSet:
    """A multi-term query's rows: `terms` as a `terms` query of the
    caller's boost (no `index.max_terms_count` bound)."""
    if not terms:
        return DocSet.empty()
    return TermsQuery(field, terms, boost, user_supplied=False).execute(ctx)


class PrefixQuery(Query):
    def __init__(self, field: str, value: str, boost: float = 1.0):
        self.field = field
        self.value = str(value)
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "prefix",
                         " For optimised prefix queries on text fields "
                         "please enable [index_prefixes].")
        field = ctx.mapper_service.resolve_field(self.field)
        terms = _pattern_terms(ctx, field, _prefix_select(self.value))
        return _expansion_set(ctx, self.field, terms, self.boost)

    def to_dict(self):
        return {"prefix": {self.field: {"value": self.value}}}


def _wildcard_regex(value: str):
    return re.compile(
        "^" + "".join(".*" if c == "*" else "." if c == "?"
                      else re.escape(c) for c in value) + "$")


class WildcardQuery(Query):
    def __init__(self, field: str, value: str, boost: float = 1.0):
        self.field = field
        self.value = str(value)
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "wildcard")
        literal = re.split(r"[*?]", self.value, maxsplit=1)[0]
        field = ctx.mapper_service.resolve_field(self.field)
        terms = _pattern_terms(ctx, field, _regex_select(
            _wildcard_regex(self.value), literal))
        return _expansion_set(ctx, self.field, terms, self.boost)

    def to_dict(self):
        return {"wildcard": {self.field: {"value": self.value}}}


class RegexpQuery(Query):
    def __init__(self, field: str, value: str, boost: float = 1.0):
        self.field = field
        self.value = str(value)
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "regexp")
        max_len = int(ctx.index_settings.get("index.max_regex_length",
                                             DEFAULT_MAX_REGEX_LENGTH))
        if len(self.value) > max_len:
            raise IllegalArgumentError(
                f"The length of regex [{len(self.value)}] used in the "
                f"Regexp Query request has exceeded the allowed maximum "
                f"of [{max_len}]. This maximum can be set by changing the "
                f"[index.max_regex_length] index level setting.")
        try:
            pattern = re.compile("^" + self.value + "$")
        except re.error as e:
            raise IllegalArgumentError(
                f"invalid regexp [{self.value}]: {e}")
        field = ctx.mapper_service.resolve_field(self.field)
        terms = _pattern_terms(ctx, field, _regex_select(pattern))
        return _expansion_set(ctx, self.field, terms, self.boost)

    def to_dict(self):
        return {"regexp": {self.field: {"value": self.value}}}


def _edit_distance_le(a: str, b: str, k: int) -> bool:
    """Whether the restricted Damerau-Levenshtein (OSA) distance of a and
    b is at most k: an adjacent transposition counts as one edit."""
    if abs(len(a) - len(b)) > k:
        return False
    prev2: Optional[List[int]] = None
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        best = cur[0]
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
            if (prev2 is not None and i > 1 and j > 1
                    and ca == b[j - 2] and a[i - 2] == cb):
                cur[j] = min(cur[j], prev2[j - 2] + 1)
            best = min(best, cur[j])
        if best > k:
            return False
        prev2, prev = prev, cur
    return prev[-1] <= k


# code points fold into this many buckets for the bag-distance bound
_SHAPE_BUCKETS = 61
_SHAPE_CHUNK = 1 << 15


def _char_counts(codes: np.ndarray) -> np.ndarray:
    """[n, _SHAPE_BUCKETS] int16 counts of the code points (0 = padding)
    of each row of `codes`, folded into buckets."""
    n = len(codes)
    nz = codes != 0
    r, c = np.nonzero(nz)
    flat = r * _SHAPE_BUCKETS + (codes[r, c] % _SHAPE_BUCKETS)
    return np.bincount(flat, minlength=n * _SHAPE_BUCKETS).reshape(
        n, _SHAPE_BUCKETS).astype(np.int16)


def _term_shape(fp) -> Tuple[np.ndarray, np.ndarray]:
    """(lengths, bucketed code point counts) of a segment's terms, made at
    the first fuzzy enumeration of the field and kept with its
    postings."""
    if fp.term_shape is None:
        terms = np.ascontiguousarray(fp.terms)
        width = terms.dtype.itemsize // 4
        codes = terms.view(np.uint32).reshape(len(terms), width)
        lengths = (codes != 0).sum(axis=1)
        counts = np.concatenate([
            _char_counts(codes[lo:lo + _SHAPE_CHUNK])
            for lo in range(0, len(terms), _SHAPE_CHUNK)])
        fp.term_shape = (lengths, counts)
    return fp.term_shape


def _fuzzy_select(term: str, k: int, exclude_self: bool = False):
    """A segment's terms within OSA distance k of `term`. The distance is
    run only on the terms within k of its length whose bag distance (the
    larger of the code points each side holds beyond the other, a lower
    bound of the edit distance, here over folded buckets) is at most k."""
    q = np.asarray([term], dtype=str)
    q_counts = _char_counts(q.view(np.uint32).reshape(1, -1))[0]

    def select(fp):
        lengths, counts = _term_shape(fp)
        dl = np.abs(lengths - len(term))
        cand = np.nonzero(dl <= k)[0]
        if len(cand):
            # the code points each side holds beyond the other, p and m:
            # p + m is the L1 distance of the counts, p - m the length
            # difference, so max(p, m) = (L1 + |dl|) / 2
            l1 = np.abs(counts[cand] - q_counts).sum(axis=1,
                                                     dtype=np.int32)
            cand = cand[(l1 + dl[cand]) <= 2 * k]
        keep = [i for i, t in zip(cand.tolist(), fp.terms[cand].tolist())
                if (not exclude_self or t != term)
                and _edit_distance_le(term, t, k)]
        return fp.terms[keep]
    return select


def _fuzzy_terms(ctx: SearchContext, field: str, term: str, k: int,
                 exclude_self: bool = False) -> List[str]:
    return _pattern_terms(ctx, field, _fuzzy_select(term, k, exclude_self))


def _fuzzy_expand(ctx: SearchContext, field: str, term: str,
                  fuzziness) -> List[str]:
    """The field's terms within `fuzziness` edits of `term`: AUTO is 0, 1
    or 2 edits for a term of at most 2, at most 5, or more characters."""
    if fuzziness in ("AUTO", "auto", None):
        k = 0 if len(term) <= 2 else 1 if len(term) <= 5 else 2
    else:
        k = int(fuzziness)
    if k == 0:
        return [term]
    return _fuzzy_terms(ctx, field, term, k)


class FuzzyQuery(Query):
    def __init__(self, field: str, value: str, fuzziness="AUTO",
                 boost: float = 1.0):
        self.field = field
        self.value = str(value)
        self.fuzziness = fuzziness
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "fuzzy")
        field = ctx.mapper_service.resolve_field(self.field)
        terms = _fuzzy_expand(ctx, field, self.value, self.fuzziness)
        if not terms:
            return DocSet.empty()
        sets = [TermQuery(self.field, t, self.boost).execute(ctx)
                for t in terms]
        return _combine_should(sets, 1)

    def to_dict(self):
        return {"fuzzy": {self.field: {"value": self.value,
                                       "fuzziness": self.fuzziness}}}


class MatchPhrasePrefixQuery(Query):
    """`match_phrase_prefix`: the phrase with its last term replaced by
    each of the first `PHRASE_PREFIX_EXPANSIONS` terms it prefixes, summed
    as `should`; on a non-text field a `prefix` query."""

    def __init__(self, field: str, text: str, boost: float = 1.0):
        self.field = field
        self.text = str(text)
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        mapper = ctx.mapper_service.get(self.field)
        if not isinstance(mapper, TextFieldMapper):
            return PrefixQuery(self.field, self.text, self.boost).execute(ctx)
        terms = mapper.search_analyzer.terms(self.text)
        if not terms:
            return DocSet.empty()
        *head, last = terms
        field = ctx.mapper_service.resolve_field(self.field)
        expansions = _pattern_terms(ctx, field, _prefix_select(
            last))[:PHRASE_PREFIX_EXPANSIONS]
        if not expansions:
            return DocSet.empty()
        sets = []
        for exp in expansions:
            phrase = " ".join(head + [exp]) if head else exp
            sets.append(MatchPhraseQuery(self.field, phrase,
                                         boost=self.boost).execute(ctx))
        return _combine_should(sets, 1)

    def to_dict(self):
        return {"match_phrase_prefix": {self.field: {"query": self.text}}}


class MatchBoolPrefixQuery(Query):
    """`match_bool_prefix`: the analyzed text (by `analyzer`, else the
    field's search analyzer) as `should` clauses, a term clause each but
    the last, which is a `prefix`; `fuzziness` makes the complete terms
    `fuzzy` clauses."""

    def __init__(self, field: str, text: str, boost: float = 1.0,
                 operator: str = "or", minimum_should_match=None,
                 analyzer: Optional[str] = None, fuzziness=None):
        self.field = field
        self.text = str(text)
        self.boost = boost
        self.operator = str(operator).lower()
        self.minimum_should_match = minimum_should_match
        self.analyzer = analyzer
        self.fuzziness = fuzziness

    def execute(self, ctx: SearchContext) -> DocSet:
        mapper = ctx.mapper_service.get(self.field)
        if self.analyzer is not None:
            registry = ctx.mapper_service.registry or DEFAULT_REGISTRY
            terms = registry.get(self.analyzer).terms(self.text)
        elif isinstance(mapper, TextFieldMapper):
            terms = mapper.search_analyzer.terms(self.text)
        else:
            terms = [self.text]
        if not terms:
            return DocSet.empty()
        *head, last = terms
        if self.fuzziness is not None:
            sets = [FuzzyQuery(self.field, t, self.fuzziness,
                               self.boost).execute(ctx) for t in head]
        else:
            sets = [TermQuery(self.field, t, self.boost).execute(ctx)
                    for t in head]
        sets.append(PrefixQuery(self.field, last, self.boost).execute(ctx))
        if self.minimum_should_match is not None:
            required = resolve_msm(self.minimum_should_match, len(sets))
        else:
            required = len(sets) if self.operator == "and" else 1
        return _combine_should(sets, required)

    def to_dict(self):
        return {"match_bool_prefix": {self.field: {"query": self.text}}}

    def key_is_exact(self) -> bool:
        # the form keeps only the text
        return (self.operator == "or" and self.minimum_should_match is None
                and self.analyzer is None and self.fuzziness is None)


class QueryStringQuery(Query):
    """`query_string` (and `simple_query_string`): `field:value`, quoted
    phrases, AND / OR / NOT and `+` / `-`, `[a TO b]` / `{a TO b}` ranges
    (`*` an open bound), `*` / `?` wildcards (lower-cased) and `/regexp/`,
    over `default_field` / `fields` or every text field (a `dis_max` of the
    fields). An explicit AND binds both neighbours, an OR frees both,
    else the default operator decides, as in Lucene's classic parser."""

    def __init__(self, query: str, default_fields=None,
                 default_operator: str = "or", boost: float = 1.0):
        self.query = str(query)
        if isinstance(default_fields, str):
            default_fields = [default_fields]
        self.default_fields_param = list(default_fields or [])
        op = str(default_operator).strip().lower()
        if op not in ("and", "or"):
            raise ParsingError(f"invalid default_operator "
                               f"[{default_operator}], expected AND or OR")
        self.default_operator = op
        self.boost = boost

    _TOKEN_RE = re.compile(
        r'([+-]?)(?:(\w[\w.]*):)?'
        r'("(?:[^"]*)"|[\[{][^\]}]*[\]}]|\S+)')

    _RANGE_RE = re.compile(
        r'^([\[{])\s*(\S+)\s+TO\s+(\S+)\s*([\]}])$')

    def _default_fields(self, ctx: SearchContext) -> List[str]:
        fields = [f for f in self.default_fields_param if f != "*"]
        if fields:
            return [f.split("^")[0] for f in fields]
        return [p for p in ctx.mapper_service.field_names()
                if isinstance(ctx.mapper_service.get(p), TextFieldMapper)]

    def execute(self, ctx: SearchContext) -> DocSet:
        if self.query.strip() == "*":
            return MatchAllQuery(self.boost).execute(ctx)
        q = self.query.strip()
        if len(q) > 2 and q.startswith("/") and q.endswith("/"):
            # a whole-query /re/ is a regexp on each default field
            fields = self._default_fields(ctx) or ["_all"]
            subs = [RegexpQuery(f, q[1:-1]) for f in fields]
            sub = subs[0] if len(subs) == 1 else DisMaxQuery(subs)
            return sub.execute(ctx)

        # pass 1: the clauses and the connectors between them
        clauses: List[dict] = []
        connectors: List[Optional[str]] = []
        negate_next = False
        for m in self._TOKEN_RE.finditer(self.query):
            sign, field, text = m.group(1), m.group(2), m.group(3)
            if text in ("AND", "OR"):
                if connectors:
                    connectors[-1] = text
                continue
            if text == "NOT":
                negate_next = True
                continue
            phrase = text.startswith('"') and text.endswith('"')
            clauses.append({"sign": sign, "field": field,
                            "text": text[1:-1] if phrase else text,
                            "phrase": phrase, "negated": negate_next})
            negate_next = False
            connectors.append(None)
        if not clauses:
            return DocSet.empty()

        # pass 2: required or optional
        n = len(clauses)
        required = [self.default_operator == "and"] * n
        for i in range(n - 1):
            if connectors[i] == "AND":
                required[i] = required[i + 1] = True
            elif connectors[i] == "OR":
                required[i] = required[i + 1] = False

        must: List[Query] = []
        should: List[Query] = []
        must_not: List[Query] = []
        for i, c in enumerate(clauses):
            # the clauses score at boost 1; the bool applies self.boost
            if c["field"]:
                range_m = self._RANGE_RE.match(c["text"])
                if range_m and not c["phrase"]:
                    open_b, lo, hi, close_b = range_m.groups()
                    kw = {}
                    if lo != "*":
                        kw["gte" if open_b == "[" else "gt"] = lo
                    if hi != "*":
                        kw["lte" if close_b == "]" else "lt"] = hi
                    sub: Query = RangeQuery(c["field"], **kw)
                elif (len(c["text"]) > 2 and c["text"].startswith("/")
                      and c["text"].endswith("/") and not c["phrase"]):
                    sub = RegexpQuery(c["field"], c["text"][1:-1])
                elif not c["phrase"] and ("*" in c["text"]
                                          or "?" in c["text"]):
                    sub = WildcardQuery(c["field"], c["text"].lower())
                else:
                    sub = (MatchPhraseQuery(c["field"], c["text"])
                           if c["phrase"]
                           else MatchQuery(c["field"], c["text"]))
            else:
                fields = self._default_fields(ctx)
                if not c["phrase"] and ("*" in c["text"]
                                        or "?" in c["text"]):
                    subs: List[Query] = [
                        WildcardQuery(f, c["text"].lower()) for f in fields]
                else:
                    subs = [MatchPhraseQuery(f, c["text"]) if c["phrase"]
                            else MatchQuery(f, c["text"]) for f in fields]
                if not subs:
                    continue
                sub = subs[0] if len(subs) == 1 else DisMaxQuery(subs)
            if c["sign"] == "-" or c["negated"]:
                must_not.append(sub)
            elif c["sign"] == "+" or required[i]:
                must.append(sub)
            else:
                should.append(sub)
        if not (must or should or must_not):
            return DocSet.empty()
        return BoolQuery(must=must, should=should, must_not=must_not,
                         boost=self.boost).execute(ctx)

    def to_dict(self):
        return {"query_string": {"query": self.query}}

    def key_is_exact(self) -> bool:
        # the form keeps only the query text
        return not self.default_fields_param \
            and self.default_operator == "or"


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


# --------------------------------------------------------- scoring wrappers

class BoostingQuery(Query):
    """`boosting`: the positive query's hits, their scores times
    `negative_boost` where the negative query also matches."""

    def __init__(self, positive: Query, negative: Query,
                 negative_boost: float):
        self.positive = positive
        self.negative = negative
        self.negative_boost = negative_boost

    def execute(self, ctx: SearchContext) -> DocSet:
        pos = self.positive.execute(ctx).with_scores()
        neg = self.negative.execute(ctx)
        scores = pos.scores.copy()
        scores[in_sorted(pos.rows, neg.rows)] *= self.negative_boost
        return DocSet(pos.rows, scores)

    def to_dict(self):
        return {"boosting": {"positive": self.positive.to_dict(),
                             "negative": self.negative.to_dict(),
                             "negative_boost": self.negative_boost}}

    def key_is_exact(self) -> bool:
        return self.positive.key_is_exact() and self.negative.key_is_exact()


class DisMaxQuery(Query):
    """`dis_max`: the union of the queries' hits, each scored as its best
    query's score plus `tie_breaker` times the others'."""

    def __init__(self, queries: List[Query], tie_breaker: float = 0.0,
                 boost: float = 1.0):
        self.queries = queries
        self.tie_breaker = tie_breaker
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        sets = [q.execute(ctx).with_scores() for q in self.queries]
        if not sets:
            return DocSet.empty()
        rows = np.unique(np.concatenate([s.rows for s in sets]))
        best = np.zeros(len(rows), dtype=np.float32)
        total = np.zeros(len(rows), dtype=np.float32)
        for s in sets:
            idx = np.searchsorted(rows, s.rows)
            np.maximum.at(best, idx, s.scores)
            np.add.at(total, idx, s.scores)
        scores = best + self.tie_breaker * (total - best)
        return DocSet(rows, scores * self.boost)

    def to_dict(self):
        return {"dis_max": {"queries": [q.to_dict() for q in self.queries],
                            "tie_breaker": self.tie_breaker}}

    def key_is_exact(self) -> bool:
        return all(q.key_is_exact() for q in self.queries)


def scalar_numbers(reader: ShardReader, rows: np.ndarray,
                   field: str) -> Tuple[np.ndarray, np.ndarray]:
    """(values f64, present) of `field` over rows, where present means the
    doc holds one number: a list, a boolean or a string counts as
    missing, as `field_value_factor` reads the reference's doc values.
    A numeric column is gathered directly; another one value by value."""
    rows = np.asarray(rows, dtype=np.int64)
    vals = np.zeros(len(rows), dtype=np.float64)
    present = np.zeros(len(rows), dtype=bool)
    if not len(rows):
        return vals, present
    vi, local = reader.locate_many(rows)
    for v in np.unique(vi):
        col = reader.views[v].segment.doc_values.get(field)
        if col is None:
            continue
        at = np.nonzero(vi == v)[0]
        loc = local[at]
        if col.numeric is not None:
            ok = col.present[loc] & ~col.multi[loc]
            vals[at[ok]] = col.numeric[loc[ok]]
        else:
            ok = np.fromiter(
                (x is not None and not isinstance(x, (list, str, bool))
                 and isinstance(x, (int, float))
                 for x in col.values[loc]), dtype=bool, count=len(loc))
            vals[at[ok]] = [float(x) for x in col.values[loc[ok]]]
        present[at] = ok
    return vals, present


_SCORE_MODES = ("multiply", "sum", "max", "min", "avg")


class FunctionScoreQuery(Query):
    """`function_score`: the query's hits rescored by its functions
    (`weight`, `field_value_factor` with `factor`, `missing` and
    `modifier`: none, log1p, sqrt, square), combined by `score_mode` and
    joined to the query's score by `boost_mode` (multiply, sum, max, min,
    avg, replace). A function's values run in f64 and are cast to f32, as
    in the reference; `field_value_factor` reads the doc values vectorised
    (`scalar_numbers`)."""

    def __init__(self, query: Query, functions: List[dict],
                 boost_mode: str = "multiply", score_mode: str = "multiply"):
        self.query = query
        self.functions = functions
        self.boost_mode = boost_mode
        self.score_mode = score_mode

    def execute(self, ctx: SearchContext) -> DocSet:
        base = self.query.execute(ctx).with_scores()
        if len(base.rows) == 0 or not self.functions:
            return base
        func_scores = []
        for fn in self.functions:
            weight = float(fn.get("weight", 1.0))
            if "field_value_factor" in fn:
                spec = fn["field_value_factor"]
                factor = float(spec.get("factor", 1.0))
                missing = float(spec.get("missing", 1.0))
                modifier = spec.get("modifier", "none")
                got, present = scalar_numbers(ctx.reader, base.rows,
                                              spec["field"])
                vals = np.where(present, got, missing) * factor
                if modifier == "log1p":
                    vals = np.log1p(np.maximum(vals, 0))
                elif modifier == "sqrt":
                    vals = np.sqrt(np.maximum(vals, 0))
                elif modifier == "square":
                    vals = vals ** 2
                func_scores.append(weight * vals.astype(np.float32))
            else:
                func_scores.append(np.full(len(base.rows), weight,
                                           dtype=np.float32))
        combined = func_scores[0]
        for fs in func_scores[1:]:
            if self.score_mode == "sum":
                combined = combined + fs
            elif self.score_mode == "max":
                combined = np.maximum(combined, fs)
            elif self.score_mode == "min":
                combined = np.minimum(combined, fs)
            elif self.score_mode == "avg":
                combined = (combined + fs) / 2
            else:
                combined = combined * fs
        if self.boost_mode == "replace":
            new = combined
        elif self.boost_mode == "sum":
            new = base.scores + combined
        elif self.boost_mode == "max":
            new = np.maximum(base.scores, combined)
        elif self.boost_mode == "min":
            new = np.minimum(base.scores, combined)
        elif self.boost_mode == "avg":
            new = (base.scores + combined) / 2
        else:
            new = base.scores * combined
        return DocSet(base.rows, new.astype(np.float32))

    def to_dict(self):
        return {"function_score": {"query": self.query.to_dict(),
                                   "functions": self.functions}}

    def key_is_exact(self) -> bool:
        # the form leaves out both modes
        return (self.boost_mode == "multiply"
                and self.score_mode == "multiply"
                and self.query.key_is_exact())


# ------------------------------------------------------------------ parser

PORTED_KINDS = ("match_all", "match_none", "term", "terms", "match",
                "match_phrase", "match_phrase_prefix", "match_bool_prefix",
                "multi_match", "range", "exists", "ids", "prefix",
                "wildcard", "regexp", "fuzzy", "span_multi", "query_string",
                "simple_query_string", "constant_score", "bool", "dis_max",
                "boosting", "function_score", "script_score", "knn",
                "late_interaction", "rank_feature", "sparse_vector",
                "weighted_tokens", "more_like_this", "terms_set",
                "span_term", "span_near", "span_or", "span_not",
                "span_first", "intervals", "pinned", "wrapper",
                "geo_distance", "geo_bounding_box", "geo_polygon",
                "geo_shape", "distance_feature", "nested", "has_child",
                "has_parent", "parent_id", "percolate")

# the extended kinds `search/queries_ext.py::parse_extended` parses
_EXTENDED_KINDS = PORTED_KINDS[PORTED_KINDS.index("more_like_this"):]

# the kinds of the reference this build leaves out: none, the port parses
# every kind the reference parses
_LEFT_OUT_KINDS: dict = {}

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
        return MatchQuery(field, v.get("query"), v.get("operator", "or"),
                          v.get("minimum_should_match"),
                          float(v.get("boost", 1.0)), v.get("fuzziness"))
    if kind == "match_phrase":
        field, v = _single(spec, "match_phrase")
        if isinstance(v, dict):
            return MatchPhraseQuery(field, v.get("query"),
                                    int(v.get("slop", 0)),
                                    float(v.get("boost", 1.0)))
        return MatchPhraseQuery(field, v)
    if kind == "match_phrase_prefix":
        field, v = _single(spec, "match_phrase_prefix")
        text = v.get("query") if isinstance(v, dict) else v
        return MatchPhrasePrefixQuery(field, text)
    if kind == "match_bool_prefix":
        field, v = _single(spec, "match_bool_prefix")
        if isinstance(v, dict):
            return MatchBoolPrefixQuery(
                field, v.get("query"), float(v.get("boost", 1.0)),
                v.get("operator", "or"),
                minimum_should_match=v.get("minimum_should_match"),
                analyzer=v.get("analyzer"), fuzziness=v.get("fuzziness"))
        return MatchBoolPrefixQuery(field, v)
    if kind in ("query_string", "simple_query_string"):
        fields = spec.get("fields") or (
            [spec["default_field"]] if spec.get("default_field") else [])
        return QueryStringQuery(spec.get("query", ""), fields,
                                spec.get("default_operator", "or"),
                                float(spec.get("boost", 1.0)))
    if kind == "multi_match":
        mmt = spec.get("type", "best_fields")
        if spec.get("slop") is not None and mmt in ("bool_prefix",
                                                    "cross_fields"):
            raise ParsingError(f"[slop] not allowed for type [{mmt}]")
        return MultiMatchQuery(spec.get("query"), spec.get("fields", []),
                               mmt, spec.get("operator", "or"),
                               analyzer=spec.get("analyzer"),
                               minimum_should_match=spec.get(
                                   "minimum_should_match"),
                               fuzziness=spec.get("fuzziness"))
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
    if kind == "prefix":
        field, v = _single(spec, "prefix")
        return PrefixQuery(field, v.get("value") if isinstance(v, dict)
                           else v)
    if kind == "span_multi":
        # a multi-term query in span position; alone it matches as the
        # query it wraps
        return parse_query(spec.get("match") or {"match_all": {}})
    if kind == "wildcard":
        field, v = _single(spec, "wildcard")
        return WildcardQuery(field, (v.get("value") or v.get("wildcard"))
                             if isinstance(v, dict) else v)
    if kind == "regexp":
        field, v = _single(spec, "regexp")
        return RegexpQuery(field, v.get("value") if isinstance(v, dict)
                           else v)
    if kind == "fuzzy":
        field, v = _single(spec, "fuzzy")
        if isinstance(v, dict):
            return FuzzyQuery(field, v.get("value"),
                              v.get("fuzziness", "AUTO"))
        return FuzzyQuery(field, v)
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
    if kind == "boosting":
        return BoostingQuery(parse_query(spec["positive"]),
                             parse_query(spec["negative"]),
                             float(spec.get("negative_boost", 0.5)))
    if kind == "dis_max":
        return DisMaxQuery([parse_query(q) for q in spec.get("queries", [])],
                           float(spec.get("tie_breaker", 0.0)))
    if kind == "function_score":
        inner = parse_query(spec.get("query", {"match_all": {}}))
        functions = spec.get("functions")
        if functions is None:
            functions = [{k: v for k, v in spec.items()
                          if k in ("field_value_factor", "weight")}]
        return FunctionScoreQuery(inner, functions,
                                  spec.get("boost_mode", "multiply"),
                                  spec.get("score_mode", "multiply"))
    if kind == "script_score":
        from elasticsearch_tpu_torch.search.script_score import (
            ScriptScoreQuery)
        return ScriptScoreQuery(
            parse_query(spec.get("query", {"match_all": {}})),
            spec.get("script", {}))
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
    if kind in _EXTENDED_KINDS:
        from elasticsearch_tpu_torch.search.queries_ext import parse_extended
        return parse_extended(kind, spec)
    hint = difflib.get_close_matches(str(kind), _KNOWN_KINDS, n=1)
    suffix = f" did you mean [{hint[0]}]?" if hint else ""
    raise ParsingError(f"unknown query [{kind}]{suffix}")
