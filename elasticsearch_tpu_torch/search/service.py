"""Per-shard search: the body's checks, the query phase and the fetch phase
(port of `elasticsearch_tpu/search/service.py`).

The body keys served: `knn`, `query`, `aggs` (`aggregations`; computed
over the query's rows before `post_filter`, through the index's device
engine when the node passes one, else `search/aggregations.py`, or as
partial states for a search over several indices), `size`, `from`,
`_source`,
`track_total_hits`, `request_cache` (the shard request cache's
per-request opt-in or opt-out, read by the node), `post_filter`,
`min_score`, `rescore`, `sort`, `search_after`, `collapse` (with
`inner_hits` and a second-level collapse inside them), `highlight`,
`version`, `seq_no_primary_term`, `stored_fields`, `docvalue_fields`,
`script_fields` (`search/script_score.py`) and `explain`; the node reads
`rank`, `batched_reduce_size`, `profile` (`search/profile.py`) and
`suggest` (`search/extras.py`), `indices_boost` (per index score
factors) and `scroll` as the URL's (`Node.search_scroll_start`). `slice`
(`{id, max}`) keeps the rows of one slice after the query: when `max` is
at most the index's shard count a slice owns whole shards (by each
`_id`'s routing hash), else a row belongs to slice murmur3(the `_id`'s
encoded term, 7919) floorMod `max`, the hashes made once a segment.
`fields`, `track_scores`, `ext`, `stats`, `max_concurrent_shard_requests`,
`pre_filter_shard_size`, `timeout`, `terminate_after`, `pit`,
`point_in_time`, `runtime_mappings` and a body `scroll` are accepted and
change nothing, as in the reference (a response is never cut short:
`timed_out` is false; a `pit` searches the live reader, and a runtime
field reads as unmapped). Any other key is the reference's `unknown key`
parsing error.

`knn` is one spec or a list of specs (`field`, `query_vector`, `k`,
`num_candidates`, `filter`, `boost`); `query` is any query
`search/queries.py` parses, `knn` among them. Several knn specs, or knn
beside a query, combine as `bool.should` of them, as in the reference; no
query and no knn is `match_all`.

A search is a query phase (`execute_query_phase`: the query's rows, less
those `post_filter` and `min_score` drop, rescored, ranked by score or by
the sort, cut after `search_after`, collapsed, and cut to `from + size`;
the total and the max score) and a fetch (`fetch_hits`): the shard request
cache stores the first, and the fetch re-runs for every request, as in the
reference. The sort's keys are built vectorised from the doc-values
columns over every matched row; the `sort` tuples only for the window's
rows.
"""

from __future__ import annotations

import base64
import datetime as _dt
import fnmatch
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.cluster.routing import (
    murmur3_x86_32_many, murmur3_x86_32_rows, shard_ids_for,
)
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.index.mapping import (
    KeywordFieldMapper, TextFieldMapper,
)
from elasticsearch_tpu_torch.index.segment import ShardReader, numeric_view
from elasticsearch_tpu_torch.search.knn_query import KnnQuery
from elasticsearch_tpu_torch.search.queries import (
    BoolQuery, MatchAllQuery, Query, SearchContext, parse_query,
)

DEFAULT_SIZE = 10
MAX_RESULT_WINDOW = 10_000
TRACK_TOTAL_HITS_DEFAULT = 10_000
# every body key the reference knows
_SEARCH_BODY_KEYS = {
    "query", "from", "size", "sort", "track_total_hits", "track_scores",
    "aggs", "aggregations", "post_filter", "highlight", "_source", "fields",
    "docvalue_fields", "stored_fields", "script_fields", "suggest",
    "rescore", "explain", "version", "seq_no_primary_term", "min_score",
    "search_after", "collapse", "profile", "timeout", "terminate_after",
    "indices_boost", "knn", "rank", "pit", "runtime_mappings", "slice",
    "ext", "stats", "point_in_time", "batched_reduce_size",
    "pre_filter_shard_size", "scroll", "max_concurrent_shard_requests",
    "request_cache",
}
# the mapped types whose sort keys are numbers, and those of them that
# sort by their exact integer
_NUMERIC_TYPES = ("long", "integer", "short", "byte", "double", "float",
                  "half_float", "date", "date_nanos", "boolean", "ip",
                  "scaled_float")
_INTEGRAL_TYPES = ("long", "integer", "short", "byte", "date",
                   "date_nanos")
_MISSING_LAST = float("inf")
_TAG_DEFAULT = ("<em>", "</em>")


def not_ported(key: str, why: str) -> IllegalArgumentError:
    return IllegalArgumentError(
        f"[{key}] is not supported by this build: {why}")


def parse_knn(spec) -> KnnQuery:
    """One `knn` spec of a body → a KnnQuery (its filter parsed). Keys
    other than its own (`similarity`, say) are ignored, as the reference
    ignores them."""
    if not isinstance(spec, dict):
        raise ParsingError("[knn] must be an object with [field] and "
                           "[query_vector]")
    if "field" not in spec or "query_vector" not in spec:
        raise ParsingError("[knn] requires [field] and [query_vector]")
    k = int(spec.get("k", spec.get("num_candidates", 10)))
    if k < 1:
        raise IllegalArgumentError("[k] must be greater than 0")
    # the reference's KnnQuery raises num_candidates to k
    num_candidates = max(int(spec.get("num_candidates", k)), k)
    return KnnQuery(field=spec["field"], query_vector=spec["query_vector"],
                    k=k, num_candidates=num_candidates,
                    filter_query=(parse_query(spec["filter"])
                                  if spec.get("filter") else None),
                    boost=float(spec.get("boost", 1.0)))


def _body_query(body: dict) -> Query:
    """The body's query: `query`, its `knn` specs, or both as should
    clauses of one bool."""
    query = (parse_query(body["query"]) if body.get("query") is not None
             else MatchAllQuery())
    knn = body.get("knn")
    if knn is None:
        return query
    knn_queries: List[Query] = [
        parse_knn(spec) for spec in (knn if isinstance(knn, list)
                                     else [knn])]
    if body.get("query") is None:
        return knn_queries[0] if len(knn_queries) == 1 \
            else BoolQuery(should=knn_queries)
    return BoolQuery(should=[query] + knn_queries)


def check_request(body: dict, settings: dict) -> None:
    """The reference's request checks (`_check_request_limits`) before any
    work."""
    for key in body:
        if key not in _SEARCH_BODY_KEYS and not key.startswith("__"):
            # the reference keeps dunder keys for its coordinator
            raise ParsingError(
                f"unknown key [{key}] for a search request body "
                f"(SearchSourceBuilder)")
    check_track_total_hits(body)
    if body.get("collapse") is not None:
        if body.get("rescore") is not None:
            raise IllegalArgumentError(
                "cannot use `collapse` in conjunction with `rescore`")
        inner = (body["collapse"] or {}).get("inner_hits")
        inner_list = inner if isinstance(inner, list) else \
            [inner] if inner else []
        for ih in inner_list:
            # a second-level collapse inside inner_hits is legal; it may
            # not define inner_hits or a third collapse
            nested = (ih or {}).get("collapse") if isinstance(ih, dict) \
                else None
            if isinstance(nested, dict) and (
                    nested.get("inner_hits") is not None
                    or nested.get("collapse") is not None):
                raise ParsingError(
                    "parse_exception: [collapse] inner collapse cannot "
                    "define inner_hits or another collapse")
    window(body)
    max_dvf = int(settings.get("index.max_docvalue_fields_search", 100))
    if len(body.get("docvalue_fields") or []) > max_dvf:
        raise IllegalArgumentError(
            f"Trying to retrieve too many docvalue_fields. Must be less "
            f"than or equal to: [{max_dvf}] but was "
            f"[{len(body['docvalue_fields'])}]. This limit can be set by "
            f"changing the [index.max_docvalue_fields_search] index level "
            f"setting.")
    max_sf = int(settings.get("index.max_script_fields", 32))
    if len(body.get("script_fields") or {}) > max_sf:
        raise IllegalArgumentError(
            f"Trying to retrieve too many script_fields. Must be less than "
            f"or equal to: [{max_sf}] but was "
            f"[{len(body['script_fields'])}]. This limit can be set by "
            f"changing the [index.max_script_fields] index level setting.")
    rescore = body.get("rescore")
    if rescore is not None:
        max_rw = int(settings.get("index.max_rescore_window", 10_000))
        for spec in rescore if isinstance(rescore, list) else [rescore]:
            size = int(spec.get("window_size", 10))
            if size > max_rw:
                raise IllegalArgumentError(
                    f"Rescore window [{size}] is too large. It must be "
                    f"less than [{max_rw}]. This prevents allocating "
                    f"massive heaps for storing the results to be "
                    f"rescored. This limit can be set by changing the "
                    f"[index.max_rescore_window] index level setting.")


class QueryPhaseResult:
    """The query phase of one search: the window's rows and scores (ranked
    by score desc and row asc, or by the sort) cut to `from + size`, each
    row's `sort` tuple under a field sort (else None), the total counted
    to `track_total_hits` with its relation, the max score, and the rows
    the query matched before `post_filter` (the aggregations' scope), and
    the aggregations over them (final JSON or partial states; None without
    `aggs`) with the device engine's profile, and the kNN engine's phases
    (None without a kNN leg that reported any). Read-only once made, so a
    cached one serves any number of fetches."""

    __slots__ = ("rows", "scores", "sort_values", "total", "relation",
                 "max_score", "agg_rows", "aggregations", "aggs_profile",
                 "knn_phases")

    def __init__(self, rows, scores, total: int, relation: str, max_score,
                 sort_values=None, agg_rows=None):
        self.rows = rows
        self.scores = scores
        self.sort_values = sort_values
        self.total = total
        self.relation = relation
        self.max_score = max_score
        self.agg_rows = agg_rows
        self.aggregations = None
        self.aggs_profile = None
        self.knn_phases = None


def window(body: dict) -> Tuple[int, int]:
    """The body's (from, size), each checked >= 0."""
    frm = int(body.get("from", 0) or 0)
    size = int(body["size"]) if body.get("size") is not None else DEFAULT_SIZE
    if frm < 0:
        raise IllegalArgumentError("[from] parameter cannot be negative")
    if size < 0:
        raise IllegalArgumentError(
            f"[size] parameter cannot be negative, found [{size}]")
    return frm, size


def check_result_window(end: int, settings: dict) -> None:
    """from + size (or a fusion window) against the index's
    `index.max_result_window`, with the reference's message."""
    mrw = int(settings.get("index.max_result_window", MAX_RESULT_WINDOW))
    if end > mrw:
        raise IllegalArgumentError(
            f"Result window is too large, from + size must be less than or "
            f"equal to: [{mrw}] but was [{end}]. See the scroll api for a "
            f"more efficient way to request large data sets. This limit can "
            f"be set by changing the [index.max_result_window] index level "
            f"setting.")


def check_track_total_hits(body: dict) -> None:
    """`track_total_hits` is a bool, a count >= 0, or -1."""
    tth = body.get("track_total_hits")
    if isinstance(tth, int) and not isinstance(tth, bool) and tth < -1:
        raise IllegalArgumentError(
            f"[track_total_hits] parameter must be positive or equals to "
            f"-1, got {tth}")


def tracks_total(body: dict) -> bool:
    """False when the body turns hit counting off (`false` or -1): the
    response then has no `hits.total`."""
    tth = body.get("track_total_hits")
    return not (tth is False or (isinstance(tth, int)
                                 and not isinstance(tth, bool) and tth == -1))


def count_body(body: Optional[dict]) -> dict:
    """A `_count` body as its query phase runs it: size 0, no sort, every
    hit counted."""
    body = dict(body or {})
    body.pop("sort", None)
    body["size"] = 0
    body["track_total_hits"] = True
    return body


def execute_query_phase(ctx: SearchContext, body: dict, agg_engine=None,
                        partial_aggs: bool = False) -> QueryPhaseResult:
    """The body's query over the context's reader: the window [0, from +
    size) of ranked rows, their scores and sort tuples, the total and the
    max score, in the reference's order of steps; then the aggregations
    over `agg_rows`: through `agg_engine` (`search/agg_plan.py`) when
    given, its host nodes and a body with none eligible on the host path,
    as partial states when `partial_aggs`."""
    result = _query_window(ctx, body)
    result.knn_phases = ctx.knn_phases
    aggs_spec = body.get("aggs") or body.get("aggregations")
    if aggs_spec:
        from elasticsearch_tpu_torch.search import agg_partials, aggregations
        out = None
        if agg_engine is not None:
            out = agg_engine.compute(ctx, result.agg_rows, aggs_spec,
                                     partial=partial_aggs)
        if out is not None:
            result.aggregations, result.aggs_profile = out
        elif partial_aggs:
            result.aggregations = agg_partials.compute_partial_aggs(
                ctx, result.agg_rows, aggs_spec)
        else:
            result.aggregations = aggregations.compute_aggs(
                ctx, result.agg_rows, aggs_spec)
    return result


def _query_window(ctx: SearchContext, body: dict) -> QueryPhaseResult:
    settings = ctx.index_settings or {}
    check_request(body, settings)
    frm, size = window(body)
    end = frm + size
    sort_spec = normalize_sort(body.get("sort"))
    result = _body_query(body).execute(ctx).with_scores()
    rows, scores = result.rows, result.scores
    if body.get("slice") is not None:
        keep = slice_keep(ctx.reader, rows, body["slice"], settings)
        rows, scores = rows[keep], scores[keep]
    agg_rows = rows
    # a scripted_metric's map_script may read each row's `_score`
    ctx.agg_score_rows, ctx.agg_scores = rows, scores
    if body.get("post_filter") is not None:
        # hits only: the aggregations keep the query's rows
        keep = np.isin(rows, parse_query(body["post_filter"])
                       .execute(ctx).rows)
        rows, scores = rows[keep], scores[keep]
    if body.get("min_score") is not None:
        keep = scores >= float(body["min_score"])
        rows, scores = rows[keep], scores[keep]
    if body.get("rescore") is not None:
        scores = apply_rescore(ctx, rows, scores, body["rescore"])
    total, relation = len(rows), "eq"
    track = body.get("track_total_hits", TRACK_TOTAL_HITS_DEFAULT)
    if track is not True:
        limit = (TRACK_TOTAL_HITS_DEFAULT if not tracks_total(body)
                 else int(track))
        if total > limit:
            total, relation = limit, "gte"
    search_after = body.get("search_after")
    collapse = body.get("collapse")
    if collapse is not None and search_after is not None:
        raise IllegalArgumentError(
            "cannot use `collapse` in conjunction with `search_after`")
    if sort_spec is None and search_after is None and collapse is None:
        max_score = float(scores.max()) if len(scores) else None
        _check_window(body, end, settings)
        # score desc, ties by row asc (rows arrive ascending)
        order = native.topk(scores, min(end, len(rows)))
        return QueryPhaseResult(rows[order], scores[order], total, relation,
                                max_score, agg_rows=agg_rows)
    columns = sort_columns(ctx, rows, scores, sort_spec or [])
    order = sort_order(rows, scores, columns, sort_spec)
    if search_after is not None:
        if sort_spec is None:
            raise IllegalArgumentError("search_after requires a sort")
        order = order[search_after_cut(columns, rows, scores, order,
                                       search_after):]
    if collapse is not None:
        order = order[collapse_keep(ctx.reader, rows[order],
                                    collapse["field"], end)]
    # over the collapsed rows before the cut, as the reference reads it
    max_score = (float(scores[order].max())
                 if len(order) and sort_spec is None else None)
    _check_window(body, end, settings)
    order = order[:end]
    sort_values = (sort_tuples(ctx.reader, columns, rows, scores, order)
                   if sort_spec is not None else None)
    return QueryPhaseResult(rows[order], scores[order], total, relation,
                            max_score, sort_values, agg_rows)


def _check_window(body: dict, end: int, settings: dict) -> None:
    """`index.max_result_window` once the query, sort and collapse ran, as
    the reference checks it (so their errors come first); a scroll's
    snapshot takes every row."""
    if not body.get("__unbounded_window__"):
        check_result_window(end, settings)


def encode_uid(doc_id: str) -> bytes:
    """The `_id` term's bytes: a decimal id without a leading zero packs
    two digits a byte behind 0xFE, a URL-safe base64 id (length not 1
    mod 4) is its decoded bytes (0xFD first when they start at 0xFD or
    above), any other id 0xFF and its UTF-8 bytes."""
    if doc_id and doc_id.isascii() and doc_id.isdigit() \
            and (len(doc_id) == 1 or doc_id[0] != "0"):
        digits = [ord(c) - 48 for c in doc_id] + [0x0F]
        return bytes([0xFE] + [(digits[i] << 4) | digits[i + 1]
                               for i in range(0, len(doc_id), 2)])
    if doc_id and len(doc_id) % 4 != 1 \
            and re.fullmatch(r"[A-Za-z0-9_-]+", doc_id):
        try:
            raw = base64.urlsafe_b64decode(doc_id + "=" * (-len(doc_id) % 4))
            return bytes([0xFD]) + raw if raw and raw[0] >= 0xFD else raw
        except ValueError:
            pass
    return bytes([0xFF]) + doc_id.encode("utf-8")


_SLICE_SEED = 7919


def _segment_hashes(seg, kind: str, n_shards: int = 0) -> np.ndarray:
    """A sealed segment's per-doc slice hashes, made once and kept with
    it: the routing shard of each `_id` (`shards`), or murmur3 of its
    encoded term with the slice seed (`terms`)."""
    cache = seg.derived
    key = ("slice", kind, n_shards)
    if key not in cache:
        if kind == "shards":
            cache[key] = shard_ids_for(seg.ids, n_shards)
        else:
            cache[key] = term_hashes(seg.ids)
    return cache[key]


def term_hashes(ids) -> np.ndarray:
    """murmur3(encode_uid(id), 7919) of every `_id` (int64 [len(ids)]):
    decimal ids packed and hashed with numpy, a length at a time, the
    others one by one."""
    out = np.zeros(len(ids), dtype=np.int64)
    if not len(ids):
        return out
    arr = np.asarray(ids, dtype=str)
    codes = arr.view(np.uint32).reshape(len(arr), -1)
    lengths = np.char.str_len(arr)
    beyond = np.arange(codes.shape[1]) >= lengths[:, None]
    decimal = ((((codes >= 48) & (codes <= 57)) | beyond).all(axis=1)
               & (lengths > 0) & ((lengths == 1) | (codes[:, 0] != 48)))
    for length in np.unique(lengths[decimal]).tolist():
        where = np.nonzero(decimal & (lengths == length))[0]
        nib = (codes[where, :length] - 48).astype(np.uint8)
        if length % 2:
            nib = np.concatenate([nib, np.full((len(where), 1), 0x0F,
                                               dtype=np.uint8)], axis=1)
        packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
        data = np.concatenate([np.full((len(where), 1), 0xFE,
                                       dtype=np.uint8), packed], axis=1)
        out[where] = murmur3_x86_32_rows(data, _SLICE_SEED)
    other = np.nonzero(~decimal)[0]
    if len(other):
        out[other] = murmur3_x86_32_many(
            [encode_uid(str(ids[i])) for i in other.tolist()], _SLICE_SEED)
    return out


def slice_keep(reader: ShardReader, rows: np.ndarray, spec,
               settings: dict) -> np.ndarray:
    """The mask of `rows` in the slice `{id, max}`, with the reference's
    checks and messages."""
    try:
        sid = int(spec["id"])
        smax = int(spec["max"])
    except (TypeError, ValueError, AttributeError, KeyError):
        raise IllegalArgumentError(
            f"malformed slice [{spec!r}]: expected {{id, max}}")
    if smax <= 1:
        raise IllegalArgumentError("max must be greater than 1")
    max_slices = int(settings.get("index.max_slices_per_scroll", 1024))
    if smax > max_slices:
        raise IllegalArgumentError(
            f"The number of slices [{smax}] is too large. It must be "
            f"less than [{max_slices}]. This limit can be set by changing "
            f"the [index.max_slices_per_scroll] index level setting.")
    if sid < 0 or sid >= smax:
        raise IllegalArgumentError(
            f"id must be greater than or equal to 0 and less than max "
            f"({smax})")
    num_shards = int(settings.get("index.number_of_shards", 1))
    kind = "shards" if smax <= num_shards else "terms"
    vi, local = reader.locate_many(rows)
    hashes = np.zeros(len(rows), dtype=np.int64)
    for v in np.unique(vi).tolist():
        at = vi == v
        hashes[at] = _segment_hashes(reader.views[v].segment, kind,
                                     num_shards)[local[at]]
    return hashes % smax == sid


def apply_rescore(ctx: SearchContext, rows, scores, rescore_spec):
    """Each rescorer in turn over the top `window_size` rows by score: the
    query score weighted by `query_weight` combined with the rescore
    query's by `score_mode` (total, multiply, max, min, avg); a row outside
    the window keeps its weighted query score. Returns the new scores."""
    specs = rescore_spec if isinstance(rescore_spec, list) else [rescore_spec]
    for spec in specs:
        size = int(spec.get("window_size", 10))
        rq = spec.get("query", {})
        rescore_query = parse_query(rq.get("rescore_query"))
        qw = float(rq.get("query_weight", 1.0))
        rqw = float(rq.get("rescore_query_weight", 1.0))
        mode = rq.get("score_mode", "total")
        top = np.argsort(-scores, kind="stable")[:size]
        rs = rescore_query.execute(ctx).with_scores()
        idx = np.clip(np.searchsorted(rs.rows, rows[top]), 0,
                      max(len(rs.rows) - 1, 0))
        new_scores = scores * qw
        if len(rs.rows):
            hit = rs.rows[idx] == rows[top]
            second = np.where(hit, rs.scores[idx], 0.0)
            first = qw * scores[top]
            if mode == "total":
                new_scores[top] = first + rqw * second
            elif mode == "multiply":
                new_scores[top] = np.where(
                    hit, scores[top] * qw * second * rqw, first)
            elif mode == "max":
                new_scores[top] = np.maximum(first, rqw * second)
            elif mode == "min":
                new_scores[top] = np.where(
                    hit, np.minimum(first, rqw * second), first)
            elif mode == "avg":
                new_scores[top] = np.where(
                    hit, (first + rqw * second) / 2, first)
        scores = new_scores
    return scores


def normalize_sort(sort) -> Optional[List[Tuple[str, str, dict]]]:
    """[(field, order, spec)], or None for the score sort (no sort, or
    `_score` alone). A `_script` sort sorts by a field of that name, which
    no document holds, as in the reference."""
    if sort is None:
        return None
    if isinstance(sort, (str, dict)):
        sort = [sort]
    out = []
    for item in sort:
        if isinstance(item, str):
            if item == "_score":
                out.append(("_score", "desc", {}))
            elif item == "_doc":
                out.append(("_doc", "asc", {}))
            else:
                out.append((item, "asc", {}))
        elif isinstance(item, dict):
            ((field, spec),) = item.items()
            if isinstance(spec, str):
                out.append((field, spec, {}))
            else:
                out.append((field, spec.get(
                    "order", "asc" if field != "_score" else "desc"), spec))
        else:
            raise ParsingError(f"malformed sort clause {item!r}")
    if len(out) == 1 and out[0][0] == "_score":
        return None
    return out


def _first(v):
    """A multi-valued doc value's first value (None for an empty list)."""
    if isinstance(v, list):
        return v[0] if v else None
    return v


def object_values(reader: ShardReader, rows, field: str) -> np.ndarray:
    """Each row's doc value of `field` (a multi-valued doc's first; None
    when it has none), as an object array, gathered segment by segment."""
    rows = np.asarray(rows, dtype=np.int64)
    out = np.empty(len(rows), dtype=object)
    vi, local = reader.locate_many(rows)
    for v in np.unique(vi):
        col = reader.views[v].segment.doc_values.get(field)
        if col is None:
            continue
        at = np.nonzero(vi == v)[0]
        out[at] = [_first(x) for x in col.values[local[at]]]
    return out


def numeric_values(reader: ShardReader, rows,
                   field: str) -> Tuple[np.ndarray, np.ndarray]:
    """(values f64, present) of `field` over rows, as the reference's
    `numeric_values` gives them: a multi-valued doc's first value, a
    boolean as 1.0 or 0.0, a value that is not a number absent. A
    segment's numeric column is gathered directly; another one value by
    value."""
    rows = np.asarray(rows, dtype=np.int64)
    vals = np.full(len(rows), np.nan, dtype=np.float64)
    present = np.zeros(len(rows), dtype=bool)
    vi, local = reader.locate_many(rows)
    for v in np.unique(vi):
        col = reader.views[v].segment.doc_values.get(field)
        if col is None:
            continue
        at = np.nonzero(vi == v)[0]
        if col.numeric is not None:
            ok = col.present[local[at]]
            vals[at[ok]] = col.numeric[local[at[ok]]]
        else:
            v, ok = numeric_view(col.values[local[at]].tolist())
            vals[at[ok]] = v[ok]
        present[at] = ok
    return vals, present


class SortColumn:
    """One sort clause over the matched rows: its `kind` (`score`, `doc`,
    `num` or `str`), its lexsort key (f64, the order applied, missing
    placed), and what `search_after` and the sort tuples read: for `num`
    the values and presence (and `scale`, the `numeric_type` conversion:
    "to_millis" reads a date_nanos field as date, "to_nanos" a date field
    as date_nanos), for `str` the values (None when missing)."""

    __slots__ = ("field", "direction", "kind", "key", "nums", "present",
                 "integral", "strs", "scale")

    def __init__(self, field, direction, kind, key, nums=None, present=None,
                 integral=False, strs=None, scale=None):
        self.field = field
        self.direction = direction
        self.kind = kind
        self.key = key
        self.nums = nums
        self.present = present
        self.integral = integral
        self.strs = strs
        self.scale = scale

    def compare_values(self, rows, scores, idx):
        """The values `search_after` compares at positions idx: f64 with
        a missing value as +inf, or the strings (None when missing)."""
        if self.kind == "score":
            return scores[idx].astype(np.float64)
        if self.kind == "doc":
            return rows[idx].astype(np.float64)
        if self.kind == "num":
            nums = self.nums[idx]
            if self.scale == "to_millis":
                # the sort value is the integral millis, floored
                nums = np.floor(nums)
            return np.where(self.present[idx], nums, _MISSING_LAST)
        return self.strs[idx]


def sort_columns(ctx: SearchContext, rows, scores,
                 sort_spec) -> List[SortColumn]:
    """The sort clauses' columns over every matched row, built from the
    doc-values columns as the reference's `_sort_docs` builds its keys: a
    field is numeric when a row holds a number or its type is numeric (a
    missing value by `missing`: `_last`, `_first` or a number), else its
    strings sort by rank. `numeric_type: date` reads a date_nanos field in
    millis and `date_nanos` a date field in nanos, so indices of both
    types sort in one unit; any other `numeric_type` changes nothing."""
    out = []
    for field, direction, spec in sort_spec:
        asc = direction == "asc"
        if field == "_score":
            vals = scores.astype(np.float64)
            out.append(SortColumn(field, direction, "score",
                                  vals if asc else -vals))
            continue
        if field == "_doc":
            vals = rows.astype(np.float64)
            out.append(SortColumn(field, direction, "doc",
                                  vals if asc else -vals))
            continue
        mapper = ctx.mapper_service.get(field)
        tname = getattr(mapper, "type_name", None)
        read = ctx.mapper_service.resolve_field(field)   # an alias's target
        nums, present = numeric_values(ctx.reader, rows, read)
        ntype, scale = spec.get("numeric_type"), None
        if ntype == "date" and tname == "date_nanos":
            nums, scale = nums / 1e6, "to_millis"
        elif ntype == "date_nanos" and tname == "date":
            nums, scale = nums * 1e6, "to_nanos"
        if present.any() or mapper is None or tname in _NUMERIC_TYPES:
            missing = spec.get("missing", "_last")
            fill = _MISSING_LAST if (missing == "_last") == asc \
                else -_MISSING_LAST
            if isinstance(missing, (int, float)) \
                    and not isinstance(missing, bool):
                fill = float(missing)
            vals = np.where(present, nums, fill)
            out.append(SortColumn(field, direction, "num",
                                  vals if asc else -vals, nums, present,
                                  tname in _INTEGRAL_TYPES, scale=scale))
            continue
        # strings read the field as named: an alias sorts as missing, as
        # in the reference
        strs = object_values(ctx.reader, rows, field)
        has = np.asarray([s is not None for s in strs], dtype=bool)
        vals = np.full(len(rows), _MISSING_LAST if asc else -_MISSING_LAST)
        if has.any():
            uniq, inverse = np.unique(
                np.asarray([str(s) for s in strs[has]], dtype=object),
                return_inverse=True)
            vals[has] = inverse.astype(np.float64)
        out.append(SortColumn(field, direction, "str",
                              vals if asc else -vals, strs=strs))
    return out


def sort_order(rows, scores, columns: List[SortColumn],
               sort_spec) -> np.ndarray:
    """Positions of the rows in sort order: the columns' keys, then the
    row; with no sort (a collapse on the score order) score desc, row
    asc."""
    if sort_spec is None:
        return np.lexsort((rows, -scores))
    keys = [c.key for c in columns] + [rows.astype(np.float64)]
    return np.lexsort(tuple(reversed(keys)))


def sort_tuples(reader: ShardReader, columns: List[SortColumn], rows,
                scores, idx) -> List[tuple]:
    """The `sort` tuples of the rows at positions idx: a score as a float,
    a row as an int, a number as an int (the exact doc value) for the
    integral types else as a float, a string as it is, and None when
    missing."""
    per_column = []
    for c in columns:
        if c.kind == "score":
            per_column.append([float(s) for s in scores[idx]])
        elif c.kind == "doc":
            per_column.append([int(r) for r in rows[idx]])
        elif c.kind == "str":
            per_column.append(list(c.strs[idx]))
        else:
            vals = []
            for j in idx.tolist():
                if not c.present[j]:
                    vals.append(None)
                    continue
                if c.integral:
                    raw = _first(reader.get_doc_value(c.field,
                                                      int(rows[j])))
                    if isinstance(raw, (int, float)):
                        rv = int(raw)
                        if c.scale == "to_millis":
                            rv //= 1_000_000
                        elif c.scale == "to_nanos":
                            rv *= 1_000_000
                        vals.append(rv)
                        continue
                vals.append(float(c.nums[j]))
            per_column.append(vals)
    return [tuple(col[i] for col in per_column) for i in range(len(idx))]


def search_after_cut(columns: List[SortColumn], rows, scores, order,
                     after) -> int:
    """The first position of `order` strictly after the `search_after`
    values, compared clause by clause as the reference compares them: a
    missing value as +inf whatever the order, a number against a number,
    a string against a string, and any other pair (a string against a
    number, a None) as equal."""
    n = len(order)
    decided = np.zeros(n, dtype=bool)
    after_it = np.zeros(n, dtype=bool)
    for c, a in zip(columns, after):
        v = c.compare_values(rows, scores, order)
        if isinstance(a, (int, float)):
            av = float(a)
            if c.kind == "str":
                # a string never compares with a number; a missing one is
                # +inf
                missing = np.asarray([s is None for s in v], dtype=bool)
                ne = missing & (_MISSING_LAST != av)
                gt = missing & (_MISSING_LAST > av)
            else:
                ne, gt = v != av, v > av
        elif isinstance(a, str) and c.kind == "str":
            has = np.nonzero([s is not None for s in v])[0]
            ne = np.zeros(n, dtype=bool)
            gt = np.zeros(n, dtype=bool)
            ne[has] = [s != a for s in v[has]]
            gt[has] = [s > a for s in v[has]]
        else:
            continue
        d = ~decided & ne
        after_it[d] = gt[d] if c.direction == "asc" else ~gt[d]
        decided |= d
    hits = np.nonzero(after_it)[0]
    return int(hits[0]) if len(hits) else n


def group_value(reader: ShardReader, field: str, row: int):
    """A row's collapse group: its first doc value of `field`, or None."""
    return _first(reader.get_doc_value(field, int(row)))


def collapse_keep(reader: ShardReader, rows, field: str,
                  end: int) -> List[int]:
    """Positions of the best-ranked row of each group, in rank order,
    stopping once `end` groups are kept (no later row can reach the
    window). Groups are read in chunks, so a window that fills early
    reads few rows."""
    seen = set()
    keep: List[int] = []
    chunk = 1024
    for lo in range(0, len(rows), chunk):
        for j, v in enumerate(object_values(reader, rows[lo:lo + chunk],
                                            field)):
            if v in seen:
                continue
            seen.add(v)
            keep.append(lo + j)
            if len(keep) >= end:
                return keep
    return keep


# ---------------------------------------------------------------------------
# fetch phase
# ---------------------------------------------------------------------------

def source_patterns(spec) -> Tuple[List[str], List[str]]:
    """The `_source` spec's (includes, excludes): a field name or pattern,
    a list of them, or an object of `includes` / `excludes`."""
    if spec is None or isinstance(spec, bool):
        return [], []
    if isinstance(spec, str):
        return [spec], []
    if isinstance(spec, list):
        return spec, []
    if isinstance(spec, dict):
        out = []
        for key in ("includes", "excludes"):
            v = spec.get(key, spec.get(key[:-1], [])) or []
            out.append([v] if isinstance(v, str) else v)
        return out[0], out[1]
    raise ParsingError("[_source] must be a boolean, a field name, a list "
                       "of field names or an object of includes and "
                       "excludes")


def filter_source(source: dict, includes, excludes) -> dict:
    """The reference's source filter: every leaf path (objects flattened
    with dots) kept when it matches an include (a glob, or a prefix
    before a dot) and no exclude, the objects rebuilt around the kept
    leaves, so an object left empty goes."""
    if not includes and not excludes:
        return source

    def flatten(obj, prefix=""):
        for k, v in obj.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                yield from flatten(v, path + ".")
            else:
                yield path, v

    def matches(path, patterns):
        return any(fnmatch.fnmatch(path, p) or path.startswith(p + ".")
                   for p in patterns)

    out: dict = {}
    for path, v in flatten(source):
        if includes and not matches(path, includes):
            continue
        if excludes and matches(path, excludes):
            continue
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def fetch_hits(ctx: SearchContext, index_name: str, body: dict, rows, scores,
               sort_values=None, expand_inner_hits: bool = True
               ) -> List[dict]:
    """The fetch phase (the reference's `execute_fetch_phase`): one hit a
    row, in order, with `_id` and `_source` as `stored_fields` and
    `_source` allow (filtered by its includes and excludes), its `sort`
    tuple under a field sort (`_score` null), `_seq_no` / `_primary_term`,
    `_version`, stored fields, `_routing`, `_ignored`, `docvalue_fields`,
    `highlight`, the collapse group under `fields` with its `inner_hits`
    (one sub-search a hit, unless `expand_inner_hits` is off: the node
    expands them over several indices itself), each `nested` query's
    `inner_hits` and `_explanation`."""
    reader, mapper_service = ctx.reader, ctx.mapper_service
    source_spec = body.get("_source", True)
    want_source = source_spec is not False and mapper_service.source_enabled
    includes, excludes = source_patterns(source_spec)
    docvalue_fields = body.get("docvalue_fields") or []
    script_values = _script_fields(ctx, body.get("script_fields"), rows)
    highlight = body.get("highlight")
    collapse = body.get("collapse")
    sorted_ = normalize_sort(body.get("sort")) is not None
    want_id, stored = True, []
    stored_spec = body.get("stored_fields")
    if stored_spec is not None:
        # [] keeps the metadata but not `_source`; "_none_" drops both; a
        # list loads its `store: true` fields
        if stored_spec == "_none_":
            want_id = want_source = False
        else:
            stored = ([stored_spec] if isinstance(stored_spec, str)
                      else list(stored_spec))
            if "_source" not in stored:
                want_source = False
    nested_specs = nested_inner_hits_specs(body.get("query"))
    hits: List[dict] = []
    for i, row in enumerate(np.asarray(rows).tolist()):
        hit: Dict[str, Any] = {
            "_index": index_name,
            "_score": None if sorted_ else float(scores[i])}
        if want_id:
            hit["_id"] = reader.get_id(row)
        if sorted_ and sort_values is not None:
            hit["sort"] = list(sort_values[i])
        if body.get("seq_no_primary_term"):
            hit["_seq_no"] = reader.get_seq_no(row)
            pt = reader.get_doc_value("_primary_term", row)
            hit["_primary_term"] = int(pt) if pt is not None else 1
        if body.get("version"):
            v = reader.get_doc_value("_version", row)
            hit["_version"] = int(v) if v is not None else 1
        if stored:
            fields = {}
            src = reader.get_source(row) or {}
            for name in stored:
                mapper = mapper_service.get(name)
                if name.startswith("_") or mapper is None \
                        or not mapper.params.get("store"):
                    continue
                val = get_path(src, name)
                if val is not None:
                    fields[name] = val if isinstance(val, list) else [val]
            if fields:
                hit["fields"] = fields
        routing = reader.get_routing(row)
        if routing is not None:
            hit["_routing"] = routing
        ignored = reader.get_doc_value("_ignored", row)
        if ignored:
            hit["_ignored"] = sorted(ignored) if isinstance(ignored, list) \
                else [ignored]
        if want_source:
            hit["_source"] = filter_source(reader.get_source(row) or {},
                                           includes, excludes)
        if docvalue_fields:
            fields = _docvalue_fields(reader, mapper_service,
                                      docvalue_fields, row)
            if fields:
                hit.setdefault("fields", {}).update(fields)
        if script_values:
            sf = hit.setdefault("fields", {})
            for name, vals in script_values.items():
                sf[name] = [float(vals[i])]
        if highlight:
            hl = highlight_row(ctx, body, highlight, row)
            if hl:
                hit["highlight"] = hl
        if collapse:
            _decorate_collapsed_hit(ctx, index_name, body, collapse, row,
                                    hit, expand_inner_hits)
        for path, spec, query in nested_specs:
            _decorate_nested_inner_hits(reader, row, hit, path, spec, query,
                                        index_name)
        if body.get("explain"):
            hit["_explanation"] = {"value": hit["_score"] or 0.0,
                                   "description": "vectorized score",
                                   "details": []}
        hits.append(hit)
    return hits


def _script_fields(ctx: SearchContext, specs, rows) -> Dict[str, Any]:
    """Each `script_fields` entry's values over the window's rows, one
    batched evaluation a script (`_score` 0, as in the reference); none
    without rows."""
    if not specs or not len(rows):
        return {}
    from elasticsearch_tpu_torch.search.script_score import Script
    rows = np.asarray(rows, dtype=np.int64)
    zeros = np.zeros(len(rows), dtype=np.float32)
    return {name: Script(spec.get("script", spec)).evaluate(ctx, rows,
                                                            zeros)
            for name, spec in specs.items()}


def _docvalue_fields(reader: ShardReader, mapper_service, specs,
                     row: int) -> dict:
    """A row's `docvalue_fields`, each value formatted; a field named
    twice (with two formats) appends in the request's order."""
    fields: Dict[str, list] = {}
    for f in specs:
        name = f["field"] if isinstance(f, dict) else f
        fmt = f.get("format") if isinstance(f, dict) else None
        if name == "_seq_no":
            v = reader.get_seq_no(row)
        elif name == "_primary_term":
            v = 1
        else:
            v = reader.get_doc_value(name, row)
        if v is not None:
            mapper = mapper_service.get(name)
            fields.setdefault(name, []).extend(
                format_doc_value(x, mapper, fmt)
                for x in (v if isinstance(v, list) else [v]))
    return fields


def format_doc_value(v, mapper, fmt):
    """A doc value as `docvalue_fields` renders it: a `date` or
    `date_nanos` value as an ISO string (millis, or nanos with trailing
    zeros cut, for date_nanos), or under its format (`epoch_millis`,
    `strict_date_optional_time`, a nanosecond pattern, or a joda pattern
    such as `yyyy-MM-dd`); a number under a DecimalFormat pattern (`#.0`)
    formatted; anything else (an `ip` too) as it is stored."""
    tname = getattr(mapper, "type_name", None)
    if tname in ("date", "date_nanos") and isinstance(v, (int, float)):
        raw = int(v)     # nanos for date_nanos, else millis
        millis = raw // 1_000_000 if tname == "date_nanos" else raw
        if fmt == "epoch_millis":
            if tname == "date_nanos":
                return f"{raw // 1_000_000}.{raw % 1_000_000:06d}"
            return str(raw)
        if fmt and "SSSSSSSSS" in fmt:
            if tname == "date_nanos":
                return _nanos_to_iso(raw, 9)
            iso = _millis_to_iso(millis)
            return iso[:-1] + "000000Z" if iso.endswith("Z") else iso
        if fmt == "strict_date_optional_time":
            return _millis_to_iso(millis)
        if fmt:
            return _format_date_key(millis, fmt)
        if tname == "date_nanos":
            return _nanos_to_iso(raw, 9, strip=True)
        return _millis_to_iso(millis)
    if fmt and isinstance(v, (int, float)) and not isinstance(v, bool) \
            and any(c in fmt for c in "#0"):
        return _decimal_format(v, fmt)
    return v


def _nanos_to_iso(nanos: int, digits: int, strip: bool = False) -> str:
    """Epoch nanos as `yyyy-MM-ddTHH:mm:ss.fffffffffZ` (`digits` fraction
    digits; `strip` cuts trailing zeros down to two)."""
    base = _dt.datetime.fromtimestamp(nanos // 1_000_000_000,
                                      _dt.timezone.utc)
    fs = f".{nanos % 1_000_000_000:09d}"[: digits + 1]
    if strip:
        fs = fs.rstrip("0").ljust(2, "0")
    return base.strftime("%Y-%m-%dT%H:%M:%S") + fs + "Z"


def _millis_to_iso(millis: int) -> str:
    """Epoch millis as `yyyy-MM-ddTHH:mm:ss.SSSZ` (the raw number when
    out of range), read through a float of seconds as the reference
    reads it."""
    try:
        d = _dt.datetime.fromtimestamp(millis / 1000.0, tz=_dt.timezone.utc)
    except (OverflowError, OSError, ValueError):
        return str(millis)
    return d.strftime("%Y-%m-%dT%H:%M:%S.") + f"{d.microsecond // 1000:03d}Z"


def _format_date_key(millis: int, fmt: str) -> str:
    """Epoch millis under a named format (`iso8601`, `strict_date_time`,
    `date_time`, `epoch_millis`), `e` (the ISO day of the week) or a joda
    pattern of yyyy, MM, dd, HH, mm, ss and SSS, in UTC."""
    if fmt in ("iso8601", "strict_date_time", "date_time"):
        return _millis_to_iso(millis)
    if fmt == "epoch_millis":
        return str(millis)
    try:
        d = _dt.datetime.fromtimestamp(millis / 1000.0, tz=_dt.timezone.utc)
    except (OverflowError, OSError, ValueError):
        return str(millis)
    if fmt == "e":
        return str(d.isoweekday())
    strf = (fmt.replace("yyyy", "%Y").replace("MM", "%m")
            .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
            .replace("ss", "%S"))
    out = d.strftime(strf)
    if "SSS" in out:
        out = out.replace("SSS", f"{d.microsecond // 1000:03d}")
    return out


def _decimal_format(value, pattern: str) -> str:
    """Java's DecimalFormat, as far as the reference reads it: a literal
    prefix and suffix around a run of # and 0, with optional fraction
    digits ("Value is ##0.0" -> "Value is 51.0")."""
    m = re.search(r"[#0][#0,.]*", pattern)
    if not m:
        return pattern
    num = m.group(0)
    prefix, suffix = pattern[:m.start()], pattern[m.end():]
    if "." in num:
        frac = num.split(".", 1)[1]
        min_frac, max_frac = frac.count("0"), len(frac)
    else:
        min_frac = max_frac = 0
    v = float(value)
    if max_frac == 0:
        s = str(int(round(v)))
    else:
        s = f"{v:.{max_frac}f}"
        int_part, frac_part = s.split(".")
        frac_part = frac_part.rstrip("0").ljust(min_frac, "0")
        s = int_part + ("." + frac_part if frac_part else "")
    return prefix + s + suffix


def get_path(obj: dict, path: str):
    """The value at a dotted path of a source, or None."""
    node = obj
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def inner_hits_specs(collapse: dict) -> List[dict]:
    inner = collapse.get("inner_hits")
    return inner if isinstance(inner, list) else [inner] if inner else []


def inner_hits_body(body: dict, field: str, value, spec: dict,
                    size: int) -> dict:
    """The sub-search of one collapse group: the body's `query` filtered
    to the group, with the inner hits' own fetch keys."""
    sub = {"query": {"bool": {
        "must": [body["query"]] if body.get("query") else [],
        "filter": [{"term": {field: value}}]}}, "size": size}
    for key in ("sort", "version", "seq_no_primary_term",
                "docvalue_fields", "_source"):
        if spec.get(key) is not None:
            sub[key] = spec[key]
    return sub


def _decorate_collapsed_hit(ctx: SearchContext, index_name: str, body: dict,
                            collapse: dict, row: int, hit: dict,
                            expand: bool) -> None:
    """A collapsed hit's group value under `fields` and, when asked, each
    `inner_hits` spec's window: a sub-search over the group's rows (its
    `from`, `size`, `sort` and fetch keys; a second-level `collapse` reads
    ten times `size` and keeps each inner group's best hit)."""
    field = collapse["field"]
    # an alias reads its target here (the query phase groups by the field
    # as named, as the reference does)
    value = group_value(ctx.reader,
                        ctx.mapper_service.resolve_field(field), row)
    hit.setdefault("fields", {})[field] = [value]
    if not expand:
        return
    # the sub-search runs as the reference runs it: default index
    # settings, no query cache
    sub_ctx = SearchContext(ctx.reader, ctx.mapper_service, ctx.vector_store)
    for spec in inner_hits_specs(collapse):
        name = spec.get("name", field)
        sub_collapse = spec.get("collapse")
        want = int(spec.get("size", 3))
        frm = int(spec.get("from", 0))
        sub_body = inner_hits_body(body, field, value, spec,
                                   want * 10 if sub_collapse else want)
        sub_body["from"] = frm
        res = execute_query_phase(sub_ctx, sub_body)
        sub_hits = fetch_hits(
            sub_ctx, index_name, sub_body, res.rows[frm:], res.scores[frm:],
            None if res.sort_values is None else res.sort_values[frm:])
        if sub_collapse:
            inner_field = sub_collapse["field"]
            seen = set()
            deduped = []
            for h, r in zip(sub_hits, res.rows[frm:]):
                gv = group_value(ctx.reader, inner_field, r)
                h.setdefault("fields", {})[inner_field] = [gv]
                if gv in seen:
                    continue
                seen.add(gv)
                deduped.append(h)
            sub_hits = deduped[:want]
        hit.setdefault("inner_hits", {})[name] = {"hits": {
            "total": {"value": res.total, "relation": res.relation},
            "max_score": res.max_score, "hits": sub_hits}}


# ---------------------------------------------------------------------------
# highlight
# ---------------------------------------------------------------------------

def highlight_row(ctx: SearchContext, body: dict, spec: dict,
                  row: int) -> Dict[str, List[str]]:
    """The reference's highlighter: the query's terms (from `match`,
    `match_phrase`, `term`, `multi_match`, `query_string` and `bool`, a
    text field's analyzed with its search analyzer) and prefixes, or a
    field's `highlight_query`'s, wrapped in `pre_tags` / `post_tags` in
    the field's stored text. `require_field_match: false` lets any field's
    terms light up any highlighted field; `*` patterns name text and
    keyword fields. A keyword value is wrapped whole (a value over
    `ignore_above` never is); a text value is re-analyzed and each
    matching token wrapped at its offsets, so a value longer than
    `index.highlight.max_analyzed_offset` is a 400 unless the field
    indexes offsets (and the highlighter is not `plain`)."""
    mapper_service = ctx.mapper_service
    source = ctx.reader.get_source(row) or {}
    settings = ctx.index_settings or {}
    terms_of: Dict[str, set] = {}
    prefixes_of: Dict[str, set] = {}

    def field_names():
        return [p for p, _m in mapper_service.all_mappers()]

    def add_terms(into, field, text):
        mapper = mapper_service.get(field)
        if isinstance(mapper, TextFieldMapper):
            terms = mapper.search_analyzer.terms(str(text))
        else:
            terms = [str(text)]
        into.setdefault(field, set()).update(terms)

    def collect(q, terms, prefixes):
        if not isinstance(q, dict):
            return
        for kind, qspec in q.items():
            if kind in ("match", "match_phrase", "term",
                        "match_phrase_prefix"):
                if not isinstance(qspec, dict) or not qspec:
                    continue
                ((field, v),) = list(qspec.items())[:1]
                text = v.get("query", v.get("value")) \
                    if isinstance(v, dict) else v
                add_terms(terms, field, text)
            elif kind == "prefix":
                if not isinstance(qspec, dict) or not qspec:
                    continue
                ((field, v),) = list(qspec.items())[:1]
                text = v.get("value", v.get("prefix")) \
                    if isinstance(v, dict) else v
                prefixes.setdefault(field, set()).add(str(text).lower())
            elif kind == "multi_match":
                text = qspec.get("query", "")
                for f in qspec.get("fields", []):
                    pat = f.split("^")[0]
                    targets = ([pat] if "*" not in pat else
                               [n for n in field_names()
                                if fnmatch.fnmatch(n, pat)])
                    for name in targets:
                        add_terms(terms, name, text)
            elif kind == "query_string":
                f = qspec.get("default_field")
                if f and "*" not in str(f):
                    add_terms(terms, f, qspec.get("query", ""))
            elif kind == "bool":
                for clause in ("must", "should", "filter"):
                    items = qspec.get(clause, [])
                    if isinstance(items, dict):
                        items = [items]
                    for sub in items:
                        collect(sub, terms, prefixes)

    collect(body.get("query", {}), terms_of, prefixes_of)
    pre = spec.get("pre_tags", [_TAG_DEFAULT[0]])[0]
    post = spec.get("post_tags", [_TAG_DEFAULT[1]])[0]
    require_match = spec.get("require_field_match", True)
    if isinstance(require_match, str):
        require_match = require_match != "false"
    max_offset = int(settings.get("index.highlight.max_analyzed_offset",
                                  1_000_000))
    fields_spec = spec.get("fields", {})
    if isinstance(fields_spec, list):
        merged = {}
        for entry in fields_spec:
            merged.update(entry or {})
        fields_spec = merged
    expanded: Dict[str, dict] = {}
    for pattern, fspec in fields_spec.items():
        if "*" in pattern:
            for name in field_names():
                if isinstance(mapper_service.get(name),
                              (TextFieldMapper, KeywordFieldMapper)) \
                        and fnmatch.fnmatch(name, pattern):
                    expanded.setdefault(name, fspec or {})
        else:
            expanded[pattern] = fspec or {}

    out = {}
    for field, fspec in expanded.items():
        mapper = mapper_service.get(field)
        if mapper is None:
            continue
        hq = fspec.get("highlight_query")
        if hq:
            own_terms: Dict[str, set] = {}
            own_prefixes: Dict[str, set] = {}
            collect(hq, own_terms, own_prefixes)
            terms = own_terms.get(field, set())
            prefixes = own_prefixes.get(field, set())
        elif require_match:
            terms = terms_of.get(field, set())
            prefixes = prefixes_of.get(field, set())
        else:
            terms = set().union(*terms_of.values())
            prefixes = set().union(*prefixes_of.values())
        if not terms and not prefixes:
            continue
        # a multi-field highlights its parent's value
        raw = get_path(source, field)
        if raw is None and "." in field:
            raw = get_path(source, field.rsplit(".", 1)[0])
        if raw is None:
            continue

        def matches(term, terms=terms, prefixes=prefixes) -> bool:
            return term in terms or any(str(term).lower().startswith(p)
                                        for p in prefixes)

        if isinstance(mapper, KeywordFieldMapper):
            frags = []
            ignore_above = mapper.params.get("ignore_above")
            for v in raw if isinstance(raw, list) else [raw]:
                v = str(v)
                if ignore_above is not None and len(v) > int(ignore_above):
                    continue        # never indexed: nothing matched it
                if matches(v):
                    frags.append(pre + v + post)
            if frags:
                out[field] = frags
            continue
        if not isinstance(mapper, TextFieldMapper):
            continue
        text = str(raw)
        htype = fspec.get("type") or spec.get("type") or "unified"
        tv = str(mapper.params.get("term_vector", ""))
        has_offsets = "offsets" in tv or \
            mapper.params.get("index_options") == "offsets"
        if len(text) > max_offset and (htype == "plain" or not has_offsets):
            raise IllegalArgumentError(
                f"The length [{len(text)}] of field [{field}] in doc/index "
                f"has exceeded [{max_offset}] - maximum allowed to be "
                f"analyzed for highlighting. This maximum can be set by "
                f"changing the [index.highlight.max_analyzed_offset] index "
                f"level setting. For large texts, indexing with offsets or "
                f"term vectors is recommended!")
        spans = {(t.start_offset, t.end_offset)
                 for t in mapper.analyzer.analyze(text) if matches(t.term)}
        if not spans:
            continue
        frag = text
        for s0, e0 in sorted(spans, reverse=True):
            frag = frag[:s0] + pre + frag[s0:e0] + post + frag[e0:]
        out[field] = [frag]
    return out


# ---------------------------------------------------------------------------
# nested inner hits
# ---------------------------------------------------------------------------

def nested_inner_hits_specs(q) -> List[Tuple[str, dict, Any]]:
    """(path, inner_hits spec, inner query) of each `nested` query of a
    query tree that asks for inner hits."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            nested = node.get("nested")
            if isinstance(nested, dict) and "inner_hits" in nested:
                out.append((nested.get("path"), nested["inner_hits"] or {},
                            nested.get("query")))
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for item in node:
                walk(item)

    walk(q)
    return out


def nested_item_matches(item: dict, path: str, q) -> bool:
    """Whether an inner hit lists one nested object: a looser matcher than
    the `nested` query's, as the reference's. `match` is a substring test
    of the lowercased strings, `term` string equality, a `bool` its `must`
    and `filter` clauses, and any other kind (`range` among them) matches
    every object."""
    if not isinstance(q, dict) or not q:
        return True
    for kind, qspec in q.items():
        if kind == "match_all":
            return True
        if kind in ("match", "term") and isinstance(qspec, dict) and qspec:
            ((f, v),) = list(qspec.items())[:1]
            want = v.get("query", v.get("value")) if isinstance(v, dict) \
                else v
            rel = f[len(path) + 1:] if f.startswith(path + ".") else f
            cur = item
            for part in rel.split("."):
                cur = cur.get(part) if isinstance(cur, dict) else None
            if cur is None:
                return False
            if kind == "term":
                return str(cur) == str(want)
            return str(want).lower() in str(cur).lower()
        if kind == "bool" and isinstance(qspec, dict):
            for clause in ("must", "filter"):
                items = qspec.get(clause, [])
                if isinstance(items, dict):
                    items = [items]
                if not all(nested_item_matches(item, path, sub)
                           for sub in items):
                    return False
            return True
    return True


def _decorate_nested_inner_hits(reader: ShardReader, row: int, hit: dict,
                                path, spec: dict, query,
                                index_name: str) -> None:
    """A hit's nested inner hits: the objects at `path` that
    `nested_item_matches` keeps, the first `size` (3) of them, each with
    its `_nested` {field, offset}, score 1.0, `_source`, and `_version` /
    the `_seq_no` and `_primary_term` `docvalue_fields` when asked; under
    `name` (the path by default)."""
    items = reader.get_source(row) or {}
    for part in str(path or "").split("."):
        items = items.get(part) if isinstance(items, dict) else None
    if isinstance(items, dict):
        items = [items]
    if not isinstance(items, list):
        return
    name = spec.get("name", path)
    size = int(spec.get("size", 3))
    matching = [(off, item) for off, item in enumerate(items)
                if isinstance(item, dict)
                and nested_item_matches(item, str(path), query)]
    inner_hits = []
    for off, item in matching[:size]:
        ih = {"_index": index_name, "_id": hit.get("_id"),
              "_nested": {"field": path, "offset": off},
              "_score": 1.0, "_source": item}
        if spec.get("version"):
            ih["_version"] = hit.get("_version", 1)
        for df in spec.get("docvalue_fields") or []:
            fname = df["field"] if isinstance(df, dict) else df
            if fname == "_seq_no":
                sq = reader.get_seq_no(row)
                ih.setdefault("fields", {})[fname] = [
                    int(sq) if sq is not None else 0]
            elif fname == "_primary_term":
                ih.setdefault("fields", {})[fname] = [1]
        inner_hits.append(ih)
    hit.setdefault("inner_hits", {})[name] = {
        "hits": {"total": {"value": len(matching), "relation": "eq"},
                 "max_score": 1.0, "hits": inner_hits}}
