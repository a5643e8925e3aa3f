"""Per-shard search: parse the body, run the query, assemble hits (port of
the served slices of `elasticsearch_tpu/search/service.py`).

The port accepts `{knn, query, size, from, _source, track_total_hits,
request_cache}` (`request_cache` is the shard request cache's
per-request opt-in or opt-out, read by the node).
`knn` is one spec or a list of specs (`field`, `query_vector`, `k`,
`num_candidates`, `filter`, `boost`); `query` is any query
`search/queries.py` parses (term-level filters, the BM25 text queries,
`bool`, the host walkers of `late_interaction`, `sparse_vector` /
`weighted_tokens` and `rank_feature`). Hits rank by (score desc, row asc)
through `native.topk`, as the reference ranks them; `_source` takes a
field, a list of fields or patterns, or `{includes, excludes}`, filtered
as the reference filters it. Several knn specs, or knn beside a query,
combine as `bool.should` of them, as in the reference; no query and no
knn is `match_all`. Any other body key is rejected with a 400. Hybrid
`rank: {rrf}` bodies go to `search/hybrid_plan.py`, which renders its hits
with `render_hits`.

A search is a query phase (`execute_query_phase`: the ranked rows and
scores of the window, the total and the max score) and a fetch
(`execute_fetch_phase`): the shard request cache stores the first, and the
fetch re-runs for every request, as in the reference.
"""

from __future__ import annotations

import fnmatch
from typing import List, Optional, Tuple

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import ShardReader
from elasticsearch_tpu_torch.search.knn_query import KnnQuery
from elasticsearch_tpu_torch.search.queries import (
    BoolQuery, MatchAllQuery, Query, SearchContext, parse_query,
)

DEFAULT_SIZE = 10
MAX_RESULT_WINDOW = 10_000
TRACK_TOTAL_HITS_DEFAULT = 10_000
_SEARCH_BODY_KEYS = {"knn", "query", "size", "from", "_source",
                     "track_total_hits", "request_cache"}
_KNN_KEYS = {"field", "query_vector", "k", "num_candidates", "filter",
             "boost"}


def parse_knn(spec) -> KnnQuery:
    """One `knn` spec of a body → a KnnQuery (its filter parsed)."""
    if not isinstance(spec, dict):
        raise ParsingError("[knn] must be an object with [field] and "
                           "[query_vector]")
    for key in spec:
        if key not in _KNN_KEYS:
            raise ParsingError(f"[knn] unknown field [{key}]")
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
    for key in body:
        if key not in _SEARCH_BODY_KEYS:
            raise ParsingError(
                f"unknown key [{key}] for a search request body "
                f"(SearchSourceBuilder)")
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


class QueryPhaseResult:
    """The query phase of one search: the window's rows and scores, ranked
    by (score desc, row asc) and cut to `from + size`, the total counted to
    `track_total_hits` with its relation, and the max score. Read-only once
    made, so a cached one serves any number of fetches."""

    __slots__ = ("rows", "scores", "total", "relation", "max_score")

    def __init__(self, rows, scores, total: int, relation: str, max_score):
        self.rows = rows
        self.scores = scores
        self.total = total
        self.relation = relation
        self.max_score = max_score


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


def execute_query_phase(ctx: SearchContext, body: dict) -> QueryPhaseResult:
    """The body's query over the context's reader: ranked rows and scores
    of [0, from + size), the total and the max score."""
    check_track_total_hits(body)
    frm, size = window(body)
    check_result_window(frm + size, ctx.index_settings or {})
    result = _body_query(body).execute(ctx).with_scores()
    rows, scores = result.rows, result.scores
    total, relation = len(rows), "eq"
    track = body.get("track_total_hits", TRACK_TOTAL_HITS_DEFAULT)
    if track is not True:
        limit = (TRACK_TOTAL_HITS_DEFAULT if not tracks_total(body)
                 else int(track))
        if total > limit:
            total, relation = limit, "gte"
    max_score = float(scores.max()) if len(scores) else None
    # score desc, ties by row asc (rows arrive ascending)
    order = native.topk(scores, min(frm + size, len(rows)))
    return QueryPhaseResult(rows[order], scores[order], total, relation,
                            max_score)


def execute_fetch_phase(reader: ShardReader, mapper_service: MapperService,
                        index_name: str, body: dict,
                        result: QueryPhaseResult) -> dict:
    """The `hits` section of a query phase's result: the rows of
    [from, from + size) rendered from `reader`."""
    frm, size = window(body)
    hits = render_hits(reader, mapper_service, index_name,
                       result.rows[frm:frm + size],
                       result.scores[frm:frm + size], body.get("_source"))
    return {"total": {"value": result.total, "relation": result.relation},
            "max_score": result.max_score, "hits": hits}


def render_hits(reader: ShardReader, mapper_service: MapperService,
                index_name: str, rows, scores, source_spec) -> List[dict]:
    """The fetch phase: one hit per row, in order, with its `_source` when
    the body and the mapping allow it, filtered by the body's `_source`
    includes and excludes."""
    want_source = source_spec is not False and mapper_service.source_enabled
    includes, excludes = source_patterns(source_spec)
    hits: List[dict] = []
    for row, score in zip(rows, scores):
        hit = {"_index": index_name, "_id": reader.get_id(int(row)),
               "_score": float(score)}
        routing = reader.get_routing(int(row))
        if routing is not None:
            hit["_routing"] = routing
        if want_source:
            hit["_source"] = filter_source(reader.get_source(int(row)),
                                           includes, excludes)
        hits.append(hit)
    return hits


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
