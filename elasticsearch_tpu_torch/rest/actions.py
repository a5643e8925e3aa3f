"""REST handlers of the served slices (port of a subset of
`elasticsearch_tpu/rest/actions.py`), with the reference's statuses.

Documents: PUT|POST /{index}/_doc/{id} and PUT|POST /{index}/_create/{id}
(`op_type`, `routing`, `refresh` with `wait_for`, `if_seq_no`,
`if_primary_term`, `version`, `version_type`), POST /{index}/_doc (auto id,
201), GET /{index}/_doc/{id} and GET /{index}/_source/{id} (`_source`,
`_source_includes`, `_source_excludes`, `stored_fields`, `realtime`,
`refresh`, `version`), DELETE /{index}/_doc/{id} (404 `not_found` when
missing), POST /{index}/_update/{id}, [/{index}]/_bulk (index, create,
update, delete) and [/{index}]/_mget.

Search: GET|POST [/{index}]/_search over an index expression (none,
`_all`, a list, `*` patterns; URL `from`, `size`, `track_total_hits`,
`_source*`, `sort` (`f:desc`), `docvalue_fields`, `seq_no_primary_term`,
`version`, `request_cache`, `pre_filter_shard_size`,
`rest_total_hits_as_int`, `typed_keys`, `ignore_unavailable`,
`allow_no_indices`), [/{index}]/_count and [/{index}]/_msearch (with
`typed_keys`). The URL `q` of `_search` and `_count` is a
`query_string` query (`apply_uri_query`: `df`, `default_operator`,
`lenient`, `analyzer`, `analyze_wildcard`), and a 400 beside a body
query. `scroll` starts a scroll (a 400 with `size` 0, `request_cache`,
`track_total_hits: false`, a `collapse` or a keep-alive past the node
setting `search.max_keep_alive`); GET|POST /_search/scroll[/{scroll_id}]
pages it (`scroll_id` and `scroll` in the body or the URL,
`rest_total_hits_as_int`) and DELETE /_search/scroll[/{scroll_id}] frees
it (`_all`; a 404 when nothing is freed). POST /{index}/_pit
(`keep_alive`) and DELETE /_pit open and close a point in time. Stored
scripts and search templates: `rest/actions_script.py`.

Indices: PUT, DELETE, GET and HEAD /{index}, GET [/{index}]/_mapping and
PUT|POST /{index}/_mapping, GET [/{index}]/_settings[/{name}],
[/{index}]/_refresh, POST [/{index}]/_forcemerge (`only_expunge_deletes`
with `max_num_segments` is a 400), POST [/{index}]/_cache/clear and
GET [/{index}]/_stats/{metric} (`query_cache`, `request_cache`).
`_search`, `DELETE` and `GET /{index}`, `_mapping` and `_settings` read
`ignore_unavailable` and `allow_no_indices` (`Node.resolve`), and
`expand_wildcards` `open`, `closed` or `none` (`GET /{index}` and
`_mapping` pick open and closed indices by it, `_search` refuses a
closed one it names); `all` and `hidden` name hidden indices, a 400 that
names the parameter and its ROADMAP.md item.

Aliases, health, nodes and cat (`register_cluster`): [/{index}]/_analyze,
POST /_aliases, GET|HEAD [/{index}]/_alias[/{name}], PUT|POST|DELETE
/{index}/_alias[es]/{name}, GET /_cluster/health[/{index}] (`level`,
`expand_wildcards`, the `wait_for_*` parameters answered at once, a 408
when not met), GET /_nodes[/{selector or metrics}[/{metrics}]]
(`flat_settings`), GET /_cat/indices|health|shards|aliases (the
`rest/cat.py` renderer; store sizes are the shards' device bytes), and
POST /{index}/_close and /{index}/_open. POST [/{index}]/_flush and
GET /_nodes/stats are 400s that name their ROADMAP.md items. The node
features' other routes are in `rest/actions_extra.py`.

Telemetry: every search, count, msearch and write handler runs under
`telemetry.rest_request` (a live task, and a trace when sampled, forced by
`?trace=true` or, for a search, by a `profile` body), with the request's
`X-Opaque-ID` header on both; a profiled search's response gains
`profile.trace`. GET /_tasks (`actions`, `group_by`: nodes, parents,
none), GET /_tasks/{task_id}, POST /_tasks/{task_id}/_cancel and
POST /_tasks/_cancel (`actions`); GET /_nodes/traces (`size`) and
GET /_nodes/stats/telemetry. The reference's URL metric list of
`_nodes/stats` does not name `telemetry` (it reaches the section only in
the whole `GET _nodes/stats`); the port serves this one metric, and each
other one is a 400 that names it.

Every response takes `filter_path` (`rest/controller.py`).
"""

from __future__ import annotations

import difflib
import fnmatch
import re
import time

from elasticsearch_tpu_torch import telemetry
from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationError, DocumentMissingError, IllegalArgumentError,
    IndexNotFoundError, VersionConflictError,
)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.indices.service import validate_index_name
from elasticsearch_tpu_torch.node import (
    VERSION, Node, _apply_mget_projection,
)
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.profile import trace_profile

# the reference's `_nodes/stats/{metric}` names, and the one served here
_NODE_STATS_METRICS = (
    "indices", "os", "process", "jvm", "thread_pool", "fs", "transport",
    "http", "breaker", "breakers", "script", "discovery", "ingest",
    "adaptive_selection", "indexing_pressure", "_all")
_PORTED_NODE_STATS = "telemetry"

_SETTINGS_DEFAULTS = {
    "index.refresh_interval": "1s",
    "index.max_result_window": "10000",
    "index.max_inner_result_window": "100",
    "index.max_rescore_window": "10000",
    "index.flush_after_merge": "512mb",
    "index.translog.durability": "request",
    "index.translog.flush_threshold_size": "512mb",
    "index.write.wait_for_active_shards": "1",
    "index.highlight.max_analyzed_offset": "1000000",
}


def _rest_telemetry(req, node, action: str, force_trace: bool = False,
                    description: str = "", parse_nanos: int = 0):
    """One request's telemetry: a live task (`GET _tasks`, the batcher's
    cancellation token), a trace when sampled or forced (`?trace=true`),
    and the `X-Opaque-ID` header on both."""
    return telemetry.rest_request(
        node, action, opaque_id=req.headers.get("x-opaque-id"),
        force_trace=force_trace or req.bool_param("trace"),
        description=description, parse_nanos=parse_nanos)


def apply_uri_query(req, body: dict) -> dict:
    """The URL `q` as the body's `query_string` query (with `df`,
    `default_operator`, `lenient`, `analyzer` and `analyze_wildcard`); a
    400 when the body has a query too."""
    q = req.param("q")
    if not q:
        return body
    if "query" in body:
        raise IllegalArgumentError(
            "cannot specify both [q] parameter and a request body query")
    qs = {"query": q}
    if req.param("df"):
        qs["default_field"] = req.param("df")
    if req.param("default_operator"):
        qs["default_operator"] = req.param("default_operator")
    if req.param("lenient") is not None:
        qs["lenient"] = req.bool_param("lenient", False)
    if req.param("analyzer"):
        qs["analyzer"] = req.param("analyzer")
    if req.param("analyze_wildcard") is not None:
        qs["analyze_wildcard"] = req.bool_param("analyze_wildcard", False)
    body["query"] = {"query_string": qs}
    return body


def _expand_wildcards(req):
    """The URL's `expand_wildcards` as (open, closed), or None when absent.
    `open`, `closed` and `none` are served; `all` and `hidden` name hidden
    indices, which are not ported (ROADMAP.md queue 1 item 16): a 400 that
    names the parameter."""
    expand = req.param("expand_wildcards")
    if expand is None:
        return None
    tokens = {t.strip() for t in str(expand).split(",") if t.strip()}
    if tokens - {"open", "closed", "none"}:
        raise IllegalArgumentError(
            f"request parameter [expand_wildcards] value [{expand}] is not "
            f"supported by this build: hidden indices are not ported "
            f"(ROADMAP.md queue 1 item 16)")
    return "open" in tokens or not tokens, "closed" in tokens


def _index_options(req) -> dict:
    """The URL's `ignore_unavailable` and `allow_no_indices`, for
    `Node.resolve`, with `expand_wildcards` checked (`_expand_wildcards`)."""
    _expand_wildcards(req)
    return {"ignore_unavailable": req.bool_param("ignore_unavailable", False),
            "allow_no_indices": req.bool_param("allow_no_indices", True)}


def _info_options(req) -> dict:
    """`_index_options` for the index-info APIs (`Node.resolve_info`):
    `expand_wildcards` picks open and closed indices for patterns (open
    by default)."""
    expand = _expand_wildcards(req) or (True, False)
    return {**_index_options(req), "expand_open": expand[0],
            "expand_closed": expand[1]}


def _source_filter(req):
    """The URL's `_source`, `_source_includes` and `_source_excludes` as one
    source spec (None when none is given)."""
    src = req.param("_source")
    inc, exc = req.param("_source_includes"), req.param("_source_excludes")
    spec = None
    if src is not None and src.lower() in ("true", "false"):
        spec = src.lower() == "true"
    elif src:
        spec = src.split(",")
    if inc or exc:
        spec = {"includes": inc.split(",") if inc else [],
                "excludes": exc.split(",") if exc else []}
    return spec


def check_scroll_keep_alive(node, value) -> None:
    """A scroll keep-alive against the node setting
    `search.max_keep_alive` (none by default)."""
    mka = node.settings.get("search.max_keep_alive")
    if not value or mka is None:
        return
    if parse_time_value(str(value), "scroll") > \
            parse_time_value(str(mka), "max_keep_alive"):
        raise IllegalArgumentError(
            f"Keep alive for scroll ({value}) is too large. It must be "
            f"less than ({mka}). This limit can be set by changing the "
            f"[search.max_keep_alive] cluster level setting.")


def _total_hits_as_int(resp) -> None:
    """`rest_total_hits_as_int`: `hits.total` as a plain number (-1 with
    counting off)."""
    hits = resp.get("hits") if isinstance(resp, dict) else None
    if hits is None:
        return
    total = hits.get("total")
    hits["total"] = (total.get("value") if isinstance(total, dict)
                     else -1 if total is None else total)


# the mapped types whose terms aggregation is `lterms` under typed_keys
_LTERMS_TYPES = {"long", "integer", "short", "byte", "double", "float",
                 "half_float", "scaled_float", "date", "boolean"}


def _apply_typed_keys(node, resp: dict, body: dict) -> None:
    """`typed_keys`: each aggregation's name prefixed with its internal
    type (`avg#name`, `sterms#name`), so a client can parse the response
    by type. A terms aggregation's prefix comes from the first index of
    the node mapping its field, else from its keys."""

    def type_prefix(kind, spec, result):
        if kind == "terms":
            field = spec.get("field") if isinstance(spec, dict) else None
            for svc in node.indices.values():
                mapper = svc.mapper_service.get(field) if field else None
                if mapper is not None:
                    return ("lterms" if mapper.type_name in _LTERMS_TYPES
                            else "sterms")
            buckets = result.get("buckets") or []
            numeric = buckets and all(
                isinstance(b.get("key"), (int, float))
                and not isinstance(b.get("key"), bool) for b in buckets)
            return "lterms" if numeric else "sterms"
        if kind == "percentiles":
            return "hdr_percentiles" if isinstance(spec, dict) \
                and spec.get("hdr") is not None else "tdigest_percentiles"
        if kind == "significant_terms":
            field = spec.get("field") if isinstance(spec, dict) else None
            for svc in node.indices.values():
                mapper = svc.mapper_service.get(field) if field else None
                if mapper is not None:
                    return ("siglterms" if mapper.type_name in _LTERMS_TYPES
                            else "sigsterms")
            return "sigsterms"
        if kind == "significant_text":
            return "sigsterms"
        if kind == "percentile_ranks":
            return "tdigest_percentile_ranks"
        if kind in ("max_bucket", "min_bucket"):
            return "bucket_metric_value"
        return kind

    def walk(aggs_out, aggs_spec):
        """A renamed copy (the node's cached results stay as they are)."""
        if not isinstance(aggs_out, dict) or not aggs_spec:
            return aggs_out
        out = dict(aggs_out)
        for name, spec in aggs_spec.items():
            if name not in out or not isinstance(spec, dict):
                continue
            kinds = [k for k in spec
                     if k not in ("aggs", "aggregations", "meta")]
            if len(kinds) != 1:
                continue
            result = out.pop(name)
            prefix = type_prefix(kinds[0], spec[kinds[0]], result)
            sub = spec.get("aggs") or spec.get("aggregations")
            if sub and isinstance(result, dict):
                result = dict(result)
                buckets = result.get("buckets")
                if isinstance(buckets, dict):   # named filters buckets
                    result["buckets"] = {k: walk(b, sub)
                                         for k, b in buckets.items()}
                elif isinstance(buckets, list):
                    result["buckets"] = [walk(b, sub) for b in buckets]
                result = walk(result, sub)
            out[f"{prefix}#{name}"] = result
        return out

    if isinstance(resp.get("aggregations"), dict):
        resp["aggregations"] = walk(
            resp["aggregations"],
            body.get("aggs") or body.get("aggregations") or {})


def _settings_str(v):
    """A setting's value as `_settings` renders it."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return [_settings_str(x) for x in v]
    return str(v)


def _nest(flat: dict) -> dict:
    nested: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = nested
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return nested


def _index_settings(svc) -> dict:
    """An index's flat settings with its uuid, name and creation date."""
    return {"index.uuid": svc.uuid, "index.provided_name": svc.name,
            "index.creation_date": str(svc.creation_date), **svc.settings}


def register_all(rc: RestController, node: Node) -> None:
    from elasticsearch_tpu_torch.rest.actions_extra import register_extra
    from elasticsearch_tpu_torch.rest.actions_script import register_script
    register_script(rc, node)
    register_extra(rc, node)
    register_cluster(rc, node)

    def root(req):
        import torch
        return 200, {
            "name": node.node_name, "cluster_name": node.cluster_name,
            "cluster_uuid": node.node_id,
            "version": {"number": VERSION, "build_flavor": "torch",
                        "lucene_version": "none",
                        "torch": torch.__version__,
                        "device": str(node.device)},
            "tagline": "You Know, for Search",
        }

    # -------------------------------------------------------------- documents
    def _write_params(req) -> dict:
        return dict(refresh=req.param("refresh"),
                    routing=req.param("routing"),
                    if_seq_no=req.int_param("if_seq_no"),
                    if_primary_term=req.int_param("if_primary_term"),
                    version=req.int_param("version"),
                    version_type=req.param("version_type", "internal"))

    def _write_task(req, action: str):
        return _rest_telemetry(req, node, action,
                               description=f"[{req.params['index']}]")

    def put_doc(req):
        with _write_task(req, "indices:data/write/index"):
            resp = node.index_doc(req.params["index"], req.params["id"],
                                  req.json() or {},
                                  op_type=req.param("op_type", "index"),
                                  **_write_params(req))
            return (201 if resp["result"] == "created" else 200), resp

    def post_doc_auto_id(req):
        with _write_task(req, "indices:data/write/index"):
            return 201, node.index_doc(req.params["index"], None,
                                       req.json() or {},
                                       refresh=req.param("refresh"),
                                       routing=req.param("routing"))

    def create_doc(req):
        if req.param("version_type") in ("external", "external_gte"):
            raise ActionRequestValidationError(
                "Validation Failed: 1: create operations only support "
                "internal versioning. use index instead;")
        with _write_task(req, "indices:data/write/index"):
            return 201, node.index_doc(req.params["index"], req.params["id"],
                                       req.json() or {}, op_type="create",
                                       refresh=req.param("refresh"),
                                       routing=req.param("routing"))

    def _get(req) -> dict:
        if req.bool_param("refresh", False):
            node.refresh(req.params["index"])
        return node.get_doc(req.params["index"], req.params["id"],
                            routing=req.param("routing"),
                            realtime=req.bool_param("realtime", True))

    def get_doc(req):
        resp = _get(req)
        v = req.int_param("version")
        if v is not None and resp.get("found") and resp["_version"] != v:
            raise VersionConflictError(
                f"[{req.params['id']}]: version conflict, current version "
                f"[{resp['_version']}] is different than the one provided "
                f"[{v}]")
        sf = req.param("stored_fields")
        _apply_mget_projection(node.indices.get(resp["_index"]), resp,
                               {}, sf.split(",") if sf else None,
                               _source_filter(req))
        return (200 if resp.get("found") else 404), resp

    def get_source(req):
        resp = _get(req)
        if not resp.get("found") or "_source" not in resp:
            # a missing document, or `_source` disabled in the mapping
            return 404, {"error": f"source [{req.params['id']}] not found"}
        _apply_mget_projection(node.indices.get(resp["_index"]), resp,
                               {}, None, _source_filter(req))
        return 200, resp.get("_source")

    def delete_doc(req):
        with _write_task(req, "indices:data/write/delete"):
            try:
                return 200, node.delete_doc(req.params["index"],
                                            req.params["id"],
                                            **_write_params(req))
            except DocumentMissingError:
                return 404, {"_index": req.params["index"],
                             "_id": req.params["id"], "result": "not_found"}

    def update_doc(req):
        with _write_task(req, "indices:data/write/update"):
            return 200, node.update_doc(
                req.params["index"], req.params["id"], req.json() or {},
                refresh=req.param("refresh"), routing=req.param("routing"),
                if_seq_no=req.int_param("if_seq_no"),
                if_primary_term=req.int_param("if_primary_term"),
                source_filter=_source_filter(req))

    def bulk(req):
        t_parse = time.perf_counter_ns()
        ops = req.ndjson()
        parse_nanos = time.perf_counter_ns() - t_parse
        with _rest_telemetry(req, node, "indices:data/write/bulk",
                             description=f"requests[{len(ops)}]",
                             parse_nanos=parse_nanos):
            t0 = time.perf_counter_ns()
            resp = node.bulk(ops, default_index=req.params.get("index"),
                             refresh=req.param("refresh"),
                             source_filter=_source_filter(req))
            telemetry.record_span("bulk.execute",
                                  time.perf_counter_ns() - t0, ops=len(ops))
            return 200, resp

    def mget(req):
        sf = req.param("stored_fields")
        return 200, node.mget(
            req.json() or {}, req.params.get("index"),
            stored_fields=sf.split(",") if sf else None,
            realtime=req.param("realtime") not in ("false", False),
            refresh=req.param("refresh") in ("true", "", True),
            source_filter=_source_filter(req))

    # ----------------------------------------------------------------- search
    def search(req):
        t_parse = time.perf_counter_ns()
        body = req.json() or {}
        parse_nanos = time.perf_counter_ns() - t_parse
        with _rest_telemetry(
                req, node, "indices:data/read/search",
                force_trace=bool(body.get("profile")),
                description=f"indices[{req.params.get('index') or '_all'}]",
                parse_nanos=parse_nanos) as tr:
            status, resp = _search(req, body)
            if tr is not None and isinstance(resp, dict) \
                    and body.get("profile"):
                resp.setdefault("profile", {})["trace"] = trace_profile(tr)
            return status, resp

    def _search(req, body):
        body = apply_uri_query(req, body)
        for p in ("size", "from"):
            v = req.int_param(p)
            if v is not None:
                body[p] = v
        tth = req.param("track_total_hits")
        if tth is not None:
            body["track_total_hits"] = (True if tth in ("true", "") else
                                        False if tth == "false" else int(tth))
        src = _source_filter(req)
        if src is not None:
            body["_source"] = src
        sort = req.param("sort")
        if sort:
            # `f:desc` is {f: desc}, a bare name its default order
            body["sort"] = [{s.split(":")[0]: s.split(":")[1]}
                            if ":" in s else s for s in sort.split(",")]
        if req.param("docvalue_fields"):
            body["docvalue_fields"] = req.param("docvalue_fields").split(",")
        for p in ("seq_no_primary_term", "version"):
            if req.bool_param(p, False):
                body[p] = True
        pfs = req.int_param("pre_filter_shard_size")
        if pfs is not None and pfs < 1:
            raise IllegalArgumentError("preFilterShardSize must be >= 1")
        tt = body.get("track_total_hits")
        as_int = req.bool_param("rest_total_hits_as_int", False)
        if as_int and isinstance(tt, int) and not isinstance(tt, bool) \
                and tt != -1:
            raise IllegalArgumentError(
                f"[rest_total_hits_as_int] cannot be used if the tracking "
                f"of total hits is not accurate, got {tt}")
        scroll = req.param("scroll")
        if scroll:
            if body.get("size") == 0:
                raise IllegalArgumentError(
                    "[size] cannot be [0] in a scroll context")
            if req.param("request_cache") is not None:
                raise IllegalArgumentError(
                    "[request_cache] cannot be used in a scroll context")
            if body.get("track_total_hits") is False:
                raise IllegalArgumentError(
                    "disabling [track_total_hits] is not allowed in a "
                    "scroll context")
            check_scroll_keep_alive(node, scroll)
            resp = node.search_scroll_start(req.params.get("index"), body,
                                            keep_alive=scroll)
        else:
            if req.param("request_cache") is not None:
                # the URL form of the body's `request_cache`
                body["request_cache"] = req.bool_param("request_cache",
                                                       True)
            expand = _expand_wildcards(req)
            resp = node.search(req.params.get("index"), body,
                               pre_filter_shard_size=pfs,
                               expand_closed=bool(expand and expand[1]),
                               **_index_options(req))
        if as_int:
            _total_hits_as_int(resp)
        if req.bool_param("typed_keys", False):
            _apply_typed_keys(node, resp, body)
        return 200, resp

    def count(req):
        body = apply_uri_query(req, req.json() or {})
        with _rest_telemetry(
                req, node, "indices:data/read/count",
                description=f"indices[{req.params.get('index') or '_all'}]"):
            return 200, node.count(req.params.get("index"), body)

    def msearch(req):
        lines = req.ndjson()
        with _rest_telemetry(req, node, "indices:data/read/msearch",
                             description=f"requests[{len(lines) // 2}]"):
            return _msearch(req, lines)

    def _msearch(req, lines):
        as_int = req.bool_param("rest_total_hits_as_int", False)
        if as_int:
            for i in range(1, len(lines), 2):
                tth = (lines[i] or {}).get("track_total_hits")
                if isinstance(tth, int) and not isinstance(tth, bool):
                    raise IllegalArgumentError(
                        "[rest_total_hits_as_int] cannot be used if the "
                        f"tracking of total hits is not accurate, got {tth}")
        resp = node.msearch(lines)
        typed = req.bool_param("typed_keys", False)
        for i, r in enumerate(resp["responses"]):
            if as_int:
                _total_hits_as_int(r)
            if typed and 2 * i + 1 < len(lines):
                _apply_typed_keys(node, r, lines[2 * i + 1] or {})
        return 200, resp

    # ---------------------------------------------------------------- indices
    def create_index(req):
        return 200, node.create_index(req.params["index"], req.json())

    def delete_index(req):
        return 200, node.delete_index(req.params["index"],
                                      **_index_options(req))

    def get_index(req):
        expr = req.params["index"]
        for part in expr.split(","):
            part = part.strip()
            if part.startswith("_") and part != "_all":
                # a reserved name is a request error, not a missing index
                validate_index_name(part)
        out = {}
        for svc in node.resolve_info(expr, **_info_options(req)):
            out[svc.name] = {
                "aliases": svc.aliases,
                "mappings": svc.mapper_service.to_dict(),
                "settings": {"index": {
                    k.replace("index.", "", 1): v
                    for k, v in _index_settings(svc).items()}},
            }
        return 200, out

    def index_exists(req):
        return (200 if node.index_exists(req.params["index"]) else 404), None

    def get_mapping(req):
        return 200, {svc.name: {"mappings": svc.mapper_service.to_dict()}
                     for svc in node.resolve_info(req.params.get("index"),
                                                  **_info_options(req))}

    def put_mapping(req):
        return 200, node.put_mapping(req.params["index"], req.json() or {})

    def get_settings(req):
        name = req.params.get("name")
        patterns = ([p.strip() for p in name.split(",")]
                    if name and name not in ("_all", "*") else None)
        flat_mode = req.bool_param("flat_settings", False)
        out = {}
        for svc in node.resolve(req.params.get("index"), forbid_closed=False,
                                **_index_options(req)):
            flat = _index_settings(svc)
            if patterns is not None:
                flat = {k: v for k, v in flat.items()
                        if any(fnmatch.fnmatch(k, p) for p in patterns)}
            flat = {k: _settings_str(v) for k, v in flat.items()
                    if v is not None}
            entry = {"settings": flat if flat_mode else {"index": _nest(
                {k.replace("index.", "", 1): v for k, v in flat.items()})}}
            if req.bool_param("include_defaults", False):
                defaults = {k: v for k, v in _SETTINGS_DEFAULTS.items()
                            if k not in flat}
                entry["defaults"] = defaults if flat_mode else _nest(defaults)
            out[svc.name] = entry
        return 200, out

    def refresh(req):
        return 200, node.refresh(req.params.get("index"))

    def forcemerge(req):
        if req.param("only_expunge_deletes") in ("true", "", True) \
                and req.param("max_num_segments") is not None:
            raise ActionRequestValidationError(
                "Validation Failed: 1: cannot set only_expunge_deletes and "
                "max_num_segments at the same time, those two parameters "
                "are mutually exclusive;")
        return 200, node.force_merge(req.params.get("index"))

    def clear_cache(req):
        return 200, node.clear_cache(req.params.get("index"))

    def stats(req):
        metrics = [m.strip() for m in req.params["metric"].split(",")
                   if m.strip()]
        return 200, node.index_stats(req.params.get("index"), metrics)

    # -------------------------------------------------------------- telemetry
    def list_tasks(req):
        actions = req.param("actions")
        group_by = req.param("group_by") or "nodes"
        out = node.tasks_list_api(actions)
        # the list request itself runs as a task and carries the caller's
        # X-Opaque-Id, as in the reference
        self_action = "cluster:monitor/tasks/lists"
        if actions is None or any(
                fnmatch.fnmatchcase(self_action, p.strip())
                for p in str(actions).split(",") if p.strip()):
            opaque = req.headers.get("x-opaque-id")
            out["nodes"].setdefault(node.node_id, {}).setdefault(
                "tasks", {})[f"{node.node_id}:0"] = {
                "node": node.node_id, "id": 0, "type": "transport",
                "action": self_action,
                "start_time_in_millis": int(time.time() * 1000),
                "running_time_in_nanos": 1, "cancellable": False,
                "headers": {"X-Opaque-Id": opaque} if opaque else {}}
        if group_by == "none":
            return 200, {"tasks": [t for sec in out["nodes"].values()
                                   for t in sec.get("tasks", {}).values()]}
        if group_by == "parents":
            return 200, {"tasks": {tid: t for sec in out["nodes"].values()
                                   for tid, t in sec.get("tasks",
                                                         {}).items()}}
        return 200, out

    def get_task(req):
        return 200, node.task_get_api(req.params["task_id"])

    def cancel_task(req):
        return 200, node.task_cancel_api(req.params["task_id"])

    def cancel_tasks(req):
        return 200, node.tasks_cancel_all_api(req.param("actions"))

    def node_traces(req):
        return 200, node.traces_api(limit=req.int_param("size", 50))

    def node_stats(req):
        metrics = [m.strip() for m in req.params["metrics"].split(",")
                   if m.strip()]
        for m in metrics:
            if m == _PORTED_NODE_STATS:
                continue
            if m in _NODE_STATS_METRICS:
                raise IllegalArgumentError(
                    f"[_nodes/stats/{m}] is not supported by this build: "
                    f"only [{_PORTED_NODE_STATS}] is ported")
            hint = difflib.get_close_matches(
                m, _NODE_STATS_METRICS + (_PORTED_NODE_STATS,), n=1)
            suffix = f" -> did you mean [{hint[0]}]?" if hint else ""
            raise IllegalArgumentError(
                f"request [/_nodes/stats/{','.join(metrics)}] contains "
                f"unrecognized metric: [{m}]{suffix}")
        return 200, node.telemetry_stats_api()

    rc.register("GET", "/", root)
    # documents
    rc.register("PUT", "/{index}/_doc/{id}", put_doc)
    rc.register("POST", "/{index}/_doc/{id}", put_doc)
    rc.register("POST", "/{index}/_doc", post_doc_auto_id)
    rc.register("PUT", "/{index}/_create/{id}", create_doc)
    rc.register("POST", "/{index}/_create/{id}", create_doc)
    # no HEAD route: the controller's HEAD answers through GET
    rc.register("GET", "/{index}/_doc/{id}", get_doc)
    rc.register("GET", "/{index}/_source/{id}", get_source)
    rc.register("DELETE", "/{index}/_doc/{id}", delete_doc)
    rc.register("POST", "/{index}/_update/{id}", update_doc)
    rc.register("POST", "/_bulk", bulk)
    rc.register("PUT", "/_bulk", bulk)
    rc.register("POST", "/{index}/_bulk", bulk)
    rc.register("PUT", "/{index}/_bulk", bulk)
    for path in ("/_mget", "/{index}/_mget"):
        rc.register("GET", path, mget)
        rc.register("POST", path, mget)
    # search
    # ----------------------------------------------- scroll, point in time
    def scroll_next(req):
        body = req.json() or {}
        # the body's id wins over the path's and the URL's
        scroll_id = body.get("scroll_id") or req.param("scroll_id")
        if not scroll_id:
            raise IllegalArgumentError("scroll_id is required")
        keep = body.get("scroll") or req.param("scroll")
        check_scroll_keep_alive(node, keep)
        resp = node.search_scroll_next(scroll_id, keep)
        if req.bool_param("rest_total_hits_as_int", False):
            total = resp.get("hits", {}).get("total")
            if isinstance(total, dict):
                resp["hits"]["total"] = total.get("value")
        return 200, resp

    def scroll_delete(req):
        body = req.json() or {}
        ids = body.get("scroll_id", [])
        if isinstance(ids, str):
            ids = [ids]
        if not ids and req.params.get("scroll_id"):
            ids = req.params["scroll_id"].split(",")
        if body.get("scroll_id") == "_all" or req.path.endswith("/_all") \
                or "_all" in ids:
            freed = node.clear_all_scrolls()["num_freed"]
        else:
            freed = sum(node.clear_scroll(sid)["num_freed"] for sid in ids)
        if not freed and ids and "_all" not in ids:
            # nothing freed: the ids were unknown or expired
            return 404, {"succeeded": True, "num_freed": 0}
        return 200, {"succeeded": True, "num_freed": freed}

    for method in ("GET", "POST"):
        rc.register(method, "/_search/scroll", scroll_next)
        rc.register(method, "/_search/scroll/{scroll_id}", scroll_next)
    rc.register("DELETE", "/_search/scroll", scroll_delete)
    rc.register("DELETE", "/_search/scroll/{scroll_id}", scroll_delete)

    def open_pit(req):
        return 200, node.open_point_in_time(req.params["index"],
                                            req.param("keep_alive", "5m"))

    def close_pit(req):
        return 200, node.close_point_in_time((req.json() or {}).get("id"))

    rc.register("POST", "/{index}/_pit", open_pit)
    rc.register("DELETE", "/_pit", close_pit)

    for path in ("/_search", "/{index}/_search"):
        rc.register("GET", path, search)
        rc.register("POST", path, search)
    for path in ("/_count", "/{index}/_count"):
        rc.register("GET", path, count)
        rc.register("POST", path, count)
    rc.register("GET", "/_msearch", msearch)
    rc.register("POST", "/_msearch", msearch)
    rc.register("POST", "/{index}/_msearch", msearch)
    # indices
    rc.register("PUT", "/{index}", create_index)
    rc.register("DELETE", "/{index}", delete_index)
    rc.register("GET", "/{index}", get_index)
    rc.register("HEAD", "/{index}", index_exists)
    rc.register("GET", "/_mapping", get_mapping)
    rc.register("GET", "/{index}/_mapping", get_mapping)
    rc.register("PUT", "/{index}/_mapping", put_mapping)
    rc.register("POST", "/{index}/_mapping", put_mapping)
    for path in ("/_settings", "/{index}/_settings", "/_settings/{name}",
                 "/{index}/_settings/{name}"):
        rc.register("GET", path, get_settings)
    rc.register("POST", "/_refresh", refresh)
    rc.register("POST", "/{index}/_refresh", refresh)
    rc.register("POST", "/_forcemerge", forcemerge)
    rc.register("POST", "/{index}/_forcemerge", forcemerge)
    rc.register("GET", "/{index}/_refresh", refresh)
    rc.register("POST", "/_cache/clear", clear_cache)
    rc.register("POST", "/{index}/_cache/clear", clear_cache)
    rc.register("GET", "/_stats/{metric}", stats)
    rc.register("GET", "/{index}/_stats/{metric}", stats)
    # telemetry
    rc.register("GET", "/_tasks", list_tasks)
    rc.register("GET", "/_tasks/{task_id}", get_task)
    rc.register("POST", "/_tasks/{task_id}/_cancel", cancel_task)
    rc.register("POST", "/_tasks/_cancel", cancel_tasks)
    rc.register("GET", "/_nodes/traces", node_traces)
    rc.register("GET", "/_nodes/stats/{metrics}", node_stats)


# the metrics of `GET /_nodes/{metrics}`, and the keys every node section
# keeps whatever the metrics
_NODES_INFO_METRICS = {"settings", "os", "process", "jvm", "thread_pool",
                       "transport", "http", "plugins", "ingest",
                       "aggregations", "indices", "_all"}
_INFO_BASE_KEYS = {"name", "roles", "transport_address", "host", "ip",
                   "version", "build_flavor", "build_type", "build_hash",
                   "attributes"}


def _split_alias_patterns(patterns):
    """Alias name patterns as (includes, excludes): `-pat` excludes when a
    wildcard include came before it or it is a wildcard itself, else it
    is a literal name."""
    includes, excludes = [], []
    seen_wildcard = False
    for p in patterns:
        if p.startswith("-") and (seen_wildcard or "*" in p):
            excludes.append(p[1:])
            if "*" in p:
                seen_wildcard = True
            continue
        includes.append(p)
        if "*" in p or p == "_all":
            seen_wildcard = True
    return includes, excludes


def _alias_matches(alias: str, patterns) -> bool:
    includes, excludes = _split_alias_patterns(patterns)
    if not any(p in ("_all", "*") or fnmatch.fnmatch(alias, p)
               for p in includes):
        return False
    return not any(p in ("_all", "*") or fnmatch.fnmatch(alias, p)
                   for p in excludes)


def _missing_aliases(patterns, found) -> list:
    includes, _ = _split_alias_patterns(patterns)
    return [p for p in includes
            if "*" not in p and p != "_all" and p not in found]


def _alias_missing_response(missing, extra=None):
    label = "alias" if len(missing) == 1 else "aliases"
    return 404, {"error": f"{label} [{','.join(sorted(missing))}] missing",
                 "status": 404, **(extra or {})}


def _live_docs(engine) -> int:
    """A shard's live documents, unrefreshed writes included."""
    return sum(1 for v in list(engine.version_map.values()) if not v.deleted)


def _store_bytes(shard) -> int:
    """A shard's store size: the bytes of its device corpora (the port
    keeps no files)."""
    return int(shard.vector_store.segment_stats().get("bytes", 0))


def register_cluster(rc: RestController, node: Node) -> None:
    """`_analyze`, the alias routes, `_cluster/health`, `GET /_nodes`, the
    cat tables and `_close` / `_open`."""
    from elasticsearch_tpu_torch.rest.cat import (
        Bytes, Col, Millis, fmt_iso_millis, render as cat_render,
    )

    def analyze(req):
        return 200, node.analyze(req.json() or {},
                                 index=req.params.get("index"))

    for path in ("/_analyze", "/{index}/_analyze"):
        rc.register("GET", path, analyze)
        rc.register("POST", path, analyze)

    # ------------------------------------------------------------- aliases
    def aliases_post(req):
        return 200, node.update_aliases((req.json() or {}).get("actions",
                                                               []))

    def get_aliases(req):
        """GET [/{index}]/_alias[/{name}]: names filter (lists, wildcards,
        `_all`, `-` exclusions); a concrete name found in none of the
        indices asked for is a 404 `alias [x] missing`."""
        name = req.params.get("alias")
        patterns = [p.strip() for p in name.split(",")] if name else None
        tokens = {t.strip() for t in
                  str(req.param("expand_wildcards") or "all").split(",")
                  if t}
        want_open = bool(tokens & {"open", "all"})
        want_closed = bool(tokens & {"closed", "all"})
        resolved = [s for s in node.resolve(req.params.get("index"),
                                            expand_closed=want_closed,
                                            forbid_closed=False)
                    if (want_closed if s.closed else want_open)]

        def shown(spec):
            spec = dict(spec or {})
            routing = spec.pop("routing", None)
            if routing is not None:
                spec.setdefault("index_routing", routing)
                spec.setdefault("search_routing", routing)
            return spec

        out = {}
        for svc in resolved:
            if patterns is None:
                out[svc.name] = {"aliases": {a: shown(s) for a, s in
                                             svc.aliases.items()}}
                continue
            matched = {a: shown(spec) for a, spec in svc.aliases.items()
                       if _alias_matches(a, patterns)}
            if matched:
                out[svc.name] = {"aliases": matched}
        if patterns:
            scope = {a for svc in resolved for a in svc.aliases}
            missing = _missing_aliases(patterns, scope)
            if missing:
                return _alias_missing_response(missing, out)
        return 200, out

    def alias_exists(req):
        return (200 if get_aliases(req)[0] == 200 else 404), None

    def put_alias(req):
        alias = req.params["alias"]
        if any(c in '#\\/*?"<>| ,:' for c in alias) \
                or alias.startswith(("-", "_", "+")):
            raise IllegalArgumentError(
                f"Invalid alias name [{alias}]: must be lowercase and must "
                f"not contain spaces, commas, or special characters")
        if alias in node.indices:
            raise IllegalArgumentError(
                f"Invalid alias name [{alias}]: an index or data stream "
                f"exists with the same name as the alias")
        body = req.json() or {}
        spec = {k: v for k, v in body.items()
                if k in ("filter", "routing", "index_routing",
                         "search_routing", "is_write_index", "is_hidden")}
        targets = node.resolve(req.params["index"], forbid_closed=False)
        if not targets:
            raise IndexNotFoundError(req.params["index"])
        node.update_aliases([{"add": {"index": svc.name, "alias": alias,
                                      **spec}} for svc in targets])
        return 200, {"acknowledged": True}

    def delete_alias(req):
        """DELETE /{index}/_alias/{name}: names and indices take lists and
        wildcards; a missing concrete name is a 404 with nothing
        removed."""
        patterns = [p.strip() for p in req.params["alias"].split(",")]
        targets = node.resolve(req.params["index"], forbid_closed=False)
        if not targets:
            raise IndexNotFoundError(req.params["index"])
        removals = [(svc.name, a) for svc in targets
                    for a in list(svc.aliases) if _alias_matches(a, patterns)]
        missing = _missing_aliases(patterns, {a for _, a in removals})
        if missing:
            return _alias_missing_response(missing)
        node.update_aliases([{"remove": {"index": i, "alias": a}}
                             for i, a in removals])
        return 200, {"acknowledged": True}

    rc.register("POST", "/_aliases", aliases_post)
    for path in ("/_alias", "/{index}/_alias", "/_alias/{alias}",
                 "/{index}/_alias/{alias}"):
        rc.register("GET", path, get_aliases)
        rc.register("HEAD", path, alias_exists)
    for path in ("/{index}/_alias/{alias}", "/{index}/_aliases/{alias}"):
        rc.register("PUT", path, put_alias)
        rc.register("POST", path, put_alias)
        rc.register("DELETE", path, delete_alias)

    # ---------------------------------------------------- health and nodes
    def cluster_health(req):
        """The `wait_for_*` parameters answer at once: a single node's
        state either meets them now or never will within the request, and
        a target not met is a 408 with `timed_out`."""
        out = node.cluster_health(
            req.params.get("index"), level=req.param("level", "cluster"),
            expand_wildcards=req.param("expand_wildcards") or "all")
        timed_out = bool(out.get("timed_out"))
        want = req.param("wait_for_status")
        order = {"green": 0, "yellow": 1, "red": 2}
        if want and order.get(out["status"], 2) > order.get(want, 0):
            timed_out = True
        wn = req.param("wait_for_nodes")
        m = re.fullmatch(r"(>=|<=|>|<|==|eq\()?\s*(\d+)\)?", str(wn)) \
            if wn else None
        if m:
            n, have = int(m.group(2)), out["number_of_nodes"]
            if not {">=": have >= n, "<=": have <= n, ">": have > n,
                    "<": have < n, "==": have == n,
                    "eq(": have == n}[m.group(1) or ">="]:
                timed_out = True
        was = req.param("wait_for_active_shards")
        if was and was != "all" and int(was) > out["active_shards"]:
            timed_out = True
        if timed_out:
            out["timed_out"] = True
            return 408, out
        return 200, out

    def nodes_info(req):
        """/_nodes[/{selector or metrics}[/{metrics}]]: a lone segment is
        metrics when every part of it names one, else a node selector,
        which names this node whatever it says."""
        seg = req.params.get("seg")
        metrics_seg = req.params.get("metrics")
        metrics = []
        if metrics_seg is not None:
            metrics = [m for m in str(metrics_seg).split(",") if m]
            if metrics == ["stats"]:
                return nodes_stats_refused(req)
            for m in metrics:
                if m not in _NODES_INFO_METRICS:
                    raise IllegalArgumentError(
                        f"request [/_nodes/{seg}/{metrics_seg}] contains "
                        f"unrecognized metric: [{m}]")
        elif seg is not None:
            parts = [p for p in str(seg).split(",") if p]
            if parts and all(p in _NODES_INFO_METRICS for p in parts):
                metrics = parts
        info = node.nodes_info_api()
        if metrics and "_all" not in metrics:
            keep = set(metrics)
            info["nodes"] = {
                nid: {k: v for k, v in sec.items()
                      if k in keep or k in _INFO_BASE_KEYS}
                for nid, sec in info["nodes"].items()}
        if req.bool_param("flat_settings", False):
            def flatten(obj, prefix=""):
                out = {}
                for k, v in obj.items():
                    if isinstance(v, dict):
                        out.update(flatten(v, f"{prefix}{k}."))
                    else:
                        out[f"{prefix}{k}"] = _settings_str(v)
                return out
            for sec in info["nodes"].values():
                if isinstance(sec.get("settings"), dict):
                    sec["settings"] = flatten(sec["settings"])
        return 200, info

    def nodes_stats_refused(req):
        raise IllegalArgumentError(
            f"[{req.path}] is not supported by this build: only "
            f"[_nodes/stats/{_PORTED_NODE_STATS}] is ported (ROADMAP.md "
            f"queue 1 item 14)")

    rc.register("GET", "/_cluster/health", cluster_health)
    rc.register("GET", "/_cluster/health/{index}", cluster_health)
    rc.register("GET", "/_nodes", nodes_info)
    rc.register("GET", "/_nodes/{seg}", nodes_info)
    rc.register("GET", "/_nodes/{seg}/{metrics}", nodes_info)
    rc.register("GET", "/_nodes/stats", nodes_stats_refused)

    # ----------------------------------------------------------------- cat
    def index_health(svc) -> str:
        return "yellow" if svc.num_replicas > 0 else "green"

    indices_cols = [
        Col("health", "h", "current health status"),
        Col("status", "s", "open/close status"),
        Col("index", "i,idx", "index name"),
        Col("uuid", "id,uuid", "index uuid"),
        Col("pri", "p,shards.primary,shardsPrimary",
            "number of primary shards", right=True),
        Col("rep", "r,shards.replica,shardsReplica",
            "number of replica shards", right=True),
        Col("docs.count", "dc,docsCount", "available docs", right=True),
        Col("docs.deleted", "dd,docsDeleted", "deleted docs", right=True),
        Col("creation.date", "cd", "index creation date (millis)",
            right=True, default=False),
        Col("creation.date.string", "cds", "index creation date (ISO)",
            default=False),
        Col("store.size", "ss,storeSize",
            "store size of primaries and replicas", right=True),
        Col("pri.store.size", "", "store size of primaries", right=True),
    ]

    def cat_indices(req):
        _expand_wildcards(req)
        health_filter = req.param("health")
        expr = req.params.get("index")
        rows = []
        for svc in node.resolve(expr, forbid_closed=False):
            health = index_health(svc)
            if health_filter and health != health_filter:
                continue
            sb = sum(_store_bytes(s) for s in svc.shards)
            rows.append([health, "close" if svc.closed else "open",
                         svc.name, svc.uuid, svc.num_shards,
                         svc.num_replicas,
                         sum(_live_docs(s.engine) for s in svc.shards), 0,
                         svc.creation_date,
                         fmt_iso_millis(svc.creation_date),
                         Bytes(sb), Bytes(sb)])
        # patterns skip closed indices: list those the expression names
        emitted = {r[2] for r in rows}
        for name, svc in list(node.indices.items()):
            if not svc.closed or name in emitted:
                continue
            if expr in (None, "", "_all", "*") or any(
                    fnmatch.fnmatch(name, p.strip())
                    for p in (expr or "*").split(",")):
                health = index_health(svc)
                if health_filter and health != health_filter:
                    continue
                rows.append([health, "close", name, svc.uuid,
                             svc.num_shards, svc.num_replicas, None, None,
                             svc.creation_date,
                             fmt_iso_millis(svc.creation_date), None, None])
        rows.sort(key=lambda r: r[2])
        return cat_render(req, indices_cols, rows)

    health_cols = [
        Col("epoch", "t,time", "seconds since 1970-01-01 00:00:00",
            right=True),
        Col("timestamp", "ts,hms,hhmmss", "time in HH:MM:SS"),
        Col("cluster", "cl", "cluster name"),
        Col("status", "st", "health status"),
        Col("node.total", "nt,nodeTotal", "total number of nodes",
            right=True),
        Col("node.data", "nd,nodeData",
            "number of nodes that can store data", right=True),
        Col("shards", "t,sh,shards.total,shardsTotal",
            "total number of shards", right=True),
        Col("pri", "p,shards.primary,shardsPrimary",
            "number of primary shards", right=True),
        Col("relo", "r,shards.relocating,shardsRelocating",
            "number of relocating nodes", right=True),
        Col("init", "i,shards.initializing,shardsInitializing",
            "number of initializing nodes", right=True),
        Col("unassign", "u,shards.unassigned,shardsUnassigned",
            "number of unassigned shards", right=True),
        Col("pending_tasks", "pt,pendingTasks", "number of pending tasks",
            right=True),
        Col("max_task_wait_time", "mtwt,maxTaskWaitTime",
            "wait time of longest task pending"),
        Col("active_shards_percent", "asp,activeShardsPercent",
            "active number of shards in percent", right=True),
    ]

    def cat_health(req):
        h = node.cluster_health()
        cols = health_cols
        if req.param("ts") in ("false", False):
            cols = health_cols[2:]
        row = [h["cluster_name"], h["status"], h["number_of_nodes"],
               h["number_of_data_nodes"], h["active_shards"],
               h["active_primary_shards"], h["relocating_shards"],
               h["initializing_shards"], h["unassigned_shards"],
               h["number_of_pending_tasks"], "-",
               f"{h['active_shards_percent_as_number']:.1f}%"]
        if cols is health_cols:
            row = [int(time.time()),
                   time.strftime("%H:%M:%S", time.gmtime())] + row
        return cat_render(req, cols, [row])

    shards_cols = [
        Col("index", "i,idx", "index name"),
        Col("shard", "s,sh", "shard name", right=True),
        Col("prirep", "p,pr,primaryOrReplica", "primary or replica"),
        Col("state", "st", "shard state"),
        Col("docs", "d,dc", "number of docs in shard", right=True),
        Col("store", "sto", "store size of shard", right=True),
        Col("ip", "", "ip of node where it lives"),
        Col("id", "", "unique id of node where it lives", default=False),
        Col("node", "n", "name of node where it lives"),
    ] + [Col(n, a, d, right=r, default=False) for (n, a, d, r) in (
        ("sync_id", "", "sync id", False),
        ("unassigned.reason", "ur", "reason shard became unassigned", False),
        ("unassigned.at", "ua", "time shard became unassigned", False),
        ("unassigned.for", "uf", "time has been unassigned", True),
        ("unassigned.details", "ud",
         "additional details as to why the shard became unassigned", False),
        ("recoverysource.type", "rs", "recovery source type", False),
        ("completion.size", "cs,completionSize", "size of completion", True),
        ("fielddata.memory_size", "fm,fielddataMemory",
         "used fielddata cache", True),
        ("fielddata.evictions", "fe,fielddataEvictions",
         "fielddata evictions", True),
        ("query_cache.memory_size", "qcm,queryCacheMemory",
         "used query cache", True),
        ("query_cache.evictions", "qce,queryCacheEvictions",
         "query cache evictions", True),
        ("flush.total", "ft,flushTotal", "number of flushes", True),
        ("flush.total_time", "ftt,flushTotalTime", "time spent in flush",
         True),
        ("get.current", "gc,getCurrent", "number of current get ops", True),
        ("get.time", "gti,getTime", "time spent in get", True),
        ("get.total", "gto,getTotal", "number of get ops", True),
        ("get.exists_time", "geti,getExistsTime",
         "time spent in successful gets", True),
        ("get.exists_total", "geto,getExistsTotal",
         "number of successful gets", True),
        ("get.missing_time", "gmti,getMissingTime",
         "time spent in failed gets", True),
        ("get.missing_total", "gmto,getMissingTotal",
         "number of failed gets", True),
        ("indexing.delete_current", "idc,indexingDeleteCurrent",
         "number of current deletions", True),
        ("indexing.delete_time", "idti,indexingDeleteTime",
         "time spent in deletions", True),
        ("indexing.delete_total", "idto,indexingDeleteTotal",
         "number of delete ops", True),
        ("indexing.index_current", "iic,indexingIndexCurrent",
         "number of current indexing ops", True),
        ("indexing.index_time", "iiti,indexingIndexTime",
         "time spent in indexing", True),
        ("indexing.index_total", "iito,indexingIndexTotal",
         "number of indexing ops", True),
        ("indexing.index_failed", "iif,indexingIndexFailed",
         "number of failed indexing ops", True),
        ("merges.current", "mc,mergesCurrent", "number of current merges",
         True),
        ("merges.current_docs", "mcd,mergesCurrentDocs",
         "number of current merging docs", True),
        ("merges.current_size", "mcs,mergesCurrentSize",
         "size of current merges", True),
        ("merges.total", "mt,mergesTotal", "number of completed merge ops",
         True),
        ("merges.total_docs", "mtd,mergesTotalDocs", "docs merged", True),
        ("merges.total_size", "mts,mergesTotalSize", "size merged", True),
        ("merges.total_time", "mtt,mergesTotalTime",
         "time spent in merges", True),
        ("refresh.total", "rto,refreshTotal", "total refreshes", True),
        ("refresh.time", "rti,refreshTime", "time spent in refreshes",
         True),
        ("refresh.external_total", "rto,refreshTotal",
         "total external refreshes", True),
        ("refresh.external_time", "rti,refreshTime",
         "time spent in external refreshes", True),
        ("refresh.listeners", "rli,refreshListeners",
         "number of pending refresh listeners", True),
        ("search.fetch_current", "sfc,searchFetchCurrent",
         "current fetch phase ops", True),
        ("search.fetch_time", "sfti,searchFetchTime",
         "time spent in fetch phase", True),
        ("search.fetch_total", "sfto,searchFetchTotal", "total fetch ops",
         True),
        ("search.open_contexts", "so,searchOpenContexts",
         "open search contexts", True),
        ("search.query_current", "sqc,searchQueryCurrent",
         "current query phase ops", True),
        ("search.query_time", "sqti,searchQueryTime",
         "time spent in query phase", True),
        ("search.query_total", "sqto,searchQueryTotal",
         "total query phase ops", True),
        ("search.scroll_current", "scc,searchScrollCurrent",
         "open scroll contexts", True),
        ("search.scroll_time", "scti,searchScrollTime",
         "time scroll contexts held open", True),
        ("search.scroll_total", "scto,searchScrollTotal",
         "completed scroll contexts", True),
        ("segments.count", "sc,segmentsCount", "number of segments", True),
        ("segments.memory", "sm,segmentsMemory",
         "memory used by segments", True),
        ("segments.index_writer_memory", "siwm,segmentsIndexWriterMemory",
         "memory used by index writer", True),
        ("segments.version_map_memory", "svmm,segmentsVersionMapMemory",
         "memory used by version map", True),
        ("segments.fixed_bitset_memory", "sfbm,fixedBitsetMemory",
         "memory used by fixed bit sets", True),
        ("seq_no.max", "sqm,maxSeqNo", "max sequence number", True),
        ("seq_no.local_checkpoint", "sql,localCheckpoint",
         "local checkpoint", True),
        ("seq_no.global_checkpoint", "sqg,globalCheckpoint",
         "global checkpoint", True),
        ("warmer.current", "wc,warmerCurrent", "current warmer ops", True),
        ("warmer.total", "wto,warmerTotal", "total warmer ops", True),
        ("warmer.total_time", "wtt,warmerTotalTime",
         "time spent in warmers", True),
        ("path.data", "pd,dataPath", "shard data path", False),
        ("path.state", "ps,statsPath", "shard state path", False))]

    def cat_shards(req):
        rows = []
        for svc in node.resolve(req.params.get("index"),
                                forbid_closed=False):
            for shard in svc.shards:
                ckpt = shard.engine._next_seq_no - 1
                by_name = {
                    "recoverysource.type": "EXISTING_STORE",
                    "segments.count": len(shard.engine.segments),
                    "indexing.index_total": ckpt + 1,
                    "seq_no.max": ckpt, "seq_no.local_checkpoint": ckpt,
                    "seq_no.global_checkpoint": ckpt,
                    "path.data": None, "path.state": None,
                    "sync_id": None, "unassigned.reason": None,
                    "unassigned.at": None, "unassigned.for": None,
                    "unassigned.details": None}
                extras = []
                for c in shards_cols[9:]:
                    if c.name in by_name:
                        extras.append(by_name[c.name])
                    elif c.name.endswith(("_time", ".time")):
                        extras.append(Millis(0))
                    elif c.name.endswith(("size", "memory")):
                        extras.append(Bytes(0))
                    else:
                        extras.append(0)
                rows.append([svc.name, shard.shard_id, "p", "STARTED",
                             _live_docs(shard.engine),
                             Bytes(_store_bytes(shard)), "127.0.0.1",
                             node.node_id, node.node_name] + extras)
                for _ in range(svc.num_replicas):
                    rows.append([svc.name, shard.shard_id, "r",
                                 "UNASSIGNED"]
                                + [None] * (len(shards_cols) - 4))
        return cat_render(req, shards_cols, rows)

    aliases_cols = [
        Col("alias", "a", "alias name"),
        Col("index", "i,idx", "index alias points to"),
        Col("filter", "f,fi", "filter"),
        Col("routing.index", "ri,routingIndex", "index routing"),
        Col("routing.search", "rs,routingSearch", "search routing"),
        Col("is_write_index", "w,isWriteIndex", "write index"),
    ]

    def cat_aliases(req):
        _expand_wildcards(req)
        name_filter = req.params.get("name")
        rows = []
        for name, svc in sorted(node.indices.items()):
            for alias, opts in svc.aliases.items():
                if name_filter and not any(
                        fnmatch.fnmatch(alias, p.strip())
                        for p in name_filter.split(",")):
                    continue
                opts = opts or {}
                routing = opts.get("routing")
                rows.append([
                    alias, name, "*" if opts.get("filter") else "-",
                    opts.get("index_routing") or routing or "-",
                    opts.get("search_routing") or routing or "-",
                    str(opts["is_write_index"]).lower()
                    if opts.get("is_write_index") is not None else "-"])
        return cat_render(req, aliases_cols, rows)

    rc.register("GET", "/_cat/indices", cat_indices)
    rc.register("GET", "/_cat/indices/{index}", cat_indices)
    rc.register("GET", "/_cat/health", cat_health)
    rc.register("GET", "/_cat/shards", cat_shards)
    rc.register("GET", "/_cat/shards/{index}", cat_shards)
    rc.register("GET", "/_cat/aliases", cat_aliases)
    rc.register("GET", "/_cat/aliases/{name}", cat_aliases)

    # --------------------------------------------------------- open / close
    def close_index(req):
        names = [s.name for s in node.resolve(req.params["index"],
                                              forbid_closed=False)]
        if not names and "*" not in req.params["index"]:
            raise IndexNotFoundError(req.params["index"])
        for name in names:
            node.close_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "indices": {n: {"closed": True} for n in names}}

    def open_index(req):
        """Patterns match closed indices too; each part resolves on its
        own."""
        names = []
        for part in req.params["index"].split(","):
            part = part.strip()
            if not part:
                continue
            if "*" in part or part == "_all":
                pat = "*" if part == "_all" else part
                names.extend(n for n in list(node.indices)
                             if fnmatch.fnmatch(n, pat))
            elif part in node.indices:
                names.append(part)
            else:
                raise IndexNotFoundError(part)
        if not names:
            raise IndexNotFoundError(req.params["index"])
        for name in dict.fromkeys(names):
            node.open_index(name)
        return 200, {"acknowledged": True, "shards_acknowledged": True}

    rc.register("POST", "/{index}/_close", close_index)
    rc.register("POST", "/{index}/_open", open_index)

    def flush_refused(req):
        raise IllegalArgumentError(
            f"[{req.path}] is not supported by this build: the port keeps "
            f"no translog to flush (ROADMAP.md queue 1 item 9)")

    rc.register("POST", "/_flush", flush_refused)
    rc.register("POST", "/{index}/_flush", flush_refused)
