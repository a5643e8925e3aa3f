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
`ignore_unavailable` and `allow_no_indices` (`Node.resolve`); an
`expand_wildcards` other than `open` is a 400 that names it.

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
import time

from elasticsearch_tpu_torch import telemetry
from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationError, DocumentMissingError, IllegalArgumentError,
    VersionConflictError,
)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.indices.service import validate_index_name
from elasticsearch_tpu_torch.node import Node, _apply_mget_projection
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.profile import trace_profile

VERSION = "8.0.0-torch"
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


def _index_options(req) -> dict:
    """The URL's `ignore_unavailable` and `allow_no_indices`, for
    `Node.resolve`. `expand_wildcards` other than `open` (the default)
    names closed or hidden indices, which are not ported: a 400 that names
    the parameter."""
    expand = req.param("expand_wildcards")
    if expand is not None and any(t.strip() != "open"
                                  for t in expand.split(",")):
        raise IllegalArgumentError(
            f"request parameter [expand_wildcards] value [{expand}] is not "
            f"supported by this build: closed and hidden indices are not "
            f"ported")
    return {"ignore_unavailable": req.bool_param("ignore_unavailable", False),
            "allow_no_indices": req.bool_param("allow_no_indices", True)}


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
    from elasticsearch_tpu_torch.rest.actions_script import register_script
    register_script(rc, node)

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
        _apply_mget_projection(node.indices.get(req.params["index"]), resp,
                               {}, sf.split(",") if sf else None,
                               _source_filter(req))
        return (200 if resp.get("found") else 404), resp

    def get_source(req):
        resp = _get(req)
        if not resp.get("found") or "_source" not in resp:
            # a missing document, or `_source` disabled in the mapping
            return 404, {"error": f"source [{req.params['id']}] not found"}
        _apply_mget_projection(node.indices.get(req.params["index"]), resp,
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
            resp = node.search(req.params.get("index"), body,
                               pre_filter_shard_size=pfs,
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
        for svc in node.resolve(expr, **_index_options(req)):
            out[svc.name] = {
                "aliases": {},
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
                     for svc in node.resolve(req.params.get("index"),
                                             **_index_options(req))}

    def put_mapping(req):
        return 200, node.put_mapping(req.params["index"], req.json() or {})

    def get_settings(req):
        name = req.params.get("name")
        patterns = ([p.strip() for p in name.split(",")]
                    if name and name not in ("_all", "*") else None)
        flat_mode = req.bool_param("flat_settings", False)
        out = {}
        for svc in node.resolve(req.params.get("index"),
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
