"""REST handlers of the node features (port of the routes of
`elasticsearch_tpu/rest/actions_extra.py`, `actions_admin.py`,
`actions_conf.py` and `actions_xpack.py` that the port serves).

POST [/{index}]/_async_search (`wait_for_completion_timeout`), GET and
DELETE /_async_search/{id}; POST /_reindex, POST /{index}/_update_by_query
and /{index}/_delete_by_query; [/{index}]/_field_caps (`fields` in the URL
or the body, `include_unmapped`); /{index}/_validate/query (`explain`,
the URL `q`); /{index}/_explain/{id} (the URL `q`, `_source`,
`_source_includes`, `_source_excludes`); /{index}/_termvectors[/{id}]
(`realtime`, `term_statistics`); [/{index}]/_search_shards (the shards a
search reaches, each index's matching aliases and their filters over the
murmur3 placement of `cluster/routing.py`); PUT [/{index}]/_settings
(dynamic settings, `preserve_existing`, `ignore_unavailable`).
"""

from __future__ import annotations

import fnmatch

from elasticsearch_tpu_torch.common.errors import SearchEngineError
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.indices.service import flat_settings
from elasticsearch_tpu_torch.node_admin import (
    delete_by_query, explain_doc, field_caps, reindex, update_by_query,
    validate_query,
)


def _normalize_filter(f):
    """A `term` filter in its object form with its boost, as the
    reference renders an alias filter."""
    if not isinstance(f, dict) or not isinstance(f.get("term"), dict):
        return f
    return {"term": {field: ({"boost": 1.0, **v} if isinstance(v, dict)
                             else {"value": v, "boost": 1.0})
                     for field, v in f["term"].items()}}


def _matches_csv(name: str, expr: str) -> bool:
    if expr in ("", "_all", "*"):
        return True
    return any(fnmatch.fnmatch(name, p.strip()) for p in expr.split(","))


def register_extra(rc, node) -> None:
    from elasticsearch_tpu_torch.rest.actions import apply_uri_query

    # ---------------------------------------------------------- async search
    def async_submit(req):
        body = req.json() or {}
        index = req.params.get("index")
        wait = parse_time_value(
            req.param("wait_for_completion_timeout", "1s"), "wait")
        return 200, node.async_search.submit(
            lambda: node.search(index, body), wait_for_completion_s=wait)

    def async_get(req):
        return 200, node.async_search.status(req.params["id"])

    def async_delete(req):
        ok = node.async_search.delete(req.params["id"])
        return (200 if ok else 404), {"acknowledged": ok}

    rc.register("POST", "/_async_search", async_submit)
    rc.register("POST", "/{index}/_async_search", async_submit)
    rc.register("GET", "/_async_search/{id}", async_get)
    rc.register("DELETE", "/_async_search/{id}", async_delete)

    # --------------------------------------------------------- reindex family
    rc.register("POST", "/_reindex",
                lambda req: (200, reindex(node, req.json() or {})))
    rc.register("POST", "/{index}/_update_by_query",
                lambda req: (200, update_by_query(node, req.params["index"],
                                                  req.json())))
    rc.register("POST", "/{index}/_delete_by_query",
                lambda req: (200, delete_by_query(node, req.params["index"],
                                                  req.json() or {})))

    # ------------------------------------------ field caps, validate, explain
    def do_field_caps(req):
        body = req.json() or {}
        fields = req.param("fields") or ",".join(body.get("fields", ["*"]))
        return 200, field_caps(
            node, req.params.get("index"), fields,
            include_unmapped=req.param("include_unmapped") in ("true", "",
                                                               True))

    for path in ("/_field_caps", "/{index}/_field_caps"):
        rc.register("GET", path, do_field_caps)
        rc.register("POST", path, do_field_caps)

    def do_validate(req):
        explain = str(req.param("explain", "false")) in ("true", "")
        body = req.json()
        if body is None and req.param("q") is not None:
            body = {"query": {"query_string": {"query": req.param("q")}}}
        return 200, validate_query(node, req.params.get("index"), body,
                                   explain=explain)

    rc.register("GET", "/{index}/_validate/query", do_validate)
    rc.register("POST", "/{index}/_validate/query", do_validate)

    def do_explain(req):
        body = apply_uri_query(req, req.json() or {})
        src = req.param("_source")
        inc = req.param("_source_includes") or req.param("_source_include")
        exc = req.param("_source_excludes") or req.param("_source_exclude")
        spec = None
        if str(src) == "false":
            spec = None
        elif src is not None and str(src) != "true":
            spec = (str(src).split(","), [])
        elif str(src) == "true" or inc or exc:
            spec = (str(inc).split(",") if inc else [],
                    str(exc).split(",") if exc else [])
        return 200, explain_doc(node, req.params["index"], req.params["id"],
                                body, source_spec=spec)

    rc.register("GET", "/{index}/_explain/{id}", do_explain)
    rc.register("POST", "/{index}/_explain/{id}", do_explain)

    # ---------------------------------------------------------- termvectors
    def termvectors(req):
        body = req.json() or {}
        for p in ("realtime", "term_statistics"):
            if req.param(p) is not None:
                body.setdefault(p, req.param(p))
        return 200, node.termvectors_api(req.params["index"],
                                         req.params.get("id"), body)

    for path in ("/{index}/_termvectors/{id}", "/{index}/_termvectors"):
        rc.register("GET", path, termvectors)
        rc.register("POST", path, termvectors)

    # --------------------------------------------------------- search shards
    def search_shards(req):
        """The shards a search over the expression reaches, and each
        index's aliases the expression names with their filters (none
        when the index is named itself or an alias has no filter)."""
        expr = req.params.get("index")
        requested = [a.strip() for a in str(expr or "").split(",") if a]
        shards, indices_out = [], {}
        for svc in node.resolve(expr):
            for shard in svc.shards:
                shards.append([{
                    "index": svc.name, "shard": shard.shard_id,
                    "node": node.node_id, "primary": True,
                    "state": "STARTED",
                    "allocation_id": {"id": f"{svc.name}-{shard.shard_id}"},
                    "relocating_node": None}])
            matching = [a for a in svc.aliases
                        if any(_matches_csv(a, r) for r in requested)]
            entry: dict = {}
            if matching:
                entry["aliases"] = sorted(matching)
                direct = any(_matches_csv(svc.name, r) for r in requested)
                unfiltered = any(not (svc.aliases[a] or {}).get("filter")
                                 for a in matching)
                filters = [] if direct or unfiltered else [
                    _normalize_filter(svc.aliases[a]["filter"])
                    for a in matching if (svc.aliases[a] or {}).get("filter")]
                if len(filters) == 1:
                    entry["filter"] = filters[0]
                elif filters:
                    entry["filter"] = {"bool": {"should": filters,
                                                "boost": 1.0}}
            indices_out[svc.name] = entry
        return 200, {"nodes": {node.node_id: {"name": node.node_name}},
                     "shards": shards, "indices": indices_out}

    for path in ("/_search_shards", "/{index}/_search_shards"):
        rc.register("GET", path, search_shards)
        rc.register("POST", path, search_shards)

    # ------------------------------------------------- dynamic index settings
    def put_settings(req):
        body = req.json() or {}
        updates = flat_settings(body.get("settings", body))
        preserve = req.bool_param("preserve_existing", False)
        ignore_unavailable = req.bool_param("ignore_unavailable", False)
        # as the reference: a pattern matches alias names too (`resolve`),
        # a concrete alias names one index (`Node.index`)
        targets = []
        for part in (req.params.get("index") or "_all").split(","):
            part = part.strip()
            if "*" in part or part in ("_all", ""):
                targets.extend(node.resolve(part or "_all",
                                            forbid_closed=False))
                continue
            try:
                targets.append(node.index(part))
            except SearchEngineError:
                if not ignore_unavailable:
                    raise
        for svc in targets:
            svc.settings_update({k: v for k, v in updates.items()
                                 if not (preserve and k in svc.settings)})
        return 200, {"acknowledged": True}

    rc.register("PUT", "/{index}/_settings", put_settings)
    rc.register("PUT", "/_settings", put_settings)
