"""REST handlers of the kNN slice (port of a subset of
`elasticsearch_tpu/rest/actions.py`).

Routes: GET /, PUT /{index}, PUT|POST /{index}/_doc/{id},
POST|PUT /{index}/_bulk, POST /{index}/_refresh, GET|POST /{index}/_search,
GET /{index}/_doc/{id}, POST [/{index}]/_cache/clear and
GET [/{index}]/_stats/{metric} (`query_cache`, `request_cache`). The
document routes take the `routing` query parameter, and `_bulk` a
`routing` in each action's metadata; `_search` searches every shard
whatever its `routing`, as the reference does, and takes `size`,
`request_cache` (into the body, the cache's per-request opt-in or
opt-out) and `pre_filter_shard_size` (can_match before the query phase).
"""

from __future__ import annotations

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController

VERSION = "8.0.0-torch"


def register_all(rc: RestController, node: Node) -> None:
    def root(req):
        import torch
        return 200, {
            "name": node.node_name, "cluster_uuid": node.node_id,
            "version": {"number": VERSION, "build_flavor": "torch",
                        "lucene_version": "none",
                        "torch": torch.__version__,
                        "device": str(node.device)},
            "tagline": "You Know, for Search",
        }

    def create_index(req):
        return 200, node.create_index(req.params["index"], req.json())

    def put_doc(req):
        resp = node.index_doc(req.params["index"], req.params["id"],
                              req.json() or {},
                              op_type=req.param("op_type", "index"),
                              refresh=req.param("refresh"),
                              routing=req.param("routing"))
        return (201 if resp["result"] == "created" else 200), resp

    def get_doc(req):
        resp = node.get_doc(req.params["index"], req.params["id"],
                            routing=req.param("routing"))
        return (200 if resp["found"] else 404), resp

    def bulk(req):
        return 200, node.bulk(req.ndjson(),
                              default_index=req.params.get("index"),
                              refresh=req.param("refresh"))

    def refresh(req):
        return 200, node.refresh(req.params["index"])

    def search(req):
        body = req.json() or {}
        size = req.param("size")
        if size is not None:
            body["size"] = int(size)
        pfs = req.param("pre_filter_shard_size")
        if pfs is not None:
            pfs = int(pfs)
            if pfs < 1:
                raise IllegalArgumentError("preFilterShardSize must be >= 1")
        cache_flag = req.param("request_cache")
        if cache_flag is not None:
            # the URL form of the body's `request_cache`
            body["request_cache"] = cache_flag in ("", "true", "1")
        return 200, node.search(req.params["index"], body,
                                pre_filter_shard_size=pfs)

    def clear_cache(req):
        return 200, node.clear_cache(req.params.get("index"))

    def stats(req):
        metrics = [m.strip() for m in req.params["metric"].split(",")
                   if m.strip()]
        return 200, node.index_stats(req.params.get("index"), metrics)

    rc.register("GET", "/", root)
    rc.register("PUT", "/{index}", create_index)
    rc.register("PUT", "/{index}/_doc/{id}", put_doc)
    rc.register("POST", "/{index}/_doc/{id}", put_doc)
    rc.register("GET", "/{index}/_doc/{id}", get_doc)
    rc.register("POST", "/{index}/_bulk", bulk)
    rc.register("PUT", "/{index}/_bulk", bulk)
    rc.register("POST", "/_bulk", bulk)
    rc.register("POST", "/{index}/_refresh", refresh)
    rc.register("GET", "/{index}/_search", search)
    rc.register("POST", "/{index}/_search", search)
    rc.register("POST", "/_cache/clear", clear_cache)
    rc.register("POST", "/{index}/_cache/clear", clear_cache)
    rc.register("GET", "/_stats/{metric}", stats)
    rc.register("GET", "/{index}/_stats/{metric}", stats)
