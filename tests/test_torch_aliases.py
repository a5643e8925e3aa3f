"""Aliases, closed indices, dynamic settings, health, the cat tables and
`GET /_nodes` through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`): alias actions and the `/_alias` routes,
searches and document operations through aliases, data operations on a
closed index refused and patterns skipping it, `PUT _settings` (dynamic,
static refused, `null`, `preserve_existing`, `ignore_unavailable`),
`_cluster/health`, `_cat/indices|health|shards|aliases` and the node info
forms. Node ids, the version string and the cat tables' store sizes (the
reference's are file sizes, the port's its device bytes) differ by
design and are compared with the node id mapped and the sizes left
out."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

D = 8
MAPPING = {"properties": {
    "t": {"type": "text"}, "k": {"type": "keyword"}, "n": {"type": "long"},
    "v": {"type": "dense_vector", "dims": D, "similarity": "cosine"}}}


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _load(pair, name="a", shards=2, n=24, seed=0, replicas=None):
    settings = {"number_of_shards": shards}
    if replicas is not None:
        settings["number_of_replicas"] = replicas
    pair.same("PUT", f"/{name}", {"settings": settings,
                                  "mappings": MAPPING})
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        ops += [{"index": {"_id": str(i)}},
                {"t": f"word{i % 5} common text {i}", "k": f"k{i % 3}",
                 "n": i, "v": rng.standard_normal(D).round(3).tolist()}]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


def _two(pair):
    _load(pair, "a", 2, seed=1)
    _load(pair, "b", 1, seed=2)


def _knn(seed=9, k=5):
    q = np.random.default_rng(seed).standard_normal(D).round(3).tolist()
    return {"knn": {"field": "v", "query_vector": q, "k": k,
                    "num_candidates": 20}, "request_cache": False}


_ACTIONS = [
    [{"add": {"index": "a", "alias": "x"}}],
    [{"add": {"indices": ["a", "b"], "aliases": ["x", "y"]}}],
    [{"add": {"index": "a", "alias": "r", "routing": 1}},
     {"add": {"index": "b", "alias": "r2", "index_routing": 2,
              "search_routing": "3,4"}}],
    [{"add": {"index": "a", "alias": "f",
              "filter": {"term": {"k": "k1"}}, "is_write_index": True}}],
    [{"add": {"index": "*", "alias": "every"}}],
    [{"add": {"index": "a", "alias": "x"}},
     {"add": {"index": "a", "alias": "xy"}},
     {"remove": {"index": "a", "alias": "x*"}}],
    [{"add": {"indices": ["a", "b"], "alias": "x"}},
     {"remove": {"indices": ["a", "b"], "aliases": "x"}}],
    [{"add": {"index": "a", "alias": "x"}},
     {"remove_index": {"index": "b"}}],
    [{"add": {"index": "nope", "alias": "x"}}],
    [{"add": {"index": "a"}}],
    [{"bogus": {"index": "a", "alias": "x"}}],
]


@pytest.mark.parametrize("actions", _ACTIONS)
def test_alias_actions(pair, actions):
    _two(pair)
    pair.same("POST", "/_aliases", {"actions": actions})
    pair.same("GET", "/_alias")
    pair.same("GET", "/_cat/aliases", query={"v": "true"})
    pair.same("GET", "/_cat/aliases", query={"format": "json"})
    pair.same("GET", "/_cat/indices", query={"h": "index,status,docs.count",
                                            "s": "index"})


_ALIAS_ROUTES = [
    ("GET", "/_alias/x", None), ("GET", "/a/_alias", None),
    ("GET", "/a,b/_alias/x,y", None), ("GET", "/_alias/x,nope", None),
    ("GET", "/_alias/*,-y", None), ("GET", "/_alias/_all", None),
    ("GET", "/b/_alias/nope", None), ("HEAD", "/_alias/x", None),
    ("HEAD", "/_alias/nope", None), ("HEAD", "/b/_alias/y", None),
    ("PUT", "/b/_alias/z", None), ("POST", "/a,b/_aliases/z", {
        "routing": "5", "filter": {"range": {"n": {"gte": 3}}}}),
    ("PUT", "/a/_alias/bad name", None), ("PUT", "/a/_alias/b", None),
    ("PUT", "/nope/_alias/z", None), ("DELETE", "/a/_alias/x", None),
    ("DELETE", "/*/_alias/y", None), ("DELETE", "/a/_alias/x,nope", None),
    ("DELETE", "/b/_aliases/x", None),
]


@pytest.mark.parametrize("method,path,body", _ALIAS_ROUTES)
def test_alias_routes(pair, method, path, body):
    _two(pair)
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x"}},
        {"add": {"indices": ["a", "b"], "alias": "y"}}]})
    pair.same(method, path, body)
    pair.same("GET", "/_alias")


_THROUGH_ALIASES = [
    ("POST", "/x/_search", {"query": {"match": {"t": "word1"}}}),
    ("POST", "/y/_search", {"query": {"match": {"t": "common"}},
                            "size": 40}),
    ("POST", "/x,b/_search", {"size": 0, "aggs": {
        "k": {"terms": {"field": "k"}}}}),
    ("POST", "/x*/_search", {"query": {"term": {"k": "k2"}}}),
    ("POST", "/x/_search", _knn()), ("POST", "/y/_search", _knn(3)),
    ("POST", "/x/_count", {"query": {"range": {"n": {"gte": 10}}}}),
    ("POST", "/y/_count", None),
    ("GET", "/x/_doc/3", None), ("GET", "/x/_source/4", None),
    ("GET", "/y/_doc/3", None),
    ("PUT", "/x/_doc/new", {"t": "fresh", "n": 99}),
    ("PUT", "/y/_doc/new", {"t": "fresh"}),
    ("DELETE", "/x/_doc/5", None),
    ("POST", "/x/_update/6", {"doc": {"n": 600}}),
    ("POST", "/x/_mget", {"ids": ["1", "2", "nope"]}),
    ("POST", "/_mget", {"docs": [{"_index": "x", "_id": "1"},
                                 {"_index": "y", "_id": "1"}]}),
    ("POST", "/x/_refresh", None), ("GET", "/x", None),
    ("DELETE", "/x", None), ("DELETE", "/y,b", None),
    ("DELETE", "/x*,a", None), ("HEAD", "/y", None),
    ("GET", "/x/_mapping", None), ("GET", "/y/_settings", None),
]


@pytest.mark.parametrize("method,path,body", _THROUGH_ALIASES)
def test_search_and_documents_through_aliases(pair, method, path, body):
    _two(pair)
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x"}},
        {"add": {"indices": ["a", "b"], "alias": "y"}}]})
    pair.same(method, path, body)
    pair.same("POST", "/_refresh")
    pair.same("POST", "/a,b/_search", {"query": {"match_all": {}},
                                       "size": 60, "sort": ["n"]})
    pair.same("POST", "/_msearch", [{"index": "x"}, {"size": 3,
                                                      "sort": ["n"]},
                                    {"index": "y"}, _knn(5)], ndjson=True)
    pair.same("POST", "/_bulk", [{"index": {"_index": "x", "_id": "b1"}},
                                 {"t": "bulk"},
                                 {"index": {"_index": "y", "_id": "b2"}},
                                 {"t": "bulk"}], ndjson=True)


_ON_CLOSED = [
    ("POST", "/a/_search", None), ("POST", "/a,b/_search", None),
    ("POST", "/*/_search", {"size": 50, "sort": ["n"]}),
    ("POST", "/_search", {"size": 50, "sort": ["n"]}),
    ("POST", "/a/_search", _knn()), ("POST", "/a/_count", None),
    ("POST", "/_count", None), ("GET", "/a/_doc/1", None),
    ("PUT", "/a/_doc/1", {"t": "x"}), ("DELETE", "/a/_doc/1", None),
    ("POST", "/a/_update/1", {"doc": {"n": 1}}),
    ("POST", "/a/_bulk", [{"index": {"_id": "9"}}, {"t": "y"}]),
    ("POST", "/_mget", {"docs": [{"_index": "a", "_id": "1"},
                                 {"_index": "b", "_id": "1"}]}),
    ("POST", "/a/_refresh", None), ("POST", "/_refresh", None),
    ("POST", "/a/_forcemerge", None), ("POST", "/a/_cache/clear", None),
    ("GET", "/a", None), ("GET", "/*", None), ("GET", "/_mapping", None),
    ("GET", "/a/_mapping", None), ("GET", "/a/_settings", None),
    ("GET", "/_settings", None), ("HEAD", "/a", None),
    ("POST", "/a/_close", None), ("POST", "/a,b/_close", None),
    ("POST", "/nope/_close", None), ("POST", "/z*/_close", None),
    ("POST", "/nope/_open", None), ("POST", "/*/_open", None),
    ("POST", "/a,nope/_open", None), ("GET", "/_cluster/health/a", None),
    ("GET", "/_cat/shards/a", None, {"h": "index,shard,prirep,state"}),
    ("GET", "/a/_search_shards", None),
    ("POST", "/a/_search", {"query": {"match_all": {}}},
     {"ignore_unavailable": "true"}),
    ("POST", "/a,b/_search", {"size": 50, "sort": ["n"]},
     {"ignore_unavailable": "true"}),
    ("POST", "/*/_search", None, {"expand_wildcards": "closed"}),
    ("POST", "/*/_search", {"size": 50, "sort": ["n"]},
     {"expand_wildcards": "open"}),
    ("GET", "/*", None, {"expand_wildcards": "closed"}),
    ("GET", "/*/_mapping", None, {"expand_wildcards": "open,closed"}),
    ("DELETE", "/a", None),
]


@pytest.mark.parametrize("case", _ON_CLOSED,
                         ids=[f"{c[0]} {c[1]} {c[3] if len(c) > 3 else ''}"
                              for c in _ON_CLOSED])
def test_closed_index(pair, case):
    """A closed index refuses data operations (400
    `index_closed_exception`), patterns skip it, the index-info routes
    serve it, and once opened it answers as before the close."""
    method, path, body = case[:3]
    query = case[3] if len(case) > 3 else None
    _two(pair)
    before = pair.same("POST", "/a/_search", _knn())[0]
    pair.same("POST", "/a/_close")
    pair.same(method, path, body, ndjson=path.endswith("_bulk"),
              query=query)
    pair.same("GET", "/_cat/indices", query={
        "h": "health,status,index,pri,rep,docs.count", "v": "true"})
    if method == "DELETE":
        return
    pair.same("POST", "/a/_open")
    after = pair.same("POST", "/a/_search", _knn())[0]
    if path == "/a/_bulk" or method in ("PUT", "DELETE") \
            or "_update" in path:
        return
    assert [h["_id"] for h in after["hits"]["hits"]] == \
        [h["_id"] for h in before["hits"]["hits"]]


_SETTINGS = [
    ("/a/_settings", {"index": {"max_result_window": 5}}, None),
    ("/a/_settings", {"max_result_window": 5}, None),
    ("/a/_settings", {"index.number_of_replicas": 0}, None),
    ("/a/_settings", {"settings": {"index": {"number_of_replicas": 2}}},
     None),
    ("/a/_settings", {"index": {"number_of_replicas": None}}, None),
    ("/a/_settings", {"index": {"number_of_shards": 4}}, None),
    ("/a/_settings", {"index": {"uuid": "x"}}, None),
    ("/a/_settings", {"index": {"translog.retention.size": "1mb"}}, None),
    ("/a/_settings", {"index": {"max_result_window": 5,
                                "refresh_interval": "5s"}},
     {"preserve_existing": "true"}),
    ("/a,nope/_settings", {"index": {"max_result_window": 5}}, None),
    ("/a,nope/_settings", {"index": {"max_result_window": 5}},
     {"ignore_unavailable": "true"}),
    ("/*/_settings", {"index": {"max_result_window": 7}}, None),
    ("/_settings", {"index": {"max_result_window": 7}}, None),
    ("/x/_settings", {"index": {"max_result_window": 3}}, None),
    ("/y/_settings", {"index": {"max_result_window": 3}}, None),
    ("/y*/_settings", {"index": {"max_result_window": 3}}, None),
    ("/a/_settings", {"index": {"analyze": {"max_token_count": 2}}}, None),
]


@pytest.mark.parametrize("path,body,query", _SETTINGS)
def test_put_settings(pair, path, body, query):
    """Dynamic settings take effect on the next request:
    `max_result_window` on search windows, `number_of_replicas` on health
    and the cat tables, `analyze.max_token_count` on `_analyze`. A
    concrete alias of two indices is a 400 while a pattern matches alias
    names, as neither `Node.resolve` nor `Node.resolve_info` alone has
    it."""
    _two(pair)
    pair.same("PUT", "/a/_settings", {"index": {"refresh_interval": "2s"}})
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x"}},
        {"add": {"indices": ["a", "b"], "alias": "y"}}]})
    pair.same("PUT", path, body, query=query)
    pair.same("GET", "/_settings", query={"flat_settings": "true"})
    for frm in (0, 4, 8):
        pair.same("POST", "/a/_search", {"from": frm, "size": 3,
                                         "sort": ["n"]})
    pair.same("GET", "/_cluster/health", query={"level": "indices"})
    pair.same("GET", "/_cat/indices", query={
        "h": "health,index,rep", "s": "index"})
    pair.same("POST", "/a/_analyze", {"text": "one two three four"})


_HEALTH = [
    ("/_cluster/health", None), ("/_cluster/health", {"level": "shards"}),
    ("/_cluster/health/a", {"level": "indices"}),
    ("/_cluster/health/g*", None), ("/_cluster/health/nope", None),
    ("/_cluster/health/a,nope", None),
    ("/_cluster/health", {"wait_for_status": "green"}),
    ("/_cluster/health", {"wait_for_status": "yellow"}),
    ("/_cluster/health", {"wait_for_nodes": ">=2"}),
    ("/_cluster/health", {"wait_for_active_shards": "9"}),
    ("/_cluster/health/*", {"expand_wildcards": "open"}),
    ("/_cluster/health/*", {"expand_wildcards": "closed"}),
    ("/_cluster/health/ga", None), ("/_cluster/health/ga*", None),
]


@pytest.mark.parametrize("path,query", _HEALTH)
def test_cluster_health(pair, path, query):
    """Green with no replicas, yellow when replicas can never assign, red
    and a 408 for a missing concrete index; closed indices count. Health
    reads index names only: an alias is a missing index, and a pattern
    does not match it."""
    _load(pair, "g", 1, n=4, replicas=0)
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "g", "alias": "ga"}}]})
    pair.same("GET", path, query=query)
    _load(pair, "y", 2, n=4)
    pair.same("POST", "/y/_close")
    pair.same("GET", path, query=query)
    pair.same("GET", "/_cat/health", query={"ts": "false", "v": "true"})


_CAT = [
    ("/_cat/indices", {"h": "health,status,index,pri,rep,docs.count,"
                            "docs.deleted", "v": "true"}),
    ("/_cat/indices", {"h": "i,dc,p", "s": "dc:desc", "v": "true"}),
    ("/_cat/indices/a*", {"h": "index,docs.count", "format": "json"}),
    ("/_cat/indices", {"health": "yellow", "h": "index"}),
    ("/_cat/indices", {"help": "true"}),
    ("/_cat/health", {"h": "cluster,status,node.total,shards,pri,unassign,"
                           "active_shards_percent", "v": "true"}),
    ("/_cat/health", {"ts": "false", "format": "json"}),
    ("/_cat/health", {"help": "true"}),
    ("/_cat/shards", {"h": "index,shard,prirep,state,docs,ip,node",
                      "v": "true"}),
    ("/_cat/shards/a", {"h": "i,s,p,st,d,seq_no.max,segments.count",
                        "s": "s:desc,p", "format": "json"}),
    ("/_cat/shards", {"h": "index,shard,fielddata.memory_size,flush.total,"
                           "get.time", "bytes": "b"}),
    ("/_cat/shards", {"help": "true"}),
    ("/_cat/aliases", {"v": "true", "s": "alias"}),
    ("/_cat/aliases/x*", {"h": "alias,index,filter", "format": "json"}),
    ("/_cat/aliases", {"help": "true"}),
]


@pytest.mark.parametrize("path,query", _CAT)
def test_cat_tables(pair, path, query):
    _two(pair)
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x", "routing": "1"}},
        {"add": {"index": "b", "alias": "xb",
                 "filter": {"term": {"k": "k0"}}}}]})
    pair.same("DELETE", "/a/_doc/3")
    pair.same("PUT", "/b/_settings", {"index": {"number_of_replicas": 0}})
    pair.same("GET", path, query=query)


def _node_view(pair, method, path, query=None):
    """Both answers with each node id as NODE and the version left out."""
    out = []
    for node, (status, body) in (
            (pair.ref_node, pair.ref(method, path, query=query)),
            (pair.port_node, pair.port(method, path, query=query))):
        if isinstance(body, dict) and isinstance(body.get("nodes"), dict):
            body["nodes"] = {("NODE" if k == node.node_id else k): v
                             for k, v in body["nodes"].items()}
            for sec in body["nodes"].values():
                sec.pop("version", None)
        out.append((status, body))
    return out


@pytest.mark.parametrize("path,query", [
    ("/_nodes", None), ("/_nodes/_local", None), ("/_nodes/_all", None),
    ("/_nodes/settings", None), ("/_nodes/process,plugins", None),
    ("/_nodes/_local/settings", None), ("/_nodes/node-0/_all", None),
    ("/_nodes/_local/bogus", None), ("/_nodes", {"flat_settings": "true"}),
    ("/_nodes/settings", {"flat_settings": "true"}),
])
def test_nodes_info(pair, path, query):
    ref, port = _node_view(pair, "GET", path, query)
    assert ref[0] == port[0], (ref, port)
    pair.match(ref[1], port[1], path)


def test_nodes_routes_beside_info(pair):
    """`/_nodes/traces` and `/_nodes/stats/telemetry` keep their answers
    beside `/_nodes/{seg}`; `/_nodes/stats` is still a 400 naming its
    ROADMAP.md item, and so are `_flush` and date math in an index
    name."""
    status, body = pair.port("GET", "/_nodes/traces")
    assert status == 200 and pair.port_node.node_id in body["nodes"]
    status, body = pair.port("GET", "/_nodes/stats/telemetry")
    assert status == 200
    assert "telemetry" in body["nodes"][pair.port_node.node_id]
    for path in ("/_nodes/stats", "/_nodes/_local/stats"):
        status, body = pair.port("GET", path)
        assert status == 400 and "item 14" in body["error"]["reason"]
    _load(pair, "a", 1, n=4)
    for method, path, item in (("POST", "/_flush", "item 9"),
                               ("POST", "/a/_flush", "item 9"),
                               ("POST", "/%3Ca-%7Bnow%2Fd%7D%3E/_search", "item 16")):
        status, body = pair.port(method, path)
        assert status == 400 and item in body["error"]["reason"], body
