"""The index API through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`): `DELETE`, `GET` and `HEAD /{index}` over
names, lists and patterns, `_mapping` GET (every field type the port maps,
`dense_vector` with `index_options` and `rank_vectors` among them) and PUT
(new fields, type conflicts, a bare field object, `_meta`), `_settings`
(by name pattern, flat, with defaults), `_refresh` with no index,
`filter_path` on successes and errors, and `allow_no_indices` per
expression part. Then, on the port alone: a deleted
index lets go of its stores' corpora and its hybrid executor, and a
recreated index of the same name misses the request cache, and
`expand_wildcards` naming hidden indices and `index.hidden` are 400s
(`closed` and `none` through both layers)."""

import gc
import weakref

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

D = 8

ALL_TYPES = {
    "v": {"type": "dense_vector", "dims": D, "similarity": "dot_product",
          "index_options": {"type": "int8_flat", "rescore": True}},
    "vi": {"type": "dense_vector", "dims": D,
           "index_options": {"type": "ivf", "nlist": 4, "nprobe": 2}},
    "tok": {"type": "rank_vectors", "dims": D,
            "index_options": {"encoding": "int8"}},
    "t": {"type": "text", "analyzer": "english"},
    "k": {"type": "keyword", "ignore_above": 32},
    "l": {"type": "long"}, "i": {"type": "integer"}, "s": {"type": "short"},
    "b8": {"type": "byte"}, "d": {"type": "double"}, "f": {"type": "float"},
    "h": {"type": "half_float"},
    "sf": {"type": "scaled_float", "scaling_factor": 100},
    "ok": {"type": "boolean"},
    "rf": {"type": "rank_feature", "positive_score_impact": False},
    "rfs": {"type": "rank_features"},
    "sv": {"type": "sparse_vector"},
}


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _create(pair, name, shards=1, props=None, settings=None):
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards, **(settings or {})},
        "mappings": {"properties": props or {
            "v": {"type": "dense_vector", "dims": D}, "k": {"type": "keyword"}}}})


@pytest.mark.parametrize("shards", [1, 3])
def test_index_delete_get_head(pair, shards):
    for name in ("logs-a", "logs-b", "other"):
        _create(pair, name, shards)
        pair.same("PUT", f"/{name}/_doc/1", {"k": name})
    for path in ("/logs-a", "/logs-a,other", "/logs-*", "/_all", "/*",
                 "/nope", "/logs-a,nope", "/_bad", "/nope*"):
        pair.same("GET", path)
        pair.same("HEAD", path)
    pair.same("GET", "/nope", query={"ignore_unavailable": "true"})
    pair.same("GET", "/nope*", query={"allow_no_indices": "false"})
    pair.same("DELETE", "/nope")
    pair.same("DELETE", "/nope", query={"ignore_unavailable": "true"})
    pair.same("DELETE", "/nope*", query={"allow_no_indices": "false"})
    pair.same("DELETE", "/logs-*")
    pair.same("HEAD", "/logs-a")
    pair.same("GET", "/logs-a/_doc/1")
    pair.same("POST", "/logs-a/_search")
    # a recreated name starts empty
    _create(pair, "logs-a", shards)
    pair.same("POST", "/logs-a/_count")
    pair.same("DELETE", "/_all")
    pair.same("GET", "/_all")
    pair.same("POST", "/_search")


def test_allow_no_indices_per_part(pair):
    """`allow_no_indices=false` holds each wildcard part of an expression
    to matching an index, as the reference's `DELETE /{index}` does: a
    list with one empty pattern deletes nothing. The reference's search
    and index-info APIs test the whole result instead; the port answers
    them by the same per-part rule."""
    for name in ("logs-a", "other"):
        _create(pair, name)
    no = {"allow_no_indices": "false"}
    pair.same("DELETE", "/logs-a,nope*", query=no)
    pair.same("HEAD", "/logs-a")
    pair.same("GET", "/logs-*,other", query=no)
    pair.same("POST", "/logs-*,other/_search", query=no)
    for method, path in (("GET", "/other,nope*"),
                         ("GET", "/other,nope*/_mapping"),
                         ("POST", "/other,nope*/_search")):
        status, resp = pair.port(method, path, query=no)
        assert status == 404, (path, resp)
        assert resp["error"]["type"] == "index_not_found_exception"
        assert resp["error"]["reason"] == "no such index [nope*]"
        assert pair.port(method, path)[0] == 200


@pytest.mark.parametrize("expand", ["all", "hidden", "closed", "open,hidden",
                                    "none"])
def test_expand_wildcards_beyond_open_refused(pair, expand):
    """`expand_wildcards` values that name hidden indices (`all`,
    `hidden`) are a 400 that names the parameter and its ROADMAP.md item
    on every API that resolves an expression, and so is an `index.hidden`
    setting; `closed` and `none` answer as the reference does, with a
    closed index beside the open one."""
    _create(pair, "logs-a")
    q = {"expand_wildcards": expand}
    requests = (("POST", "/logs-*/_search"), ("GET", "/logs-*"),
                ("GET", "/_mapping"), ("GET", "/_settings"),
                ("DELETE", "/logs-*"))
    if expand in ("closed", "none"):
        _create(pair, "logs-b")
        pair.same("POST", "/logs-b/_close")
        for method, path in requests:
            pair.same(method, path, query=q)
    else:
        for method, path in requests:
            status, resp = pair.port(method, path, query=q)
            assert status == 400, (path, resp)
            assert "[expand_wildcards]" in resp["error"]["reason"]
            assert "item 16" in resp["error"]["reason"]
    _create(pair, "logs-c")
    pair.same("POST", "/logs-*/_search", query={"expand_wildcards": "open"})
    pair.same("HEAD", "/logs-c")
    status, resp = pair.port("PUT", "/hid", {"settings": {
        "index": {"hidden": True}}})
    assert status == 400 and "[index.hidden]" in resp["error"]["reason"]
    assert pair.port("HEAD", "/hid")[0] == 404


def test_mapping_get_and_put(pair):
    pair.same("PUT", "/m", {"mappings": {"_meta": {"owner": "search"},
                                         "properties": ALL_TYPES}})
    pair.same("PUT", "/m2", {"mappings": {"_source": {"enabled": False},
                                          "properties": {
                                              "k": {"type": "keyword"}}}})
    pair.same("GET", "/m/_mapping")
    pair.same("GET", "/_mapping")
    pair.same("GET", "/m*/_mapping")
    pair.same("GET", "/nope/_mapping")
    pair.same("GET", "/m")
    # additive puts: a new field, a bare field object, over a pattern
    pair.same("PUT", "/m/_mapping", {"properties": {
        "extra": {"type": "keyword"}}})
    pair.same("PUT", "/m/_mapping", {"bare": {"type": "long"},
                                     "_source": {"enabled": True}})
    pair.same("PUT", "/m*/_mapping", {"properties": {
        "both": {"type": "boolean"}}})
    # the reference's 400s: a type change, types in the body, no index
    pair.same("PUT", "/m/_mapping", {"properties": {"k": {"type": "long"}}})
    pair.same("PUT", "/m/_mapping", {"_doc": {"properties": {
        "x": {"type": "keyword"}}}})
    pair.same("PUT", "/nope*/_mapping", {"properties": {
        "x": {"type": "keyword"}}})
    pair.same("PUT", "/m/_mapping", {"properties": {"x": {"type": "geo"}}})
    pair.same("GET", "/_mapping")
    # a new field is indexed by later writes
    pair.same("PUT", "/m/_doc/1", {"extra": "e", "both": True})
    pair.same("POST", "/m/_refresh")
    pair.same("POST", "/m/_search", {"query": {"term": {"extra": "e"}}})


def test_settings(pair):
    _create(pair, "s1", 3, settings={"index.knn.nlist": 16,
                                     "index": {"knn": {"nprobe": 2}},
                                     "max_result_window": 500})
    _create(pair, "s2", 1, settings={"number_of_replicas": 0})
    for path in ("/_settings", "/s1/_settings", "/s*/_settings",
                 "/s1/_settings/index.knn.*", "/_settings/index.number_*",
                 "/s1,s2/_settings/_all", "/nope/_settings"):
        pair.same("GET", path)
    pair.same("GET", "/_settings", query={"flat_settings": "true"})
    pair.same("GET", "/s2/_settings", query={"include_defaults": "true"})
    pair.same("GET", "/s2/_settings", query={"include_defaults": "true",
                                              "flat_settings": "true"})


def test_refresh_without_index(pair):
    _create(pair, "r1", 1)
    _create(pair, "r2", 3)
    for name in ("r1", "r2"):
        for i in range(4):
            pair.same("PUT", f"/{name}/_doc/{i}", {"k": "a"})
    pair.same("POST", "/_search", {"query": {"term": {"k": "a"}}})
    pair.same("POST", "/_refresh")
    pair.same("POST", "/_search", {"query": {"term": {"k": "a"}}})
    pair.same("GET", "/r1/_refresh")
    pair.same("POST", "/r*/_refresh")
    pair.same("POST", "/nope/_refresh")


@pytest.mark.parametrize("spec", [
    "hits.hits._id", "hits.total,hits.hits._source.k", "hits.hits.*",
    "**._id", "-hits.hits._source", "-**._source,-_shards", "took,nothing",
    "error.type", "status", "**.reason"])
def test_filter_path(pair, spec):
    _create(pair, "fp", 1)
    for i in range(3):
        pair.same("PUT", f"/fp/_doc/{i}", {"k": f"v{i}"})
    pair.same("POST", "/fp/_refresh", query={"filter_path": spec})
    pair.same("POST", "/fp/_search", {"query": {"term": {"k": "v1"}}},
              query={"filter_path": spec})
    pair.same("GET", "/nope/_doc/1", query={"filter_path": spec})
    pair.same("POST", "/fp/_bulk", [{"index": {"_id": "x"}}, {"k": "x"}],
              ndjson=True, query={"filter_path": spec})


def _index_hybrid(pair, name):
    rng = np.random.default_rng(5)
    pair.port("PUT", f"/{name}", {"mappings": {"properties": {
        "v": {"type": "dense_vector", "dims": D},
        "t": {"type": "text"}}}})
    ops = []
    for i in range(64):
        ops += [{"index": {"_id": str(i)}},
                {"v": rng.standard_normal(D).tolist(),
                 "t": f"alpha w{i % 5} beta"}]
    pair.port("POST", f"/{name}/_bulk", ops, ndjson=True,
              query={"refresh": "true"})
    body = {"query": {"match": {"t": "alpha w1"}},
            "knn": {"field": "v", "query_vector": [1.0] * D, "k": 5},
            "rank": {"rrf": {}}}
    status, resp = pair.port("POST", f"/{name}/_search", body)
    assert status == 200 and resp["hits"]["hits"]
    return body


def test_deleted_index_drops_store_and_executor(pair):
    node = pair.port_node
    _index_hybrid(pair, "h")
    svc = node.index("h")
    store = svc.shards[0].vector_store
    assert store.field("v") is not None and "h" in node._hybrid
    refs = [weakref.ref(x) for x in (svc, node._hybrid["h"],
                                     store.field("v").corpus.matrix)]
    status, resp = pair.port("DELETE", "/h")
    assert status == 200 and resp == {"acknowledged": True}
    assert "h" not in node.indices and "h" not in node._hybrid
    assert store.field("v") is None
    del svc, store
    gc.collect()
    assert [r() for r in refs] == [None, None, None]
    assert pair.port("HEAD", "/h")[0] == 404
    assert pair.port("POST", "/h/_search")[0] == 404


def test_recreated_index_misses_request_cache(pair):
    node = pair.port_node
    body = _index_hybrid(pair, "h")
    knn = {"knn": body["knn"], "size": 5}
    first = pair.port("POST", "/h/_search", knn)[1]
    again = pair.port("POST", "/h/_search", knn)[1]
    assert again["hits"] == first["hits"]
    hits0 = node.caches.device_request.stats()["hit_count"]
    assert hits0 >= 1
    pair.port("DELETE", "/h")
    pair.port("PUT", "/h", {"mappings": {"properties": {
        "v": {"type": "dense_vector", "dims": D}}}})
    pair.port("PUT", "/h/_doc/only", {"v": [1.0] * D},
              query={"refresh": "true"})
    status, resp = pair.port("POST", "/h/_search", knn)
    assert status == 200
    assert [h["_id"] for h in resp["hits"]["hits"]] == ["only"]
    assert node.caches.device_request.stats()["hit_count"] == hits0
    status, resp = pair.port("POST", "/h/_search", dict(body))
    assert status == 200
    assert [h["_id"] for h in resp["hits"]["hits"]] == ["only"]
