"""The node's search caches (`search/caches.py`): the LRU's byte counts, the
request cache's opt-in policy and keys, the query cache, field stats and
can_match on the port alone; then the port's REST layer against the
reference `Node` on the same PUT, `_bulk`, `_refresh` and `_search`
sequence at 1 and 3 shards (8 for the refresh rule): the same hits with
caches on, with caches off and in the reference; the same `query_cache`
and `request_cache` counters after a scripted sequence (cold, warm, a
refresh that changed nothing, an update and a refresh, `request_cache:
false`, `request_cache: true` on a body with `"now"`, `_cache/clear`, LRU
overflow at a small size); the same `_shards.skipped` under
`pre_filter_shard_size=1`; and a cached hybrid response equal to the
uncached one but for `took`."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.search import caches as ref_caches
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.caches import (
    LruCache, NodeCaches, QueryCache, RequestCache, can_match, field_stats,
    reader_fingerprint,
)
from elasticsearch_tpu_torch.search.queries import SearchContext, parse_query
from elasticsearch_tpu_torch.search.service import execute_query_phase

D = 8

# --------------------------------------------------------------- the LRU


class TestLruBytes:
    def test_memory_size_tracks_entries(self):
        c = LruCache(max_entries=8)
        assert c.stats()["memory_size_in_bytes"] == 0
        c.put("a", np.zeros(1024, dtype=np.float32))
        assert c.bytes >= 4096
        c.put("b", {"hits": [1, 2, 3], "s": "x" * 100})
        b2 = c.bytes
        assert b2 > 4096
        assert c.stats()["memory_size_in_bytes"] == b2

    def test_eviction_releases_bytes(self):
        c = LruCache(max_entries=2)
        c.put("a", np.zeros(256, dtype=np.float32))
        c.put("b", np.zeros(256, dtype=np.float32))
        full = c.bytes
        c.put("c", np.zeros(256, dtype=np.float32))  # evicts "a"
        assert c.stats()["evictions"] == 1
        assert c.bytes == full
        c.clear()
        assert c.bytes == 0

    def test_overwrite_replaces_bytes(self):
        c = LruCache(max_entries=4)
        c.put("a", np.zeros(1024, dtype=np.float32))
        c.put("a", np.zeros(16, dtype=np.float32))
        assert c.bytes < 1024

    @pytest.mark.parametrize("value", [
        np.zeros(300, dtype=np.int64), {"hits": [1, 2.5, "x" * 7], "n": None},
        ("a", b"bc", frozenset({1})), [[[[[[[1]]]]]]]])
    def test_bytes_equal_the_reference(self, value):
        c, r = LruCache(4), ref_caches.LruCache(4)
        c.put(("k", 1), value)
        r.put(("k", 1), value)
        assert c.bytes == r.bytes


class TestOptInPolicy:
    def test_skipped_uncacheable_counts(self):
        rc = RequestCache(8)
        body = {"size": 0, "request_cache": True,
                "query": {"range": {"d": {"gte": "now-1d"}}}}
        assert not rc.cacheable_tracked(body)
        assert rc.skipped_uncacheable == 1
        assert rc.stats()["skipped_uncacheable"] == 1
        # no opt-in flag: the default policy declines, uncounted
        assert not rc.cacheable_tracked({"size": 10})
        assert rc.skipped_uncacheable == 1

    def test_device_cacheable_policy(self):
        rc = RequestCache(8)
        knn = {"size": 5, "knn": {"field": "v", "query_vector": [0.0],
                                  "k": 5}}
        assert rc.device_cacheable(knn)
        assert not rc.device_cacheable({**knn, "request_cache": False})
        assert not rc.device_cacheable({"size": 5})  # not knn-bearing
        # a hybrid body caches whole, kNN leg or not
        hybrid = {"rank": {"rrf": {}}, "sub_searches": [
            {"query": {"match": {"t": "a"}}}]}
        assert rc.device_cacheable(hybrid)
        assert not rc.device_cacheable({**hybrid, "request_cache": False})
        bad = {**knn, "request_cache": True,
               "query": {"range": {"d": {"gte": "now-1h"}}}}
        assert not rc.device_cacheable(bad)
        assert rc.skipped_uncacheable == 1

    def test_request_cache_policy(self):
        assert RequestCache.cacheable(
            {"size": 0, "aggs": {"a": {"avg": {"field": "n"}}}})
        assert not RequestCache.cacheable({"size": 10})
        assert not RequestCache.cacheable({})  # default size=10
        assert RequestCache.cacheable({"size": 10, "request_cache": True})
        assert not RequestCache.cacheable({"size": 0,
                                           "request_cache": False})
        assert not RequestCache.cacheable(
            {"size": 0, "query": {"range": {"d": {"gte": "now-1d"}}}})
        assert not RequestCache.cacheable(
            {"size": 0, "query": {"script_score": {"script": "x"}}})


class TestRequestCacheKey:
    def test_strips_the_cache_flag(self):
        rc = RequestCache()
        body = {"size": 0, "aggs": {"a": {"avg": {"field": "n"}}}}
        assert rc.key("i", 1, body) == rc.key(
            "i", 1, {**body, "request_cache": True})

    def test_epoch_distinguishes(self):
        rc = RequestCache()
        body = {"size": 0, "aggs": {"a": {"avg": {"field": "n"}}}}
        assert rc.key("i", (("s0", 10, 10),), body) \
            != rc.key("i", (("s0", 10, 9),), body)

    def test_vector_values_distinguish(self):
        rc = RequestCache()
        b1 = {"knn": {"field": "v", "query_vector": [0.1, 0.2, 0.3], "k": 5}}
        b3 = {"knn": {"field": "v", "query_vector": [0.1, 0.2, 0.4], "k": 5}}
        assert rc.key("i", 1, b1) != rc.key("i", 1, b3)

    def test_array_values_key_whole(self):
        """A body given numpy arrays (the Python API) keys on every value:
        `str` of a long array elides its middle."""
        rc = RequestCache()
        a = np.zeros(2048, dtype=np.float32)
        b = a.copy()
        b[1000] = 1.0
        assert rc.key("i", 1, {"knn": {"query_vector": a}}) \
            != rc.key("i", 1, {"knn": {"query_vector": b}})
        assert rc.key("i", 1, {"knn": {"query_vector": a}}) \
            == rc.key("i", 1, {"knn": {"query_vector": a.tolist()}})

    @pytest.mark.parametrize("body", [
        {"knn": {"field": "v", "query_vector": [0.5, -1, 2.25], "k": 3},
         "size": 3, "request_cache": True},
        {"query": {"match": {"t": "a b"}}, "rank": {"rrf": {}},
         "sub_searches": [{"query": {"term": {"x": 1}}}]},
        {"knn": {"field": "v", "query_vector": "oops"}}])
    def test_keys_equal_the_reference(self, body):
        assert RequestCache().key("i", 3, body) \
            == ref_caches.RequestCache().key("i", 3, body)

    def test_request_cache_key_order_insensitive(self):
        rc = RequestCache()
        k1 = rc.key("idx", 1, {"aggs": {"a": 1}, "size": 0})
        k2 = rc.key("idx", 1, {"size": 0, "aggs": {"a": 1}})
        assert k1 == k2
        k3 = rc.key("idx", 1, {"size": 0, "aggs": {"a": 1},
                               "request_cache": True})
        assert k1 == k3


def test_node_caches_sizes():
    caches = NodeCaches()
    assert (caches.request.max_entries, caches.device_request.max_entries,
            caches.query.max_entries) == (1024, 512, 2048)
    assert set(caches.stats()) == {"request_cache", "query_cache"}


# ------------------------------------------------- an engine on its own

MAPPINGS = {"properties": {"n": {"type": "long"}, "title": {"type": "text"},
                           "tag": {"type": "keyword"}}}


@pytest.fixture
def engine():
    mapper = MapperService(MAPPINGS)
    eng = Engine(mapper)
    for i in range(20):
        eng.index(str(i), {"n": i, "title": f"doc {i}",
                           "tag": "even" if i % 2 == 0 else "odd"})
    eng.refresh()
    return eng, mapper


def test_request_cache_hit_and_reader_gen_invalidation(engine):
    eng, mapper = engine
    caches = NodeCaches()
    body = {"size": 0, "query": {"term": {"tag": "odd"}}}
    reader = eng.acquire_searcher()
    key = caches.request.key("idx", reader.gen, body)
    assert caches.request.get(key) is None
    result = execute_query_phase(SearchContext(reader, mapper), body)
    caches.request.put(key, result)
    assert caches.request.get(key) is result
    assert caches.request.hits == 1
    # a refresh makes a new reader and a new gen: a miss
    eng.index("new", {"n": 100, "title": "doc new", "tag": "odd"})
    reader2 = eng.refresh()
    assert reader2.gen != reader.gen
    assert caches.request.get(
        caches.request.key("idx", reader2.gen, body)) is None


def test_reader_fingerprint_follows_content(engine):
    eng, _mapper = engine
    fp = reader_fingerprint(eng.acquire_searcher())
    assert reader_fingerprint(eng.refresh()) == fp     # nothing changed
    eng.index("3", {"n": 3, "title": "doc 3 again", "tag": "odd"})
    assert reader_fingerprint(eng.refresh()) != fp     # a tombstone, a seg


def test_query_cache_caches_filter_rows(engine):
    eng, mapper = engine
    cache = QueryCache()
    reader = eng.acquire_searcher()
    body = {"query": {"bool": {"filter": [{"term": {"tag": "even"}}],
                               "must": [{"match": {"title": "doc"}}]}},
            "size": 20}
    r1 = execute_query_phase(SearchContext(reader, mapper,
                                           query_cache=cache), body)
    assert cache.misses >= 1 and cache.hits == 0
    r2 = execute_query_phase(SearchContext(reader, mapper,
                                           query_cache=cache), body)
    assert cache.hits >= 1
    assert np.array_equal(r1.rows, r2.rows)
    assert r1.total == r2.total == 10


@pytest.mark.parametrize("lossy,exact", [
    ({"match": {"title": {"query": "doc 3 4", "minimum_should_match": 3}}},
     {"match": {"title": "doc 3 4"}}),
    ({"multi_match": {"query": "doc 3", "fields": ["title"],
                      "operator": "and"}},
     {"multi_match": {"query": "doc 3", "fields": ["title"]}}),
    ({"bool": {"must": [{"match": {"title": {
        "query": "doc 3 4", "minimum_should_match": "100%"}}}]}},
     {"bool": {"must": [{"match": {"title": "doc 3 4"}}]}}),
], ids=["match_msm", "multi_match_operator", "nested_msm"])
def test_lossy_to_dict_is_not_cached(engine, lossy, exact):
    """The reference's `to_dict` leaves out `minimum_should_match` and
    `multi_match`'s `operator`, so two clauses that differ only there
    share its string: neither is cached, and each gets its own rows, in
    either order."""
    eng, mapper = engine
    reader = eng.acquire_searcher()
    assert json.dumps(parse_query(lossy).to_dict(), sort_keys=True) \
        == json.dumps(parse_query(exact).to_dict(), sort_keys=True)

    def rows(clause, cache):
        body = {"query": {"bool": {"filter": [clause]}}, "size": 30}
        return execute_query_phase(
            SearchContext(reader, mapper, query_cache=cache), body).rows

    want = {json.dumps(c): np.sort(rows(c, None)) for c in (lossy, exact)}
    assert len(want[json.dumps(lossy)]) != len(want[json.dumps(exact)])
    for order in ((lossy, exact), (exact, lossy)):
        cache = QueryCache()
        for clause in order + order:
            np.testing.assert_array_equal(np.sort(rows(clause, cache)),
                                          want[json.dumps(clause)])
        # the exact clause only: a miss, then a hit
        assert (len(cache), cache.misses, cache.hits) == (1, 1, 1)
        assert not parse_query(lossy).key_is_exact()
        assert parse_query(exact).key_is_exact()


def test_query_cache_lru_eviction():
    c = QueryCache(max_entries=2)
    c.put_rows(1, "a", np.array([1]))
    c.put_rows(1, "b", np.array([2]))
    c.put_rows(1, "c", np.array([3]))
    assert c.evictions == 1
    assert c.get_rows(1, "a") is None  # the oldest went


def test_field_stats(engine):
    eng, _mapper = engine
    reader = eng.acquire_searcher()
    assert field_stats(reader, "n") == (0.0, 19.0)
    assert field_stats(reader, "absent") is None
    # an update tombstones the old version: the live range narrows (the
    # port has no delete API; the reference's test deletes the doc)
    eng.index("19", {"n": 5, "title": "doc 19", "tag": "odd"})
    reader2 = eng.refresh()
    assert field_stats(reader2, "n") == (0.0, 18.0)


def test_can_match_range_pruning(engine):
    eng, mapper = engine
    reader = eng.acquire_searcher()
    assert can_match(reader, {"query": {"range": {"n": {
        "gte": 5, "lte": 10}}}})
    assert not can_match(reader, {"query": {"range": {"n": {
        "gte": 100}}}})
    assert not can_match(reader, {"query": {"range": {"n": {
        "lt": 0}}}})
    assert can_match(reader, {"query": {"range": {"n": {
        "gte": 19}}}})
    assert not can_match(reader, {"query": {"range": {"n": {
        "gt": 19}}}})
    # ranges under bool.filter constrain too
    assert not can_match(reader, {"query": {"bool": {"filter": [
        {"range": {"n": {"gte": 100}}}]}}})
    # should-clause ranges do not
    assert can_match(reader, {"query": {"bool": {"should": [
        {"range": {"n": {"gte": 100}}}]}}})
    assert can_match(reader, {"query": {"match_all": {}}})
    # a required range on a field the shard has never seen
    assert not can_match(reader,
                         {"query": {"range": {"absent": {"gte": 1}}}})


# ------------------------------------------- through both REST layers

MAPPING = {"properties": {
    "n": {"type": "integer"}, "tag": {"type": "keyword"},
    "title": {"type": "text"},
    "emb": {"type": "dense_vector", "dims": D, "similarity": "cosine"}}}
WORDS = ["alpha", "beta", "gamma", "delta", "eps"]
N_DOCS = 90


def _raw(body, ndjson=False):
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return b"" if body is None else json.dumps(body).encode()


def _docs():
    rng = np.random.default_rng(29)
    emb = rng.standard_normal((N_DOCS, D)).astype(np.float32)
    return [{"n": i, "tag": ["red", "green", "blue"][i % 3],
             "title": " ".join(rng.choice(WORDS, 3)),
             "emb": emb[i].tolist()} for i in range(N_DOCS)], emb


def _load(shards: int, tmp_path_factory, settings=None):
    """(reference node, port node, ref request, port request) holding the
    same documents in index `c` in two segments and an update."""
    ref = RefNode(str(tmp_path_factory.mktemp("ref")))
    port = Node(device="cpu", settings=settings)
    ref_rc, port_rc = RefController(), RestController()
    ref_register(ref_rc, ref)
    register_all(port_rc, port)

    def ref_req(method, path, body=None, ndjson=False, query=None):
        return ref_rc.dispatch(method, path, query or {}, _raw(body, ndjson),
                               "application/json")

    def port_req(method, path, body=None, ndjson=False, query=None):
        return port_rc.dispatch(method, path, query or {}, _raw(body, ndjson))

    docs, _emb = _docs()
    for req in (ref_req, port_req):
        assert req("PUT", "/c", {"settings": {"number_of_shards": shards},
                                 "mappings": MAPPING})[0] == 200
        for lo, hi in ((0, 60), (60, N_DOCS)):
            bulk = []
            for i in range(lo, hi):
                bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
            status, resp = req("POST", "/c/_bulk", bulk, ndjson=True)
            assert status == 200 and not resp["errors"]
            assert req("POST", "/c/_refresh")[0] == 200
        assert req("PUT", "/c/_doc/d7", docs[8])[0] == 200
        assert req("POST", "/c/_refresh")[0] == 200
    return ref, port, ref_req, port_req


@pytest.fixture(params=[1, 3])
def fresh(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    ref, port, ref_req, port_req = _load(request.param, tmp_path_factory)
    yield ref, port, ref_req, port_req
    ref.close()
    mp.undo()


def _qv(i):
    return (np.random.default_rng(500 + i).standard_normal(D)
            .astype(np.float32).tolist())


BODIES = {
    "knn": {"knn": {"field": "emb", "query_vector": _qv(0), "k": 5,
                    "num_candidates": 20}, "size": 5},
    "knn_bool_filter": {"knn": {
        "field": "emb", "query_vector": _qv(1), "k": 5, "num_candidates": 30,
        "filter": {"bool": {"filter": [{"term": {"tag": "red"}},
                                       {"range": {"n": {"gte": 10}}}],
                            "must_not": {"range": {"n": {"gt": 80}}}}}},
        "size": 5},
    "knn_term_filter": {"knn": {
        "field": "emb", "query_vector": _qv(2), "k": 4,
        "filter": {"term": {"tag": "blue"}}}, "size": 4},
    "knn_and_query": {"knn": {"field": "emb", "query_vector": _qv(3),
                              "k": 5}, "size": 6,
                      "query": {"bool": {"filter": [
                          {"terms": {"tag": ["green", "blue"]}}]}}},
    "count": {"size": 0, "query": {"bool": {"filter": [
        {"term": {"tag": "green"}}]}}},
    "bool_filter_hits": {"query": {"bool": {
        "must": {"match": {"title": "alpha beta"}},
        "filter": [{"range": {"n": {"gte": 5, "lt": 70}}},
                   {"term": {"tag": "red"}}]}}, "size": 8},
    "opt_in": {"query": {"bool": {"filter": {"range": {"n": {"lt": 30}}}}},
               "size": 3, "request_cache": True},
    "hybrid": {"query": {"match": {"title": "gamma"}},
               "knn": {"field": "emb", "query_vector": _qv(4), "k": 10,
                       "num_candidates": 40,
                       "filter": {"bool": {"filter": [
                           {"range": {"n": {"gte": 3}}}]}}},
               "rank": {"rrf": {"rank_window_size": 20}}, "size": 7},
}


def _counters(req) -> dict:
    status, stats = req("GET", "/_stats/query_cache,request_cache")
    assert status == 200, stats
    prim = stats["_all"]["primaries"]
    out = {f"query_cache.{k}": prim["query_cache"][k]
           for k in ("hit_count", "miss_count", "evictions")}
    out.update({f"request_cache.{k}": prim["request_cache"][k]
                for k in ("hit_count", "miss_count", "evictions",
                          "skipped_uncacheable")})
    return out


def _same_hits(want, got, label):
    assert got["hits"]["total"] == want["hits"]["total"], label
    assert [h["_id"] for h in got["hits"]["hits"]] \
        == [h["_id"] for h in want["hits"]["hits"]], label
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               [h["_score"] for h in want["hits"]["hits"]],
                               rtol=1e-6, err_msg=label)


def _send_all(ref_req, port_req, bodies, label, query=None):
    for case, body in bodies.items():
        s1, want = ref_req("POST", "/c/_search", body, query=query)
        s2, got = port_req("POST", "/c/_search", body, query=query)
        assert s1 == s2 == 200, (label, case, want, got)
        _same_hits(want, got, f"{label} {case}")


def test_counters_match_reference_over_a_scripted_sequence(fresh):
    ref, port, ref_req, port_req = fresh
    steps = []

    def step(label):
        want, got = _counters(ref_req), _counters(port_req)
        assert got == want, label
        steps.append((label, got))

    step("loaded")
    _send_all(ref_req, port_req, BODIES, "cold")
    step("cold")
    _send_all(ref_req, port_req, BODIES, "warm")
    step("warm")
    for req in (ref_req, port_req):
        assert req("POST", "/c/_refresh")[0] == 200
    _send_all(ref_req, port_req, BODIES, "refresh, no change")
    step("refresh, no change")
    docs, _emb = _docs()
    for req in (ref_req, port_req):
        assert req("PUT", "/c/_doc/d11", dict(docs[11], n=500))[0] == 200
        assert req("POST", "/c/_refresh")[0] == 200
    _send_all(ref_req, port_req, BODIES, "update and refresh")
    step("update and refresh")
    _send_all(ref_req, port_req, {
        case: {**body, "request_cache": False}
        for case, body in BODIES.items()}, "request_cache false")
    _send_all(ref_req, port_req, {"knn": BODIES["knn"]}, "URL false",
              query={"request_cache": "false"})
    step("request_cache false")
    now = {"host": {"size": 0, "request_cache": True,
                    "query": {"term": {"tag": "nowhere"}}},
           "device": {"knn": {"field": "emb", "query_vector": _qv(5),
                              "k": 3, "filter": {"term": {
                                  "tag": "nowhere"}}},
                      "request_cache": True},
           "hybrid": {**BODIES["hybrid"], "request_cache": True,
                      "query": {"match": {"title": "nowhere"}}}}
    _send_all(ref_req, port_req, now, "now")
    step("request_cache true with now")
    # the kNN body counts on both rungs: the device rung refuses it, then
    # the host rung's policy reads the same opt-in, as in the reference
    assert steps[-1][1]["request_cache.skipped_uncacheable"] == 4
    for req in (ref_req, port_req):
        status, resp = req("POST", "/_cache/clear")
        assert status == 200
    assert resp == ref_req("POST", "/c/_cache/clear")[1]
    _send_all(ref_req, port_req, BODIES, "after clear")
    step("cache clear")
    for node in (ref, port):
        for cache in (node.caches.request, node.caches.device_request,
                      node.caches.query):
            cache.max_entries = 2
    _send_all(ref_req, port_req, BODIES, "small LRU")
    _send_all(ref_req, port_req, {
        case: {**body, "request_cache": False}
        for case, body in BODIES.items()}, "small LRU, filters evaluated")
    _send_all(ref_req, port_req, BODIES, "small LRU again")
    _send_all(ref_req, port_req, {
        f"new {j}": ({**BODIES["knn"], "knn": {**BODIES["knn"]["knn"],
                                              "query_vector": _qv(10 + j)}}
                     if j % 2 else
                     {"size": 0, "query": {"range": {"n": {"gte": j}}}})
        for j in range(6)}, "small LRU, new bodies")
    step("LRU overflow")
    last = steps[-1][1]
    assert last["query_cache.evictions"] > 0
    assert last["request_cache.evictions"] > 0
    # every rung was used: hits and misses grew from the first step
    assert last["query_cache.hit_count"] > steps[1][1]["query_cache.hit_count"]
    assert steps[2][1]["request_cache.hit_count"] \
        > steps[1][1]["request_cache.hit_count"]


def test_hits_equal_with_caches_on_off_and_in_reference(fresh,
                                                        tmp_path_factory):
    """Each body three times on the port with its caches on, on a port
    node with the device rung off and every cache held at 0 entries, and
    on the reference: the same hits every time."""
    _ref, port, ref_req, port_req = fresh
    shards = port.index("c").num_shards
    ref_off, off, _r, off_req = _load(
        shards, tmp_path_factory,
        settings={"search.request_cache.device_paths": "false"})
    ref_off.close()
    for cache in (off.caches.request, off.caches.device_request,
                  off.caches.query):
        cache.max_entries = 0
    for _ in range(3):
        for case, body in BODIES.items():
            s1, want = ref_req("POST", "/c/_search", body)
            s2, got = port_req("POST", "/c/_search", body)
            s3, cold = off_req("POST", "/c/_search", body)
            assert s1 == s2 == s3 == 200, (case, want, got, cold)
            _same_hits(want, got, case)
            _same_hits(cold, got, case)
    assert sum(off.caches.stats()[c]["hit_count"] for c in (
        "request_cache", "query_cache")) == 0
    assert port.caches.device_request.hits > 0 \
        and port.caches.query.hits > 0 and port.caches.request.hits > 0


SKIP_RANGES = {
    "inside": {"range": {"n": {"gte": 10, "lte": 20}}},
    "above": {"range": {"n": {"gte": 1000}}},
    "below": {"range": {"n": {"lt": 0}}},
    "at_max": {"range": {"n": {"gte": N_DOCS - 1}}},
    "past_max": {"range": {"n": {"gt": N_DOCS - 1}}},
    "string_bound": {"range": {"n": {"gte": "2000"}}},
    "bool_filter_out": {"bool": {"filter": [{"range": {"n": {
        "gte": 1000}}}]}},
    "bool_should_out": {"bool": {"should": [{"range": {"n": {
        "gte": 1000}}}]}},
    "absent_field": {"range": {"width": {"gte": 1}}},
    "no_range": {"term": {"tag": "red"}},
}


@pytest.mark.parametrize("case", sorted(SKIP_RANGES))
def test_pre_filter_skips_as_the_reference(fresh, case):
    _ref, _port, ref_req, port_req = fresh
    body = {"query": SKIP_RANGES[case], "size": 5}
    for query in ({"pre_filter_shard_size": "1"}, {}):
        s1, want = ref_req("POST", "/c/_search", body, query=query)
        s2, got = port_req("POST", "/c/_search", body, query=query)
        assert s1 == s2 == 200, (want, got)
        assert got["_shards"] == want["_shards"]
        _same_hits(want, got, case)
    if case in ("above", "below", "past_max", "string_bound",
                "bool_filter_out", "absent_field"):
        assert got["_shards"]["skipped"] == 0   # without the parameter
        s, resp = port_req("POST", "/c/_search", body,
                           query={"pre_filter_shard_size": "1"})
        assert resp["_shards"]["skipped"] == resp["_shards"]["total"]


def test_rest_errors_match_reference(fresh):
    _ref, _port, ref_req, port_req = fresh
    s1, want = ref_req("POST", "/c/_search", {"query": {"match_all": {}}},
                       query={"pre_filter_shard_size": "0"})
    s2, got = port_req("POST", "/c/_search", {"query": {"match_all": {}}},
                       query={"pre_filter_shard_size": "0"})
    assert s1 == s2 == 400
    assert got["error"]["reason"] == want["error"]["reason"]
    s1, want = ref_req("GET", "/c/_stats/query_cahce")
    s2, got = port_req("GET", "/c/_stats/query_cahce")
    assert s1 == s2 == 400
    assert got["error"]["reason"] == want["error"]["reason"]
    # a metric the port has not ported yet
    assert port_req("GET", "/_stats/docs")[0] == 400
    status, resp = port_req("GET", "/missing/_stats/query_cache")
    assert status == ref_req("GET", "/missing/_stats/query_cache")[0] == 404


def test_stats_shape_matches_reference(fresh):
    _ref, _port, ref_req, port_req = fresh
    _send_all(ref_req, port_req, {"count": BODIES["count"]}, "count")
    for path in ("/_stats/query_cache,request_cache",
                 "/c/_stats/request_cache", "/c/_stats/query_cache"):
        s1, want = ref_req("GET", path)
        s2, got = port_req("GET", path)
        assert s1 == s2 == 200
        for section in (want["_all"]["primaries"], want["_all"]["total"]):
            for metric in section.values():
                # the reference's two sections are one object
                metric.pop("memory_size_in_bytes", None)
        for section in (got["_all"]["primaries"], got["_all"]["total"]):
            for metric in section.values():
                assert metric.pop("memory_size_in_bytes") > 0
        assert got["_shards"] == want["_shards"]
        assert got["_all"] == want["_all"]
        want["indices"]["c"].pop("uuid")
        got["indices"]["c"].pop("uuid")
        assert got["indices"] == want["indices"]


def test_cached_hybrid_equals_uncached_but_for_took(fresh):
    _ref, port, _ref_req, port_req = fresh
    body = BODIES["hybrid"]
    s, warm = port_req("POST", "/c/_search", body)
    ex = port._hybrid_executor(port.index("c"))
    before, hits = dict(ex.stats), port.caches.device_request.hits
    s, cached = port_req("POST", "/c/_search", body)
    assert port.caches.device_request.hits == hits + 1
    assert ex.stats["batches"] == before["batches"]
    assert cached["took"] == 0
    s, off = port_req("POST", "/c/_search", {**body, "request_cache": False})
    assert ex.stats["batches"] == before["batches"] + 1
    for r in (warm, cached, off):
        r.pop("took")
    assert json.dumps(warm, sort_keys=True) \
        == json.dumps(cached, sort_keys=True) \
        == json.dumps(off, sort_keys=True)
    # a served response is a copy: changing it leaves the stored one
    cached["hits"]["hits"].clear()
    s, again = port_req("POST", "/c/_search", body)
    again.pop("took")
    assert again == warm


def test_refresh_rule_at_eight_shards(tmp_path_factory):
    """An 8-shard index: a kNN body hits after a refresh that changed no
    shard and misses after one that changed a shard, on both nodes, with
    the same counters and hits."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    ref, port, ref_req, port_req = _load(8, tmp_path_factory)
    try:
        body = BODIES["knn_bool_filter"]
        docs, _emb = _docs()

        def send(label):
            s1, want = ref_req("POST", "/c/_search", body)
            s2, got = port_req("POST", "/c/_search", body)
            assert s1 == s2 == 200
            _same_hits(want, got, label)
            assert _counters(port_req) == _counters(ref_req), label
            return port.caches.device_request.hits

        hits = send("cold")
        assert send("warm") == hits + 1
        for req in (ref_req, port_req):
            assert req("POST", "/c/_refresh")[0] == 200
        assert send("refresh, no change") == hits + 2
        for req in (ref_req, port_req):
            assert req("PUT", "/c/_doc/d40", dict(docs[40], n=41))[0] == 200
            assert req("POST", "/c/_refresh")[0] == 200
        assert send("one shard changed") == hits + 2
        assert send("warm again") == hits + 3
    finally:
        ref.close()
        mp.undo()
