"""Index expressions through both REST layers on the CPU, request for
request (`tests/torch_rest_pair.py`): `_search`, `_count` and `_msearch`
over `a,b`, `b,a`, `a,a`, `*` patterns, `_all` and no index, with 1- and
3-shard indices (the hits merged by score across indices, `_shards`
summed, totals and `track_total_hits` over the sum), missing names with
and without `ignore_unavailable`, and the shard request cache's counters
across indices (a delete in one index misses). Then hybrid `rank: {rrf}`
bodies after deletes and updates, BM25 statistics over segments with
deleted documents included, and a hybrid body over several indices (the
general RRF path, `knn` legs as query clauses)."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair, hit_ids

D = 8
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _load(pair, name, shards, n, seed):
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {
            "v": {"type": "dense_vector", "dims": D,
                  "similarity": "cosine"},
            "k": {"type": "keyword"}, "n": {"type": "long"},
            "t": {"type": "text"}}}})
    ops = []
    for i in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(2, 7)))
        ops += [{"index": {"_id": f"{name}{i}"}},
                {"v": rng.standard_normal(D).tolist(), "k": f"k{i % 4}",
                 "n": i, "t": " ".join(words)}]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    return rng


def _bodies(rng):
    q = rng.standard_normal(D).tolist()
    return [
        {"knn": {"field": "v", "query_vector": q, "k": 10,
                 "num_candidates": 40}, "size": 10},
        {"query": {"term": {"k": "k1"}}, "size": 30},
        {"query": {"match": {"t": "alpha gamma"}}, "size": 15},
        {"query": {"match": {"t": "beta"}}, "from": 3, "size": 5},
        {"query": {"range": {"n": {"gte": 5, "lt": 20}}},
         "track_total_hits": 7},
        {"query": {"match": {"t": "eta"}}, "track_total_hits": False,
         "_source": ["k"]},
        {"size": 0, "query": {"term": {"k": "k2"}}},
    ]


@pytest.mark.parametrize("shards", [(1, 3), (3, 3)])
def test_search_count_msearch_over_expressions(pair, shards):
    _load(pair, "a", shards[0], 40, 1)
    _load(pair, "ab", shards[1], 30, 2)
    rng = _load(pair, "b", shards[1], 50, 3)
    _load(pair, "c", 1, 10, 4)
    bodies = _bodies(rng)
    for expr in ("a,b", "b,a", "a,a", "a*", "*", "_all", "a,c,b"):
        for body in bodies:
            pair.same("POST", f"/{expr}/_search", body)
        pair.same("POST", f"/{expr}/_count", {"query": {"term": {"k": "k1"}}})
        pair.same("GET", f"/{expr}/_count")
    for body in bodies:
        pair.same("POST", "/_search", body)
    pair.same("POST", "/_count", {"query": {"match": {"t": "alpha"}}})
    pair.same("POST", "/a,nope/_search", bodies[1])
    pair.same("POST", "/a,nope/_search", bodies[1],
              query={"ignore_unavailable": "true"})
    pair.same("POST", "/nope*/_search", bodies[1])
    pair.same("POST", "/nope*/_search", bodies[1],
              query={"allow_no_indices": "false"})
    pair.same("POST", "/a,nope/_count")
    lines = []
    for i, body in enumerate(bodies):
        lines += [{"index": ["a,b", "b", "*", "nope"][i % 4]}, body]
    lines += [{}, {"size": 3}]
    pair.same("POST", "/_msearch", lines, ndjson=True)
    pair.same("POST", "/a,b/_search", {"from": 2, "size": 4},
              query={"rest_total_hits_as_int": "true"})


@pytest.mark.parametrize("shards", [1, 3])
def test_request_cache_across_indices(pair, shards):
    _load(pair, "a", shards, 30, 5)
    _load(pair, "b", 3, 30, 6)
    counts = {"size": 0, "query": {"term": {"k": "k3"}}}
    stats = "/_stats/request_cache"
    for _ in range(2):
        pair.same("POST", "/a,b/_search", counts)
        _same_counters(pair, stats)
    pair.same("POST", "/b/_search", counts)
    _same_counters(pair, stats)
    # a delete in one index: that index misses, the other still hits
    pair.same("DELETE", "/b/_doc/b3")
    pair.same("POST", "/b/_refresh")
    pair.same("POST", "/a,b/_search", counts)
    _same_counters(pair, stats)
    _same_counters(pair, "/a,b/_stats/request_cache")
    knn = _bodies(np.random.default_rng(7))[0]
    for _ in range(2):
        pair.same("POST", "/a,b/_search", dict(knn, request_cache=True))
        _same_counters(pair, stats)


def _same_counters(pair, path: str) -> None:
    """The request cache's hit, miss and eviction counts of a stats call
    (the byte sizes are each package's own estimate)."""
    s1, want = pair.ref("GET", path)
    s2, got = pair.port("GET", path)
    assert s1 == s2 == 200
    for section in ("primaries", "total"):
        w = want["_all"][section]["request_cache"]
        g = got["_all"][section]["request_cache"]
        for key in ("hit_count", "miss_count", "evictions"):
            assert g[key] == w[key], (path, section, key, w, g)
    assert sorted(got["indices"]) == sorted(want["indices"])


def _hybrid(rng, text: str) -> dict:
    return {"query": {"match": {"t": text}},
            "knn": {"field": "v", "query_vector": rng.standard_normal(D)
                    .tolist(), "k": 10, "num_candidates": 40},
            "rank": {"rrf": {}}, "size": 10}


@pytest.mark.parametrize("shards", [1, 3])
def test_hybrid_after_deletes(pair, shards):
    rng = _load(pair, "h", shards, 80, 8)
    ops = [{"delete": {"_id": f"h{i}"}} for i in range(0, 80, 3)]
    for i in range(1, 80, 7):
        ops += [{"update": {"_id": f"h{i}"}},
                {"doc": {"t": "alpha alpha omega", "v": rng.standard_normal(D)
                         .tolist()}}]
    pair.same("POST", "/h/_bulk", ops, ndjson=True)
    pair.same("POST", "/h/_refresh")
    gone = {f"h{i}" for i in range(0, 80, 3)}
    for text in ("alpha", "omega beta", "gamma delta eta"):
        # BM25 over segments holding deleted documents
        _, got = pair.same("POST", "/h/_search",
                           {"query": {"match": {"t": text}}, "size": 20})
        assert not gone & set(hit_ids(got))
        body = _hybrid(rng, text)
        s1, want = pair.ref("POST", "/h/_search", body)
        s2, got = pair.port("POST", "/h/_search", dict(body,
                                                       request_cache=False))
        assert s1 == s2 == 200
        pair.match(want["hits"], got["hits"], f"hybrid {text}")
        assert not gone & set(hit_ids(got))
        # one index named by a pattern keeps the fused path
        s1, want = pair.ref("POST", "/h*/_search", body)
        s2, got = pair.port("POST", "/h*/_search", body)
        assert s1 == s2 == 200
        pair.match(want["hits"], got["hits"], f"hybrid h* {text}")


def test_hybrid_over_several_indices_is_refused(pair):
    """Once a 400 in the port; now the general RRF path, held to the
    reference's answers over a list, a pattern, `_all`, no index and a
    pattern that names none."""
    rng = _load(pair, "x1", 1, 20, 9)
    _load(pair, "x2", 3, 20, 10)
    body = _hybrid(rng, "alpha")
    for expr in ("x1,x2", "x*", "_all", "none*"):
        _, got = pair.same("POST", f"/{expr}/_search", body)
        assert "_shards" not in got
    _, got = pair.same("POST", "/_search", body)
    assert got["hits"]["hits"]
    _, got = pair.same("POST", "/none*/_search", body)
    assert got["hits"]["hits"] == []
