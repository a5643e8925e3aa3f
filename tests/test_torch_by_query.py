"""`_reindex`, `_update_by_query`, `_delete_by_query` and `_async_search`
through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`). Each write by query is followed by a `knn`
search, a `_count` and a sorted search over both indices, which must
answer as the reference's do (so the device corpus the port rebuilt from
its refresh holds what the reference's holds). An async search's id and
times are volatile and left out."""

import json
import time

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

D = 8
MAPPING = {"properties": {
    "t": {"type": "text"}, "k": {"type": "keyword"}, "n": {"type": "long"},
    "v": {"type": "dense_vector", "dims": D, "similarity": "cosine"}}}
ASYNC_VOLATILE = ("id", "start_time_in_millis", "expiration_time_in_millis")


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _load(pair, name, shards, n=30, seed=0, routed=False):
    pair.same("PUT", f"/{name}", {"settings": {"number_of_shards": shards},
                                  "mappings": MAPPING})
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        meta = {"_id": str(i)}
        if routed and i % 5 == 0:
            meta["routing"] = f"r{i}"
        ops += [{"index": meta},
                {"t": f"alpha beta {i % 4}", "k": f"k{i % 3}", "n": i,
                 "v": rng.standard_normal(D).round(3).tolist()}]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


def _after(pair, names):
    q = np.random.default_rng(5).standard_normal(D).round(3).tolist()
    for name in names:
        pair.same("POST", f"/{name}/_search", {
            "knn": {"field": "v", "query_vector": q, "k": 10,
                    "num_candidates": 60}, "request_cache": False})
        pair.same("POST", f"/{name}/_count")
        pair.same("POST", f"/{name}/_search", {"size": 100, "sort": ["n"],
                                               "version": True,
                                               "seq_no_primary_term": True})


# `k` a word in every tenth document, which `bad3` (`k` a long) refuses:
# ids 9, 19 and 29 route to shards 2, 2 and 1, so shard 0 takes none
_SOME_BAD = ("if (ctx._source.n % 10 == 9) { ctx._source.k = 'nine' } "
             "else { ctx._source.k = ctx._source.n }")
_REINDEX = [
    {"source": {"index": "a"}, "dest": {"index": "c"}},
    {"source": {"index": "a", "query": {"term": {"k": "k1"}}},
     "dest": {"index": "c"}},
    {"source": {"index": "a"}, "dest": {"index": "c"}, "max_docs": 7},
    {"source": {"index": "a,b"}, "dest": {"index": "c"}, "max_docs": 45},
    {"source": {"index": "a"}, "dest": {"index": "c"},
     "script": {"source": "ctx._source.n = ctx._source.n * 10; "
                          "ctx._source.tag = params.tag",
                "params": {"tag": "moved"}}},
    {"source": {"index": "a"}, "dest": {"index": "b"}},
    {"source": {"index": "b"}, "dest": {"index": "x"}},
    {"source": {"index": "x"}, "dest": {"index": "new"}},
    {"source": {"index": "a", "query": {"range": {"n": {"lt": 5}}}},
     "dest": {"index": "bad"}},
    {"source": {"index": "a"}, "dest": {"index": "bad3"},
     "script": {"source": _SOME_BAD}},
    {"source": {"index": "a,b"}, "dest": {"index": "bad3"}, "max_docs": 40,
     "script": {"source": _SOME_BAD}},
    {"source": {"index": "a"}, "dest": {"index": "c"},
     "script": {"source": "if (ctx._source.n == 17) "
                          "{ ctx._source.n = ctx._source.missing.x }"}},
    {"source": {"index": "nope"}, "dest": {"index": "c"}},
    {"source": {"index": "a"}},
]


@pytest.mark.parametrize("body", _REINDEX)
def test_reindex(pair, body):
    """A query, `max_docs`, a script, into an existing index (its
    documents updated), through aliases, auto-creating its destination,
    a destination that refuses some documents (one shard, or three of
    which one refuses none), a script that fails part way (the documents
    before it written), a missing source."""
    _load(pair, "a", 2)
    _load(pair, "b", 1, seed=1, n=20)
    pair.same("PUT", "/c", {"settings": {"number_of_shards": 3},
                            "mappings": MAPPING})
    pair.same("PUT", "/bad", {"mappings": {"properties": {
        "n": {"type": "keyword"}, "k": {"type": "long"}}}})
    pair.same("PUT", "/bad3", {"settings": {"number_of_shards": 3},
                               "mappings": {"properties": {
                                   **MAPPING["properties"],
                                   "k": {"type": "long"}}}})
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x"}}]})
    pair.same("POST", "/_reindex", body)
    # what a reindex that failed part way wrote, refreshed
    pair.same("POST", "/_refresh")
    _after(pair, [n for n in ("a", "b", "c", "new", "bad3") if n in
                  pair.port_node.indices])


@pytest.mark.parametrize("shards", [1, 3])
def test_reindex_keeps_source(pair, shards):
    """A reindexed document's `_source` is the one it was sent with, to
    the byte: its vector's values unrounded by float32, its keys in their
    order."""
    pair.same("PUT", "/a", {"mappings": MAPPING})
    pair.same("PUT", "/c", {"settings": {"number_of_shards": shards},
                            "mappings": MAPPING})
    rng = np.random.default_rng(3)
    ops = []
    for i in range(12):
        ops += [{"index": {"_id": str(i)}},
                {"v": [0.123] + rng.standard_normal(D - 1).tolist(),
                 "t": f"alpha {i}", "n": i, "k": f"k{i % 3}"}]
    pair.same("POST", "/a/_bulk", ops, ndjson=True)
    pair.same("POST", "/a/_refresh")
    pair.same("POST", "/_reindex", {"source": {"index": "a"},
                                    "dest": {"index": "c"}})
    for i in range(12):
        sent = json.dumps(ops[2 * i + 1])
        for call in (pair.ref, pair.port):
            for name in ("a", "c"):
                status, doc = call("GET", f"/{name}/_doc/{i}")
                assert status == 200
                assert json.dumps(doc["_source"]) == sent, (name, doc)


_UPDATE = [
    None, {"query": {"term": {"k": "k2"}}},
    {"script": {"source": "ctx._source.n += 100"}},
    {"query": {"range": {"n": {"gte": 10}}},
     "script": {"source": "if (ctx._source.n % 2 == 0) { ctx.op = 'none' } "
                          "else { ctx._source.tag = 'odd' }"}},
    {"script": {"source": "if (ctx._source.n < 8) { ctx.op = 'delete' }"}},
    {"script": {"source": "ctx._source.n = ctx._source.missing.x"}},
    {"script": {"source": "ctx._source.v = params.v",
                "params": {"v": [1.0] * D}},
     "query": {"ids": {"values": ["3", "4"]}}},
]


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("body", _UPDATE)
def test_update_by_query(pair, body, shards):
    """Each matching document re-indexed under its seq_no (a routed
    document comes back as a version conflict on 3 shards, the write
    going to the shard its id hashes to), `ctx.op` none and delete, a
    script error a failure."""
    _load(pair, "a", shards, routed=True)
    pair.same("POST", "/a/_update_by_query", body)
    _after(pair, ["a"])


@pytest.mark.parametrize("path,body", [
    ("/a/_delete_by_query", {"query": {"term": {"k": "k0"}}}),
    ("/a/_delete_by_query", {"query": {"ids": {"values": [
        str(i) for i in range(0, 30, 2)]}}}),
    ("/a/_delete_by_query", {"query": {"match_all": {}}}),
    ("/a/_delete_by_query", {}),
    ("/a/_delete_by_query", None),
    ("/x/_delete_by_query", {"query": {"range": {"n": {"lt": 12}}}}),
    ("/nope/_delete_by_query", {"query": {"match_all": {}}}),
])
@pytest.mark.parametrize("shards", [1, 3])
def test_delete_by_query(pair, path, body, shards):
    _load(pair, "a", shards, routed=True)
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x"}}]})
    pair.same("POST", path, body)
    _after(pair, ["a"])


def _strip(body):
    return {k: v for k, v in body.items() if k not in ASYNC_VOLATILE}


def _poll(pair, side, search_id):
    call = pair.ref if side == "ref" else pair.port
    for _ in range(200):
        status, body = call("GET", f"/_async_search/{search_id}")
        if status != 200 or not body["is_running"]:
            return status, body
        time.sleep(0.05)
    raise AssertionError(f"async search {search_id} still running")


@pytest.mark.parametrize("path,body,wait", [
    ("/a/_async_search", {"query": {"match": {"t": "beta"}}, "size": 5},
     "30s"),
    ("/a/_async_search", {"knn": {"field": "v", "query_vector": [0.5] * D,
                                  "k": 5, "num_candidates": 20}}, "30s"),
    ("/_async_search", {"size": 3, "sort": ["n"]}, "0s"),
    ("/a/_async_search", {"query": {"bogus": {}}}, "30s"),
    ("/nope/_async_search", {}, "30s"),
    ("/a/_async_search", {"knn": {"field": "v",
                                  "query_vector": [0.5] * (D + 1),
                                  "k": 5, "num_candidates": 20}}, "0s"),
])
def test_async_search(pair, path, body, wait):
    """Submit, poll to completion, GET and DELETE; an error in the worker
    lands in the entry's `error`; an unknown or deleted id is a 404."""
    _load(pair, "a", 2)
    q = {"wait_for_completion_timeout": wait}
    s1, want = pair.ref("POST", path, body, query=q)
    s2, got = pair.port("POST", path, body, query=q)
    assert s1 == s2 == 200
    if wait != "0s":
        pair.match(_strip(want), _strip(got), path)
    want = _poll(pair, "ref", want["id"])
    got = _poll(pair, "port", got["id"])
    assert want[0] == got[0] == 200
    pair.match(_strip(want[1]), _strip(got[1]), path)
    sync = pair.same("POST", path.replace("_async_search", "_search"),
                     body)[1]
    if "response" in got[1]:
        pair.match(sync, got[1]["response"], path)
    for side in ("ref", "port"):
        call = pair.ref if side == "ref" else pair.port
        sid = (want if side == "ref" else got)[1]["id"]
        assert call("DELETE", f"/_async_search/{sid}") == \
            (200, {"acknowledged": True})
        assert call("GET", f"/_async_search/{sid}")[0] == 404
    pair.same("DELETE", "/_async_search/unknown")
    pair.same("GET", "/_async_search/unknown")


def test_async_search_device_error_is_kept(pair, monkeypatch):
    """An error that is not a request error (a failed kernel launch, say)
    raised in the worker ends in the entry's `error`, never in a silent
    empty response."""
    _load(pair, "a", 1)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(pair.port_node, "search", broken)
    status, sub = pair.port("POST", "/a/_async_search", {"size": 1},
                            query={"wait_for_completion_timeout": "30s"})
    assert status == 200 and not sub["is_running"]
    assert "response" not in sub
    assert sub["error"] == {"type": "exception",
                            "reason": "CUDA error: an illegal memory access"}
