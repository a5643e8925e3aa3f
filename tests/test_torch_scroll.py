"""Scroll, sliced scroll, `indices_boost` and the point-in-time routes
through both REST layers on the CPU (`tests/torch_rest_pair.py`), on the
seeded mixed index (`tests/torch_mixed.py`) at 1 and 2 shards: every
page of a scroll (by score, and under a sort with `_score` null) with its
hits in the reference's order, the keep-alive and
`search.max_keep_alive`, the scroll 400s, clearing by id, by `_all` and
an unknown id (404), an expired id; the pinned reader across a write, a
delete, a refresh and a `_forcemerge`; slices that own whole shards and
hashed ones, disjoint and covering the unsliced result; `indices_boost`
as a list, an object and a pattern, an unknown index and
`ignore_unavailable`; `_pit` open and close; and the body keys the
reference accepts and ignores (`pit`, `point_in_time`,
`runtime_mappings`, a body `scroll`)."""

import json
import re
import time

import numpy as np
import pytest

from tests.torch_rest_pair import _VOLATILE, Pair, load_mixed, mixed_vector


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("scroll"), mp)
    load_mixed(pair, "a", request.param, 51)
    load_mixed(pair, "b", request.param, 52, n=80)
    pair.shards = request.param
    pair.qv = mixed_vector(np.random.default_rng(53))
    yield pair
    pair.close()
    mp.undo()


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def ids_of(body) -> list:
    return [h["_id"] for h in body["hits"]["hits"]]


_CONTEXT_ID = re.compile(r"[0-9a-f]{32}")


def _unnamed(body):
    """A response with each context id in it (an error names the id it
    did not find) read as one placeholder."""
    return json.loads(_CONTEXT_ID.sub("<id>", json.dumps(body)))


def both(pair, method, path, ref_body=None, port_body=None, ref_query=None,
         port_query=None, order=True):
    """One request to each layer (each with its own scroll id): the same
    status and body less the scroll id, and the same hit order."""
    s1, want = pair.ref(method, path, ref_body, query=ref_query)
    s2, got = pair.port(method, path, port_body, query=port_query)
    if s1 != 200:
        want, got = _unnamed(want), _unnamed(got)
    where = f"{method} {path}"
    assert s1 == s2, (where, want, got)
    pair.match(want, got, where, _VOLATILE | {"_scroll_id"})
    if order and s1 == 200 and "hits" in want:
        assert ids_of(got) == ids_of(want), where
    return want, got


def scroll_all(pair, path, body, query=None, via="body"):
    """A whole scroll in both layers, page by page; returns the ids in
    order and the last response pair."""
    want, got = both(pair, "POST", path, body, body,
                     {"scroll": "1m", **(query or {})},
                     {"scroll": "1m", **(query or {})})
    ids = ids_of(got)
    rid, pid = want["_scroll_id"], got["_scroll_id"]
    while want["hits"]["hits"]:
        if via == "body":
            want, got = both(pair, "POST", "/_search/scroll",
                             {"scroll_id": rid, "scroll": "1m"},
                             {"scroll_id": pid, "scroll": "1m"})
        elif via == "path":
            s1, want = pair.ref("GET", f"/_search/scroll/{rid}")
            s2, got = pair.port("GET", f"/_search/scroll/{pid}")
            assert s1 == s2 == 200
            pair.match(want, got, "path", _VOLATILE | {"_scroll_id"})
            assert ids_of(got) == ids_of(want)
        else:
            want, got = both(pair, "GET", "/_search/scroll", None, None,
                             {"scroll_id": rid, "scroll": "30s"},
                             {"scroll_id": pid, "scroll": "30s"})
        ids += ids_of(got)
    return ids, rid, pid


BODIES = {
    "match_all": {"size": 7},
    "query": {"query": {"match": {"t": "alpha beta"}}, "size": 9},
    "sort": {"query": {"range": {"n": {"gte": 3}}}, "size": 11,
             "sort": [{"tag": "asc"}, {"n": "desc"}]},
    "knn": {"knn": {"field": "v", "query_vector": None, "k": 12,
                    "num_candidates": 40}, "size": 5},
    "filter_source": {"query": {"bool": {"filter": [
        {"term": {"b": True}}]}}, "_source": ["t"], "size": 13},
    "terms_lookup": {"query": {"terms": {"s": {
        "index": "a", "id": "a1", "path": "s"}}}, "size": 8},
}


@pytest.mark.parametrize("case", sorted(BODIES))
@pytest.mark.parametrize("via", ["body", "path", "url"])
def test_scroll_pages_match_reference(world, case, via):
    body = dict(BODIES[case])
    if "knn" in body:
        body["knn"] = dict(body["knn"], query_vector=world.qv)
    ids, _, _ = scroll_all(world, "/a/_search", body, via=via)
    assert len(ids) == len(set(ids))
    total = world.port("POST", "/a/_count",
                       {"query": body["query"]} if "query" in body
                       else None)[1]["count"]
    if "knn" not in body:
        assert len(ids) == total


def test_scroll_over_two_indices_and_total_as_int(world):
    ids, rid, pid = scroll_all(
        world, "/a,b/_search", {"query": {"match": {"t": "gamma"}},
                                "size": 6},
        query={"rest_total_hits_as_int": "true"})
    assert ids and len(ids) == len(set(ids))
    both(world, "POST", "/_search/scroll", {"scroll_id": rid},
         {"scroll_id": pid}, {"rest_total_hits_as_int": "true"},
         {"rest_total_hits_as_int": "true"})
    want, got = both(world, "POST", "/b/_search",
                     {"sort": ["n"], "size": 4}, {"sort": ["n"], "size": 4},
                     {"scroll": "1m", "rest_total_hits_as_int": "true"},
                     {"scroll": "1m", "rest_total_hits_as_int": "true"})
    assert all(h["_score"] is None for h in got["hits"]["hits"])


@pytest.mark.parametrize("body,query", [
    ({"size": 0}, {"scroll": "1m"}),
    ({}, {"scroll": "1m", "request_cache": "true"}),
    ({"track_total_hits": False}, {"scroll": "1m"}),
    ({"collapse": {"field": "tag"}}, {"scroll": "1m"}),
    ({"size": 10_001}, {"scroll": "1m"}),
    ({}, {"scroll": "forever"}),
    ({"from": 5, "size": 3}, {"scroll": "1m"}),
], ids=["size_0", "request_cache", "track_total_hits", "collapse",
        "batch_size", "bad_keep_alive", "from"])
def test_scroll_start_errors_match_reference(world, body, query):
    both(world, "POST", "/a/_search", body, body, query, query)


def test_clear_scroll_by_id_all_and_unknown(world):
    starts = []
    for _ in range(3):
        starts.append(both(world, "POST", "/a/_search", {"size": 2},
                           {"size": 2}, {"scroll": "1m"},
                           {"scroll": "1m"}))
    (w0, g0), (w1, g1), (w2, g2) = starts
    both(world, "DELETE", "/_search/scroll", {"scroll_id": w0["_scroll_id"]},
         {"scroll_id": g0["_scroll_id"]})
    # freed: the next page is the reference's 404
    both(world, "POST", "/_search/scroll", {"scroll_id": w0["_scroll_id"]},
         {"scroll_id": g0["_scroll_id"]})
    s1, want = world.ref("DELETE", f"/_search/scroll/{w1['_scroll_id']}")
    s2, got = world.port("DELETE", f"/_search/scroll/{g1['_scroll_id']}")
    assert s1 == s2 == 200 and want == got
    both(world, "DELETE", "/_search/scroll",
         {"scroll_id": ["0123456789abcdef0123456789abcdef"]},
         {"scroll_id": ["0123456789abcdef0123456789abcdef"]})
    both(world, "DELETE", "/_search/scroll/_all")
    both(world, "POST", "/_search/scroll", {"scroll_id": w2["_scroll_id"]},
         {"scroll_id": g2["_scroll_id"]})
    both(world, "DELETE", "/_search/scroll", {"scroll_id": "_all"},
         {"scroll_id": "_all"})
    both(world, "POST", "/_search/scroll", {})


def test_keep_alive_expiry_and_max_keep_alive(pair):
    load_mixed(pair, "a", 1, 54, n=30)
    want, got = both(pair, "POST", "/a/_search", {"size": 5}, {"size": 5},
                     {"scroll": "1s"}, {"scroll": "1s"})
    time.sleep(1.2)
    both(pair, "POST", "/_search/scroll", {"scroll_id": want["_scroll_id"]},
         {"scroll_id": got["_scroll_id"]})
    pair.ref_node.cluster_settings.setdefault("persistent", {})[
        "search.max_keep_alive"] = "5m"
    pair.port_node.settings["search.max_keep_alive"] = "5m"
    both(pair, "POST", "/a/_search", {"size": 5}, {"size": 5},
         {"scroll": "10m"}, {"scroll": "10m"})
    want, got = both(pair, "POST", "/a/_search", {"size": 5}, {"size": 5},
                     {"scroll": "2m"}, {"scroll": "2m"})
    both(pair, "POST", "/_search/scroll",
         {"scroll_id": want["_scroll_id"], "scroll": "1h"},
         {"scroll_id": got["_scroll_id"], "scroll": "1h"})
    both(pair, "POST", "/_search/scroll",
         {"scroll_id": want["_scroll_id"], "scroll": "3m"},
         {"scroll_id": got["_scroll_id"], "scroll": "3m"})


@pytest.mark.parametrize("shards", [1, 2])
def test_pinned_reader_across_writes(pair, shards):
    """A write, a delete, an update, a refresh and a `_forcemerge` after
    the start leave the later pages as they were."""
    load_mixed(pair, "a", shards, 55, n=60)
    body = {"query": {"match": {"t": "alpha"}}, "size": 4,
            "sort": [{"n": "asc"}, {"s": "desc"}]}
    plain = pair.port("POST", "/a/_search", dict(body, size=100))[1]
    want, got = both(pair, "POST", "/a/_search", body, body,
                     {"scroll": "1m"}, {"scroll": "1m"})
    ids = ids_of(got)
    rid, pid = want["_scroll_id"], got["_scroll_id"]
    ops = [{"index": {"_id": "new1"}}, {"t": "alpha alpha", "n": 0},
           {"delete": {"_id": ids[-1]}},
           {"delete": {"_id": plain["hits"]["hits"][-1]["_id"]}},
           {"update": {"_id": plain["hits"]["hits"][6]["_id"]}},
           {"doc": {"t": "omega", "n": 1}}]
    steps = [("POST", "/a/_bulk", ops), ("POST", "/a/_refresh", None),
             ("PUT", "/a/_doc/new2", {"t": "alpha", "n": -5}),
             ("POST", "/a/_forcemerge", None), ("POST", "/a/_refresh", None)]
    for method, path, b in steps:
        pair.same(method, path, b, ndjson=path.endswith("_bulk"))
        want, got = both(pair, "POST", "/_search/scroll",
                         {"scroll_id": rid}, {"scroll_id": pid})
        ids += ids_of(got)
    while got["hits"]["hits"]:
        want, got = both(pair, "POST", "/_search/scroll",
                         {"scroll_id": rid}, {"scroll_id": pid})
        ids += ids_of(got)
    assert ids == ids_of(plain)
    fresh = pair.port("POST", "/a/_search", dict(body, size=100))[1]
    assert ids_of(fresh) != ids_of(plain)


@pytest.mark.parametrize("smax", [2, 3])
def test_slices_match_reference_and_partition(world, smax):
    """max 2 over 2 shards owns whole shards; 3, and any max over one
    shard, hashes each `_id`. The slices are disjoint and their union is
    the unsliced result."""
    body = {"query": {"range": {"n": {"gte": 2}}}, "size": 10}
    whole, _, _ = scroll_all(world, "/a/_search", body)
    seen = []
    for sid in range(smax):
        sliced = dict(body, slice={"id": sid, "max": smax})
        part, _, _ = scroll_all(world, "/a/_search", sliced)
        seen += part
        world.same("POST", "/a/_search", dict(sliced, size=50))
    assert len(seen) == len(set(seen))
    assert sorted(seen) == sorted(whole)


@pytest.mark.parametrize("spec", [
    {"id": 0, "max": 1}, {"id": 3, "max": 3}, {"id": -1, "max": 2},
    {"id": 0}, "x", {"id": 0, "max": 2000}])
def test_slice_errors_match_reference(world, spec):
    world.same("POST", "/a/_search", {"slice": spec})


@pytest.mark.parametrize("boost", [
    [{"b": 2.5}], {"b": 0.5, "a": 1.5}, [{"b*": 3.0}, {"b": 0.1}],
    [{"a": 2.0}, {"*": 0.25}]],
    ids=["list", "object", "pattern_first", "all_pattern"])
def test_indices_boost_matches_reference(world, boost):
    for body in ({"query": {"match": {"t": "delta eps"}}, "size": 20},
                 {"knn": {"field": "v", "query_vector": world.qv, "k": 6,
                          "num_candidates": 30}, "size": 9},
                 {"query": {"match": {"t": "iota"}}, "size": 5,
                  "sort": ["n", "_score"]}):
        want, got = world.same("POST", "/a,b/_search",
                               dict(body, indices_boost=boost))
        assert ids_of(got) == ids_of(want)
    world.same("POST", "/b/_search", {"indices_boost": boost, "size": 3})


def test_indices_boost_unknown_index(world):
    body = {"indices_boost": [{"nope": 2.0}], "size": 3}
    world.same("POST", "/a/_search", body)
    world.same("POST", "/a/_search", body,
               query={"ignore_unavailable": "true"})
    world.same("POST", "/a/_search", {"indices_boost": {"zz*": 2.0}})


def test_point_in_time_open_and_close(world):
    s1, want = world.ref("POST", "/a/_pit", query={"keep_alive": "2m"})
    s2, got = world.port("POST", "/a/_pit", query={"keep_alive": "2m"})
    assert s1 == s2 == 200 and set(want) == set(got) == {"id"}
    both(world, "DELETE", "/_pit", {"id": want["id"]}, {"id": got["id"]})
    both(world, "DELETE", "/_pit", {"id": want["id"]}, {"id": got["id"]})
    both(world, "DELETE", "/_pit", {"id": "nope"}, {"id": "nope"})
    both(world, "POST", "/nope/_pit")
    both(world, "POST", "/a/_pit", None, None, {"keep_alive": "soon"},
         {"keep_alive": "soon"})
    # an expired one is reaped at the next open or close
    s1, want = world.ref("POST", "/a/_pit", query={"keep_alive": "1ms"})
    s2, got = world.port("POST", "/a/_pit", query={"keep_alive": "1ms"})
    time.sleep(0.01)
    both(world, "DELETE", "/_pit", {"id": want["id"]}, {"id": got["id"]})


@pytest.mark.parametrize("key,value", [
    ("pit", {"id": "x", "keep_alive": "1m"}),
    ("point_in_time", {"id": "x"}),
    ("runtime_mappings", {"r": {"type": "long",
                                "script": "emit(1)"}}),
    ("scroll", "1m")])
def test_accepted_and_ignored_keys(world, key, value):
    world.same("POST", "/a/_search", {key: value, "size": 5,
                                      "query": {"match": {"t": "zeta"}}})
    world.same("POST", "/a/_search", {key: value, "size": 5,
                                      "sort": [{"r": "asc"}]})
