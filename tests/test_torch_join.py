"""Parent-join and the percolator through both REST layers on the CPU,
request for request (`tests/torch_rest_pair.py`): the `join` mapper and
its values, `has_child`, `has_parent` and `parent_id` on one shard and
two, children written with and without their parent's id as `routing`,
alone, inside a `bool`, as a `knn` filter and around a `knn` clause, and
a mapping without a `join` field; then the `percolator` mapper and
`percolate` with `document` and `documents`, a stored kind the matcher
skips, and a stored query that fails to parse at write time."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

TAGS = ["red", "green", "blue"]


def _vec(rng) -> list:
    return np.round(rng.normal(size=8), 3).tolist()


def load_join(pair, name: str, shards: int, seed: int, n: int = 24):
    """`n` questions and 3n answers; answer i names question i % n as its
    parent, written with that id as its routing when i is even."""
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {
            "jf": {"type": "join", "relations": {"question": "answer"}},
            "tag": {"type": "keyword"}, "title": {"type": "text"},
            "n": {"type": "long"},
            "v": {"type": "dense_vector", "dims": 8,
                  "similarity": "cosine"}}}})
    ops = []
    for i in range(n):
        ops += [{"index": {"_id": f"q{i}"}},
                {"jf": "question" if i % 5 else {"name": "question"},
                 "tag": TAGS[i % 3], "title": f"question {i % 4}",
                 "n": i, "v": _vec(rng)}]
    for i in range(3 * n):
        meta = {"_id": f"a{i}"}
        if i % 2 == 0:
            meta["routing"] = f"q{i % n}"
        ops += [{"index": meta},
                {"jf": {"name": "answer", "parent": f"q{i % n}"},
                 "tag": TAGS[(i // 2) % 3], "title": f"answer {i % 6}",
                 "n": i, "v": _vec(rng)}]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    pair.same("POST", f"/{name}/_bulk",
              [{"delete": {"_id": f"a{i}"}} for i in range(0, 3 * n, 7)]
              + [{"delete": {"_id": "q5"}}], ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    return rng


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("join"), mp)
    rng = load_join(pair, "j", request.param, 61)
    pair.qv = _vec(rng)
    pair.same("PUT", "/plain", {"settings": {
        "number_of_shards": request.param}, "mappings": {"properties": {
            "tag": {"type": "keyword"}}}})
    pair.same("PUT", "/plain/_doc/1?refresh=true", {"tag": "red"})
    yield pair
    pair.close()
    mp.undo()


def _total(body) -> int:
    return body["hits"]["total"]["value"]


def test_join_mapper(world):
    _, got = world.same("GET", "/j/_mapping")
    assert got["j"]["mappings"]["properties"]["jf"] == {
        "type": "join", "relations": {"question": "answer"}}
    for doc in ({"jf": 7}, {"jf": {"parent": "q1"}}, {"jf": ["question"]},
                {"jf": {"name": "answer", "parent": "q2"}}):
        world.same("PUT", "/j/_doc/extra", doc)
        world.same("DELETE", "/j/_doc/extra")
    world.same("POST", "/j/_refresh")
    _, got = world.same("POST", "/j/_search", {"query": {"term": {
        "jf": "question"}}, "size": 0})
    assert _total(got) == 23


JOIN_QUERIES = {
    "has_child_all": {"has_child": {"type": "answer", "query": {
        "match_all": {}}}},
    "has_child_term": {"has_child": {"type": "answer", "query": {
        "term": {"tag": "blue"}}, "score_mode": "max"}},
    "has_child_match": {"has_child": {"type": "answer", "query": {
        "match": {"title": "answer 3"}}}},
    "has_child_wrong_type": {"has_child": {"type": "question", "query": {
        "match_all": {}}}},
    "has_parent_term": {"has_parent": {"parent_type": "question", "query": {
        "term": {"tag": "red"}}, "score": True}},
    "has_parent_range": {"has_parent": {"parent_type": "question", "query": {
        "range": {"n": {"gte": 10}}}}},
    "has_parent_wrong_type": {"has_parent": {"parent_type": "answer",
                                             "query": {"match_all": {}}}},
    "parent_id": {"parent_id": {"type": "answer", "id": "q3"}},
    "parent_id_deleted_parent": {"parent_id": {"type": "answer",
                                               "id": "q5"}},
    "parent_id_number": {"parent_id": {"type": "answer", "id": 7}},
    "bool": {"bool": {"must": [{"has_child": {"type": "answer", "query": {
        "term": {"tag": "green"}}}}], "filter": [{"term": {"tag": "red"}}],
        "should": [{"parent_id": {"type": "answer", "id": "q1"}}]}},
}


@pytest.mark.parametrize("case", sorted(JOIN_QUERIES))
def test_join_queries(world, case):
    world.same("POST", "/j/_search", {"query": JOIN_QUERIES[case],
                                      "size": 100})


def test_join_answers_are_not_empty(world):
    for case in ("has_child_all", "has_parent_term", "parent_id"):
        _, got = world.same("POST", "/j/_search", {
            "query": JOIN_QUERIES[case], "size": 0})
        assert _total(got) > 0, case


@pytest.mark.parametrize("case", ["has_parent_term", "has_parent_range",
                                  "parent_id", "has_child_term"])
def test_join_as_knn_filter(world, case):
    world.same("POST", "/j/_search", {"knn": {
        "field": "v", "query_vector": world.qv, "k": 6,
        "num_candidates": 60, "filter": JOIN_QUERIES[case]}})


@pytest.mark.parametrize("k", [3, 12])
def test_has_child_around_knn(world, k):
    """`has_child` wrapping a `knn` clause: the parents of the child leg's
    hits (the leg runs the binned kernel on the card)."""
    knn = {"knn": {"field": "v", "query_vector": world.qv, "k": k,
                   "num_candidates": 80, "filter": {"term": {
                       "jf": "answer"}}}}
    _, got = world.same("POST", "/j/_search", {"query": {"has_child": {
        "type": "answer", "query": knn}}, "size": 50})
    _, leg = world.same("POST", "/j/_search", {"query": knn, "size": k})
    parents = {int(h["_id"][1:]) % 24 for h in leg["hits"]["hits"]} - {5}
    assert {h["_id"] for h in got["hits"]["hits"]} \
        == {f"q{p}" for p in parents}


@pytest.mark.parametrize("query", [
    {"has_child": {"type": "answer", "query": {"match_all": {}}}},
    {"parent_id": {"type": "answer", "id": "1"}},
], ids=["has_child", "parent_id"])
def test_no_join_field_is_a_400(world, query):
    _, got = world.same("POST", "/plain/_search", {"query": query})
    assert got["status"] == 400


def test_joining_refused_when_expensive_queries_are_off(world):
    body = {"query": JOIN_QUERIES["has_parent_term"],
            "request_cache": False}
    world.ref_node.cluster_settings.setdefault("persistent", {})[
        "search.allow_expensive_queries"] = "false"
    world.port_node.settings["search.allow_expensive_queries"] = "false"
    try:
        _, got = world.same("POST", "/j/_search", body)
        assert got["status"] == 400
        world.same("POST", "/j/_search", {
            "query": JOIN_QUERIES["parent_id"], "request_cache": False})
    finally:
        del world.ref_node.cluster_settings["persistent"][
            "search.allow_expensive_queries"]
        del world.port_node.settings["search.allow_expensive_queries"]


# ----------------------------------------------------------- percolator

STORED = [
    {"match": {"msg": "quick fox"}},
    {"match": {"msg": {"query": "lazy dog", "operator": "and"}}},
    {"bool": {"must": [{"term": {"k": "a"}}, {"range": {"n": {"gte": 3}}}]}},
    {"bool": {"should": [{"term": {"k": "b"}}, {"prefix": {"msg": "qu"}}],
              "minimum_should_match": 1}},
    {"range": {"when": {"gte": "2020-01-01", "lt": "2021-01-01"}}},
    {"terms": {"k": ["c", "d"]}},
    {"exists": {"field": "extra"}},
    {"wildcard": {"k": "z*"}},
    {"match_phrase": {"msg": "quick fox"}},       # skipped: not supported
    {"bool": {"must_not": {"term": {"k": "a"}}}},
    {"ids": {"values": ["1"]}},
]


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def perc(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("perc"), mp)
    pair.same("PUT", "/pq", {"settings": {
        "number_of_shards": request.param}, "mappings": {"properties": {
            "query": {"type": "percolator"}, "msg": {"type": "text"},
            "k": {"type": "keyword"}, "n": {"type": "long"},
            "when": {"type": "date"}}}})
    ops = []
    for i, q in enumerate(STORED):
        ops += [{"index": {"_id": f"s{i}"}}, {"query": q, "n": i}]
    pair.same("POST", "/pq/_bulk", ops, ndjson=True)
    pair.same("POST", "/pq/_refresh")
    yield pair
    pair.close()
    mp.undo()


DOCS = [
    {"msg": "The quick brown fox", "k": "a", "n": 5},
    {"msg": "a lazy dog sleeps", "k": "b", "n": 1, "when": "2020-06-01"},
    {"msg": "nothing here", "k": "zed", "extra": None},
    {"msg": ["quick", "dog"], "k": ["c", "a"], "n": "4"},
]


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_percolate_document(perc, i):
    _, got = perc.same("POST", "/pq/_search", {"query": {"percolate": {
        "field": "query", "document": DOCS[i]}}, "size": 50})
    assert "s8" not in [h["_id"] for h in got["hits"]["hits"]]


def test_percolate_documents(perc):
    _, got = perc.same("POST", "/pq/_search", {"query": {"percolate": {
        "field": "query", "documents": DOCS}}, "size": 50})
    assert _total(got) > 3
    perc.same("POST", "/pq/_search", {"query": {"bool": {
        "filter": [{"percolate": {"field": "query", "documents": DOCS[:2]}},
                   {"range": {"n": {"lt": 5}}}]}}, "size": 50})


@pytest.mark.parametrize("query", [
    {"nope": {"field": "x"}}, {"match": {"msg": "a", "k": "b"}}, "text",
], ids=["unknown_kind", "two_fields", "not_an_object"])
def test_stored_query_that_fails_to_parse(perc, query):
    _, got = perc.same("PUT", "/pq/_doc/bad", {"query": query})
    assert got["status"] == 400
    perc.same("POST", "/pq/_bulk", [{"index": {"_id": "bad"}},
                                    {"query": query}], ndjson=True)
    perc.same("PUT", "/pq/_doc/good", {"query": {"match_all": {}}})
    perc.same("DELETE", "/pq/_doc/good")
