"""`knn` as a query clause, the coordinator's merge and the general RRF
path through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`), on ~200 seeded mixed documents an index:
the clause's `to_dict` byte for byte the reference's (the query cache's
key), the clause alone, in `bool.should`, with a filter and as a
`rescore_query`; windows of several indices (`a,b`, `a*`) merged by sort
key, with the cross-index collapse and its `inner_hits`; `rank: {rrf}`
over `x1,x2`, `x*` and `_all` (`query` + `knn`, a `knn` list,
`sub_searches`), and one-index hybrid bodies with `highlight` (the general
path) and with `docvalue_fields` (the fused one)."""

import json

import pytest

from elasticsearch_tpu.search.queries import parse_query as ref_parse
from elasticsearch_tpu_torch.search.queries import parse_query
from tests.torch_rest_pair import Pair, hit_ids, load_mixed, mixed_vector


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


KNN_CLAUSES = {
    "plain": {"field": "v", "query_vector": [0.5, -1.0, 2.0], "k": 5},
    "defaults": {"field": "v", "query_vector": [1, 2, 3]},
    "candidates": {"field": "v", "query_vector": [0.25, 0.5, 0.75],
                   "k": 7, "num_candidates": 3, "boost": 2.0},
    "filtered": {"field": "v", "query_vector": [1.0, 0.0, -1.0], "k": 4,
                 "num_candidates": 20,
                 "filter": {"bool": {"filter": [{"term": {"tag": "red"}}],
                                     "must_not": [{"range": {
                                         "n": {"gte": 10}}}]}}},
}


@pytest.mark.parametrize("case", sorted(KNN_CLAUSES))
def test_knn_clause_to_dict_matches_reference(case):
    body = {"knn": KNN_CLAUSES[case]}
    got = json.dumps(parse_query(body).to_dict(), sort_keys=True,
                     default=str)
    want = json.dumps(ref_parse(body).to_dict(), sort_keys=True,
                      default=str)
    assert got == want


@pytest.mark.parametrize("shards", [1, 2])
def test_knn_clause(pair, shards):
    rng = load_mixed(pair, "a", shards, 21)
    knn = {"field": "v", "query_vector": mixed_vector(rng), "k": 8,
           "num_candidates": 30}
    for body in (
            {"query": {"knn": knn}},
            {"query": {"knn": dict(knn, filter={"term": {"tag": "red"}})},
             "size": 20},
            {"query": {"bool": {"should": [{"knn": knn},
                                           {"match": {"t": "alpha"}}]}},
             "size": 20},
            {"query": {"bool": {"must": [{"knn": knn}],
                                "filter": [{"exists": {"field": "n"}}]}}},
            {"query": {"match": {"t": "beta gamma"}}, "size": 15,
             "rescore": {"window_size": 10, "query": {
                 "rescore_query": {"knn": knn},
                 "rescore_query_weight": 3.0}}},
            {"query": {"knn": knn}, "sort": [{"n": "desc"}, "_doc"]}):
        pair.same("POST", "/a/_search", body)


@pytest.mark.parametrize("shards", [1, 2])
def test_merge_by_sort_key_and_collapse(pair, shards):
    load_mixed(pair, "a", shards, 22)
    load_mixed(pair, "ab", 1, 23, n=120)
    rng = load_mixed(pair, "b", shards, 24, n=150)
    knn = {"field": "v", "query_vector": mixed_vector(rng), "k": 12,
           "num_candidates": 40}
    for expr in ("a,b", "b,a", "a*", "_all"):
        for body in (
                {"sort": [{"n": "desc"}, {"f": "asc"}], "size": 25},
                {"sort": [{"tag": "desc"}, {"n": "asc"}], "size": 12,
                 "from": 5},
                {"sort": [{"b": "asc"}, "_score"],
                 "query": {"match": {"t": "alpha eta"}}, "size": 30},
                {"query": {"match": {"t": "gamma"}},
                 "collapse": {"field": "tag"}},
                {"query": {"match": {"t": "delta kappa"}}, "size": 4,
                 "collapse": {"field": "n", "inner_hits": {
                     "name": "more", "size": 3}}},
                {"sort": [{"f": "desc"}], "size": 5,
                 "collapse": {"field": "tag", "inner_hits": [
                     {"name": "by_f", "size": 2, "sort": [{"f": "asc"}]}]}},
                {"knn": knn, "post_filter": {"term": {"b": True}},
                 "version": True, "docvalue_fields": ["n"]},
                {"sort": [{"n": "asc"}, "_doc"], "size": 10,
                 "search_after": [7, 0]}):
            pair.same("POST", f"/{expr}/_search", body)


def _rrf_bodies(rng):
    v1, v2 = mixed_vector(rng), mixed_vector(rng)
    knn = {"field": "v", "query_vector": v1, "k": 10, "num_candidates": 40}
    return [
        {"query": {"match": {"t": "alpha beta"}}, "knn": knn,
         "rank": {"rrf": {}}},
        {"query": {"term": {"tag": "red"}}, "knn": knn, "size": 5,
         "from": 2, "rank": {"rrf": {"rank_constant": 10,
                                     "rank_window_size": 30}}},
        {"knn": [knn, {"field": "v", "query_vector": v2, "k": 6}],
         "rank": {"rrf": {}}, "_source": ["n", "tag"]},
        {"sub_searches": [{"query": {"match": {"t": "gamma"}}},
                          {"query": {"knn": knn}},
                          {"query": {"range": {"n": {"gte": 15}}}}],
         "rank": {"rrf": {"rank_window_size": 20}}, "size": 15,
         "docvalue_fields": ["n"]},
        {"query": {"match": {"t": "eta"}}, "knn": knn,
         "rank": {"rrf": {}}, "highlight": {"fields": {"t": {}}}},
    ]


@pytest.mark.parametrize("shards", [1, 2])
def test_rrf_over_several_indices(pair, shards):
    load_mixed(pair, "x1", shards, 25)
    rng = load_mixed(pair, "x2", 1, 26, n=150)
    for body in _rrf_bodies(rng):
        for expr in ("x1,x2", "x*", "_all"):
            _, got = pair.same("POST", f"/{expr}/_search", body)
            assert got["hits"]["hits"]
    _, got = pair.same("POST", "/x1,x2/_search", {
        "query": {"match": {"t": "alpha"}}, "rank": {"rrf": {}}})
    assert got["status"] == 400


@pytest.mark.parametrize("shards", [1, 2])
def test_one_index_hybrid_fetch_keys(pair, shards):
    """A one-index hybrid body with `highlight` takes the general path (no
    `_shards`); with `docvalue_fields` it keeps the fused one."""
    rng = load_mixed(pair, "h", shards, 27)
    knn = {"field": "v", "query_vector": mixed_vector(rng), "k": 10,
           "num_candidates": 40}
    body = {"query": {"match": {"t": "alpha theta"}}, "knn": knn,
            "rank": {"rrf": {}}, "highlight": {"fields": {"t": {}}}}
    _, got = pair.same("POST", "/h/_search", body)
    assert "_shards" not in got
    assert any("highlight" in h for h in got["hits"]["hits"])
    body = {"query": {"match": {"t": "alpha theta"}}, "knn": knn,
            "rank": {"rrf": {}}, "docvalue_fields": ["n", "tag"],
            "_source": False}
    s1, want = pair.ref("POST", "/h/_search", body)
    s2, got = pair.port("POST", "/h/_search", dict(body,
                                                   request_cache=False))
    assert s1 == s2 == 200 and "_shards" in got
    pair.match(want["hits"], got["hits"], "fused docvalue_fields")
    assert hit_ids(got) and all("_source" not in h
                                for h in got["hits"]["hits"])
