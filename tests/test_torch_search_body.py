"""The search body beyond `knn` / `query` through both REST layers on the
CPU, request for request (`tests/torch_rest_pair.py`), on ~200 seeded
mixed documents (missing values, deletes, updates) at 1 and 2 shards:
every sort form (`_score`, `_doc`, numeric, boolean and keyword fields,
`order`, `missing`, the string forms), `search_after` across pages,
`post_filter`, `min_score`, the five rescore modes and a list of
rescorers, `collapse` with `inner_hits` and a second-level collapse, the
URL `sort`, each error of the body's checks, a 400 that names each key
left out, and `profile`, `timeout` and `terminate_after` answered as the
reference answers them."""

import pytest

from tests.torch_rest_pair import Pair, load_mixed, mixed_vector, same_profile


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


SORTS = [
    [{"n": "desc"}],
    [{"n": {"order": "asc"}}, {"f": "desc"}],
    ["n", "_doc"],
    [{"f": {"order": "desc", "missing": "_first"}}],
    [{"f": {"missing": 4.5}}],
    [{"n": {"order": "desc", "missing": "_last"}}, "_score"],
    [{"b": "desc"}, {"n": "asc"}],
    [{"tag": "asc"}, {"n": "desc"}],
    [{"tag": {"order": "desc", "missing": "_first"}}, "_doc"],
    [{"s": "desc"}],
    ["_doc"],
    [{"_doc": "desc"}],
    "n",
    {"f": "desc"},
    [{"_score": "asc"}],
    ["_score", {"n": "desc"}],
    [{"unmapped": "asc"}, "_doc"],
]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("sort", SORTS, ids=[str(i) for i in
                                              range(len(SORTS))])
def test_sort(pair, shards, sort):
    load_mixed(pair, "a", shards, 1)
    for body in ({"sort": sort, "size": 30},
                 {"sort": sort, "query": {"match": {"t": "alpha beta"}},
                  "size": 15, "from": 4},
                 {"sort": sort, "query": {"term": {"tag": "red"}},
                  "size": 50, "track_total_hits": 10}):
        pair.same("POST", "/a/_search", body)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("sort", [
    [{"n": "desc"}, "_doc"],
    [{"tag": "asc"}, {"f": "desc"}, "_doc"],
    [{"f": {"order": "asc", "missing": "_first"}}, {"_doc": "desc"}],
    [{"b": "asc"}, "_score", "_doc"],
], ids=["num", "str", "missing", "bool"])
def test_search_after_pages(pair, shards, sort):
    """Pages of 17 through `search_after` from the reference's last `sort`
    tuple, each held to the reference's page; a numeric `after` against a
    keyword clause, a string against a number, and a null compare as
    equal, as in the reference."""
    load_mixed(pair, "a", shards, 2)
    body = {"sort": sort, "size": 17,
            "query": {"match": {"t": "alpha gamma eta"}}}
    want, _ = pair.same("POST", "/a/_search", body)
    pages = 0
    while want["hits"]["hits"] and pages < 20:
        after = want["hits"]["hits"][-1]["sort"]
        want, _ = pair.same("POST", "/a/_search",
                            dict(body, search_after=after))
        pages += 1
    assert pages > 1
    for after in ([3, "x"], ["red", 1], [None, 0], [True]):
        pair.same("POST", "/a/_search", dict(body, search_after=after))


@pytest.mark.parametrize("shards", [1, 2])
def test_post_filter_min_score(pair, shards):
    rng = load_mixed(pair, "a", shards, 3)
    qv = mixed_vector(rng)
    knn = {"field": "v", "query_vector": qv, "k": 20, "num_candidates": 60}
    for body in (
            {"knn": knn, "post_filter": {"term": {"tag": "red"}}},
            {"knn": knn, "post_filter": {"range": {"n": {"gte": 10}}},
             "size": 20},
            {"query": {"match": {"t": "alpha"}},
             "post_filter": {"term": {"b": True}}, "size": 40},
            {"query": {"match": {"t": "alpha beta"}}, "min_score": 1.2,
             "size": 50},
            {"knn": knn, "min_score": 0.6, "size": 20},
            {"query": {"match": {"t": "beta"}}, "min_score": 0.5,
             "post_filter": {"exists": {"field": "f"}},
             "sort": [{"f": "desc"}]}):
        pair.same("POST", "/a/_search", body)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("mode", ["total", "multiply", "max", "min", "avg"])
def test_rescore_modes(pair, shards, mode):
    load_mixed(pair, "a", shards, 4)
    rescore = {"window_size": 8, "query": {
        "rescore_query": {"match": {"t": "gamma delta"}},
        "query_weight": 0.7, "rescore_query_weight": 1.6,
        "score_mode": mode}}
    for body in (
            {"query": {"match": {"t": "alpha beta gamma"}},
             "rescore": rescore, "size": 20},
            {"query": {"match": {"t": "eta"}}, "size": 5, "from": 2,
             "rescore": [rescore, {"window_size": 3, "query": {
                 "rescore_query": {"range": {"n": {"gte": 12}}},
                 "score_mode": mode}}]}):
        pair.same("POST", "/a/_search", body)


@pytest.mark.parametrize("shards", [1, 2])
def test_collapse_inner_hits(pair, shards):
    rng = load_mixed(pair, "a", shards, 5)
    knn = {"field": "v", "query_vector": mixed_vector(rng), "k": 30,
           "num_candidates": 80}
    for body in (
            {"query": {"match": {"t": "alpha theta"}},
             "collapse": {"field": "tag"}},
            {"query": {"match": {"t": "alpha theta"}},
             "collapse": {"field": "tag", "inner_hits": {
                 "name": "top", "size": 2}}},
            {"query": {"match": {"t": "beta"}}, "size": 3, "from": 1,
             "collapse": {"field": "tag", "inner_hits": [
                 {"name": "by_n", "size": 4, "sort": [{"n": "desc"}],
                  "version": True},
                 {"name": "nested", "size": 2, "collapse": {"field": "b"},
                  "_source": ["n", "b"]}]}},
            {"sort": [{"n": "asc"}, "_doc"], "size": 6,
             "collapse": {"field": "s", "inner_hits": {
                 "size": 1, "from": 1, "seq_no_primary_term": True,
                 "docvalue_fields": ["n"]}}},
            {"knn": knn, "collapse": {"field": "b", "inner_hits": {
                "size": 2}}},
            {"query": {"term": {"tag": "blue"}}, "size": 0,
             "collapse": {"field": "n"}}):
        pair.same("POST", "/a/_search", body)


@pytest.mark.parametrize("key,body", [
    ("collapse_rescore", {"collapse": {"field": "tag"}, "rescore": {
        "query": {"rescore_query": {"match_all": {}}}}}),
    ("inner_collapse_inner_hits", {"collapse": {"field": "tag", "inner_hits": {
        "collapse": {"field": "b", "inner_hits": {}}}}}),
    ("inner_collapse_collapse", {"collapse": {"field": "tag", "inner_hits": [
        {"name": "x", "collapse": {"field": "b",
                                   "collapse": {"field": "n"}}}]}}),
    ("collapse_search_after", {"collapse": {"field": "tag"},
                               "sort": ["n"], "search_after": [3]}),
    ("search_after_no_sort", {"search_after": [1.0]}),
    ("docvalue_fields_limit", {"docvalue_fields": ["n"] * 101}),
    ("script_fields_limit", {"script_fields": {
        f"f{i}": {"script": "1"} for i in range(33)}}),
    ("rescore_window", {"rescore": {"window_size": 10_001, "query": {
        "rescore_query": {"match_all": {}}}}}),
    ("unknown_key", {"sorting": ["n"]}),
    ("negative_from", {"from": -1}),
])
def test_body_errors(pair, key, body):
    load_mixed(pair, "a", 1, 6, n=40)
    want, got = pair.same("POST", "/a/_search", body)
    assert got["status"] == 400, got


@pytest.mark.parametrize("key,value", [
    ("aggs", {"x": {"rare_terms": {"field": "tag"}}}),
    ("aggregations", {"x": {"max_bucket": {"buckets_path": "y"}}}),
    ("slice", {"id": 0, "max": 2}), ("scroll", "1m"),
    ("pit", {"id": "x"}), ("point_in_time", {"id": "x"}),
    ("runtime_mappings", {"r": {"type": "long"}}),
    ("indices_boost", [{"a": 2.0}]),
])
def test_left_out_keys_name_themselves(pair, key, value):
    """The keys once left out (`slice`, `scroll`, `pit`, `point_in_time`,
    `runtime_mappings`, `indices_boost`, and the aggregation kinds
    `rare_terms` and `max_bucket`) answer as the reference, at one shard
    and at two; a `max_bucket` whose path names no aggregation is the
    reference's 400."""
    load_mixed(pair, "a", 1, 7, n=30)
    load_mixed(pair, "a2", 2, 8, n=30)
    for index in ("a", "a2"):
        want, got = pair.same("POST", f"/{index}/_search", {key: value})
        if key == "aggregations":
            assert got["status"] == 400, got
    pair.same("POST", "/a/_search", {"sort": [
        {"_script": {"type": "number", "script": "1"}}]})


@pytest.mark.parametrize("key,value", [
    ("profile", True), ("timeout", "1s"), ("terminate_after", 5)])
def test_telemetry_keys_answer_as_the_reference(pair, key, value):
    """The keys the telemetry slice serves: the same hits as the
    reference, a `profile` of the same structure (`same_profile`), and
    `timed_out` false whatever `timeout` and `terminate_after` say."""
    load_mixed(pair, "a", 1, 7, n=30)
    for body in ({key: value},
                 {key: value, "query": {"match": {"t": "alpha beta"}},
                  "sort": [{"n": "desc"}], "size": 12}):
        if key == "profile":
            same_profile(pair, "/a/_search", body)
        else:
            _, got = pair.same("POST", "/a/_search", body)
            assert got["timed_out"] is False


@pytest.mark.parametrize("shards", [1, 2])
def test_url_sort(pair, shards):
    load_mixed(pair, "a", shards, 8)
    for sort in ("n:desc", "n:desc,_doc", "tag:asc,f:desc", "n", "f:asc"):
        pair.same("GET", "/a/_search", query={"sort": sort, "size": "25"})
        pair.same("POST", "/a/_search", {"query": {"match": {"t": "eta"}}},
                  query={"sort": sort})
