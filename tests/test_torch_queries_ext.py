"""The extended query kinds through both REST layers on the CPU, request
for request (`tests/torch_rest_pair.py`): `more_like_this`, `terms_set`
(by field and by script), the span kinds, `intervals`, `pinned`,
`wrapper`, the geo queries with the `geo_shape` type and
`distance_feature`, each alone, inside a `bool`, and as a `knn` clause's
`filter`; over the seeded mixed index (`tests/torch_mixed.py`) and a
seeded geo index of points, shapes and dates, at 1 and 2 shards. Then
the cases of the reference's own `tests/test_queries_ext.py` (less
nested, parent-join and percolate), `shape` as the reference's unknown
query, the script forms `terms_set` accepts and refuses (no `eval`), and
the cache keys of the lossy `to_dict` forms."""

import base64
import json

import numpy as np
import pytest

from elasticsearch_tpu_torch.search import queries as port_queries
from elasticsearch_tpu_torch.search import queries_ext
from tests.torch_rest_pair import Pair, load_mixed, mixed_vector

CITIES = [("berlin", 52.5163, 13.3777), ("paris", 48.8584, 2.2945),
          ("rome", 41.8902, 12.4922), ("london", 51.5007, -0.1246),
          ("fiji", -17.7134, 178.065), ("samoa", -13.759, -172.1046),
          ("oslo", 59.9139, 10.7522), ("madrid", 40.4168, -3.7038)]


def geo_docs(rng, n: int) -> list:
    docs = []
    for i in range(n):
        name, lat, lon = CITIES[int(rng.integers(len(CITIES)))]
        doc = {"name": name,
               "langs": list(rng.choice(["java", "python", "go", "rust",
                                         "c"], size=int(rng.integers(1, 4)),
                                        replace=False)),
               "required": int(rng.integers(1, 4)),
               "ts": int(1_600_000_000_000 + rng.integers(0, 10 ** 10)),
               "tn": f"2021-0{int(rng.integers(1, 9))}-"
                     f"1{int(rng.integers(0, 9))}T10:00:00."
                     f"{int(rng.integers(0, 10 ** 9)):09d}Z"}
        r = rng.random()
        if r > 0.1:
            doc["loc"] = {"lat": round(lat + rng.normal() * 2, 4),
                          "lon": round(lon + rng.normal() * 2, 4)}
        if r > 0.85:
            doc["loc"] = [doc["loc"], [round(lon, 3), round(lat, 3)]]
        s = rng.random()
        if s < 0.3:
            x, y = round(lon, 2), round(lat, 2)
            doc["area"] = {"type": "envelope",
                           "coordinates": [[x - 2, y + 1], [x + 2, y - 1]]}
        elif s < 0.5:
            doc["area"] = f"POINT ({round(lon, 2)} {round(lat, 2)})"
        elif s < 0.6:
            doc["area"] = {"type": "polygon", "coordinates": [[
                [lon, lat], [lon + 3, lat], [lon + 3, lat + 3], [lon, lat]]]}
        docs.append(doc)
    return docs


def load_geo(pair, name: str, shards: int, seed: int, n: int = 90):
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {
            "name": {"type": "keyword"}, "loc": {"type": "geo_point"},
            "area": {"type": "geo_shape"}, "langs": {"type": "keyword"},
            "required": {"type": "long"}, "ts": {"type": "date"},
            "tn": {"type": "date_nanos"},
            "v": {"type": "dense_vector", "dims": 16,
                  "similarity": "cosine"}}}})
    docs = geo_docs(rng, n)
    ops = []
    for i, d in enumerate(docs):
        ops += [{"index": {"_id": f"{name}{i}"}},
                dict(d, v=mixed_vector(rng))]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    pair.same("POST", f"/{name}/_bulk",
              [{"delete": {"_id": f"{name}{i}"}} for i in range(0, n, 8)],
              ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("ext"), mp)
    load_mixed(pair, "a", request.param, 41)
    load_geo(pair, "g", request.param, 42)
    pair.qv = mixed_vector(np.random.default_rng(43))
    yield pair
    pair.close()
    mp.undo()


def _b64(query) -> str:
    return base64.b64encode(json.dumps(query).encode()).decode()


TEXT_QUERIES = {
    "mlt_text": {"more_like_this": {"fields": ["t"], "like": "alpha beta "
                                    "alpha gamma", "min_term_freq": 1,
                                    "min_doc_freq": 1}},
    "mlt_id": {"more_like_this": {"fields": ["t"], "like": [{"_id": "a3"}],
                                  "min_term_freq": 1, "min_doc_freq": 2,
                                  "minimum_should_match": 1}},
    "mlt_include_unlike": {"more_like_this": {
        "fields": ["t"], "like": [{"_id": "a5"}, "eta eta theta"],
        "unlike": ["theta"], "min_term_freq": 1, "min_doc_freq": 1,
        "include": True, "max_query_terms": 3}},
    "mlt_doc": {"more_like_this": {"like": [{"doc": {"t": "iota kappa "
                                                      "iota"}}],
                                   "min_term_freq": 1, "min_doc_freq": 1}},
    "terms_set_script": {"terms_set": {"t": {
        "terms": ["alpha", "beta", "gamma"],
        "minimum_should_match_script": {
            "source": "min(params.num_terms, 2)"}}}},
    "terms_set_field": {"terms_set": {"tag": {
        "terms": ["red", "blue"], "minimum_should_match_field": "n"}}},
    "span_term": {"span_term": {"t": "alpha"}},
    "span_near_order": {"span_near": {"clauses": [
        {"span_term": {"t": "alpha"}}, {"span_term": {"t": "beta"}}],
        "slop": 2, "in_order": True}},
    "span_near_any": {"span_near": {"clauses": [
        {"span_term": {"t": "gamma"}}, {"span_term": {"t": {"value":
                                                           "gamma"}}},
        {"span_term": {"t": "delta"}}], "slop": 3, "in_order": False}},
    "span_or": {"span_or": {"clauses": [
        {"span_term": {"t": "eta"}}, {"span_term": {"t": "iota"}}]}},
    "span_first": {"span_first": {"match": {"span_term": {"t": "zeta"}},
                                  "end": 2}},
    "span_not": {"span_not": {
        "include": {"span_term": {"t": "alpha"}},
        "exclude": {"span_near": {"clauses": [
            {"span_term": {"t": "alpha"}}, {"span_term": {"t": "omega"}}],
            "slop": 0, "in_order": True}}}},
    "span_multi": {"span_near": {"clauses": [
        {"span_multi": {"match": {"prefix": {"t": {"value": "th"}}}}},
        {"span_multi": {"match": {"wildcard": {"t": "k*a"}}}}],
        "slop": 4, "in_order": False}},
    "intervals_match": {"intervals": {"t": {"match": {
        "query": "alpha beta", "ordered": True, "max_gaps": 2}}}},
    "intervals_all_of": {"intervals": {"t": {"all_of": {
        "intervals": [{"match": {"query": "eta"}},
                      {"any_of": {"intervals": [
                          {"match": {"query": "theta"}},
                          {"prefix": {"prefix": "io"}}]}}],
        "max_gaps": 3}}}},
    "intervals_filter": {"intervals": {"t": {"match": {
        "query": "delta", "filter": {"contained_by": {
            "match": {"query": "alpha delta", "max_gaps": 1}}}}}}},
    "intervals_not_filter": {"intervals": {"t": {"match": {
        "query": "delta", "filter": {"not_containing": {
            "match": {"query": "delta"}}}}}}},
    "intervals_wild_fuzzy": {"intervals": {"t": {"any_of": {"intervals": [
        {"wildcard": {"pattern": "ga?ma"}},
        {"fuzzy": {"term": "kapa"}}],
        "filter": {"before": {"match": {"query": "eps"}}}}}}},
    "intervals_overlapping": {"intervals": {"t": {"all_of": {
        "intervals": [{"match": {"query": "alpha"}},
                      {"match": {"query": "zeta"}}],
        "filter": {"overlapping": {"match": {"query": "beta"}}}}}}},
    "pinned": {"pinned": {"ids": ["a7", "a2", "zz", "a40"],
                          "organic": {"match": {"t": "alpha"}}}},
    "wrapper": {"wrapper": {"query": _b64({"match": {"t": "kappa"}})}},
}

GEO_QUERIES = {
    "geo_distance": {"geo_distance": {"distance": "400km",
                                      "loc": {"lat": 50.0, "lon": 5.0}}},
    "geo_distance_str": {"geo_distance": {"distance": 600_000,
                                          "loc": "46.0,8.0",
                                          "distance_type": "arc"}},
    "geo_bbox": {"geo_bounding_box": {"loc": {
        "top_left": {"lat": 55.0, "lon": -2.0},
        "bottom_right": {"lat": 45.0, "lon": 15.0}}}},
    "geo_bbox_dateline": {"geo_bounding_box": {"loc": {
        "top_left": [170.0, 0.0], "bottom_right": [-170.0, -30.0]}}},
    "geo_polygon": {"geo_polygon": {"loc": {"points": [
        {"lat": 45.0, "lon": 5.0}, {"lat": 45.0, "lon": 18.0},
        {"lat": 36.0, "lon": 12.0}]}}},
    "geo_shape_intersects": {"geo_shape": {"area": {"shape": {
        "type": "envelope", "coordinates": [[0.0, 55.0], [15.0, 45.0]]}}}},
    "geo_shape_within": {"geo_shape": {"area": {"shape": {
        "type": "envelope", "coordinates": [[-10.0, 60.0], [20.0, 35.0]]},
        "relation": "within"}}},
    "geo_shape_disjoint": {"geo_shape": {"area": {
        "shape": "ENVELOPE(-5, 20, 55, 40)", "relation": "disjoint"}}},
    "geo_shape_contains": {"geo_shape": {"area": {
        "shape": {"type": "point", "coordinates": [12.49, 41.89]},
        "relation": "contains"}}},
    "geo_shape_point_field": {"geo_shape": {"loc": {"shape": {
        "type": "polygon", "coordinates": [[[0, 40], [15, 40], [15, 55],
                                            [0, 40]]]}}}},
    "distance_feature_geo": {"distance_feature": {
        "field": "loc", "origin": {"lat": 48.85, "lon": 2.35},
        "pivot": "100km"}},
    "distance_feature_date": {"distance_feature": {
        "field": "ts", "origin": "2021-03-01", "pivot": "7d",
        "boost": 2.0}},
    "distance_feature_nanos": {"distance_feature": {
        "field": "tn", "origin": "2021-05-15T00:00:00Z", "pivot": "12h"}},
    "terms_set_field": {"terms_set": {"langs": {
        "terms": ["java", "python", "go"],
        "minimum_should_match_field": "required"}}},
    "terms_set_script": {"terms_set": {"langs": {
        "terms": ["java", "python", "go", "rust"],
        "minimum_should_match_script": {
            "source": "max(1, params.num_terms // 2 - 1) + Math.floor(0.5)"}
    }}},
}


def _bodies(query, qv):
    return ({"query": query, "size": 25},
            {"query": {"bool": {"filter": [query]}}, "size": 5,
             "_source": False},
            {"query": {"bool": {"must": [query],
                                "must_not": [{"term": {"tag": "cyan"}}]}},
             "size": 10, "from": 3},
            {"knn": {"field": "v", "query_vector": qv, "k": 5,
                     "num_candidates": 20, "filter": query},
             "_source": False})


@pytest.mark.parametrize("case", sorted(TEXT_QUERIES))
def test_text_kind_matches_reference(world, case):
    for body in _bodies(TEXT_QUERIES[case], world.qv):
        world.same("POST", "/a/_search", body)
    world.same("POST", "/a/_count", {"query": TEXT_QUERIES[case]})


@pytest.mark.parametrize("case", sorted(GEO_QUERIES))
def test_geo_kind_matches_reference(world, case):
    for body in _bodies(GEO_QUERIES[case], world.qv):
        world.same("POST", "/g/_search", body)
    world.same("POST", "/g/_count", {"query": GEO_QUERIES[case]})
    world.same("POST", "/g,a/_search", {"query": GEO_QUERIES[case],
                                        "size": 8})


def test_pinned_around_knn_matches_reference(world):
    world.same("POST", "/a/_search", {"query": {"pinned": {
        "ids": ["a11", "a4", "a9"],
        "organic": {"knn": {"field": "v", "query_vector": world.qv,
                            "k": 6, "num_candidates": 30}}}}})


@pytest.mark.parametrize("query", [
    {"shape": {"area": {"shape": {"type": "point",
                                  "coordinates": [1, 2]}}}},
    {"nested": {"path": "x", "query": {"match_all": {}}}},
    {"span_near": {"clauses": [{"span_termx": {"t": "a"}},
                               {"span_term": {"t": "b"}}]}},
    {"span_near": {"clauses": [{"span_multi": {"match": {
        "regexp": {"t": "a.*"}}}}, {"span_term": {"t": "b"}}]}},
    {"intervals": {"t": {"regexp": {"pattern": "a.*"}}}},
    {"intervals": {"t": {"match": {"query": "alpha", "filter": {
        "inside": {"match": {"query": "beta"}}}}}}},
    {"intervals": {"t": {"match": {"query": "alpha", "filter": {
        "before": {"match": {"query": "beta"}},
        "after": {"match": {"query": "beta"}}}}}}},
    {"geo_shape": {"area": {"indexed_shape": {"id": "x"}}}},
    {"terms_set": {"t": {"terms": ["alpha"]}, "tag": {}}},
    {"terms_set": {"t": {"terms": ["alpha"], "minimum_should_match_script":
                         {"source": "Math.min(params.num_terms, 2)"}}}},
    {"terms_set": {"t": {"terms": ["alpha"], "minimum_should_match_script":
                         {"source": "().__class__.__mro__"}}}},
    {"terms_set": {"t": {"terms": ["alpha"], "minimum_should_match_script":
                         {"source": "num_terms / 0"}}}},
], ids=["shape", "nested", "unknown_span", "span_multi_regexp",
        "intervals_rule", "intervals_filter_mode", "intervals_filter_two",
        "indexed_shape", "terms_set_two_fields", "math_min",
        "attribute_walk", "division"])
def test_refusals_match_reference(world, query):
    """The reference's 400 for each (status, type and the reason's first
    words); `nested` on a path no document holds, once refused by the
    port, answers as the reference."""
    if "nested" in query:
        world.same("POST", "/a/_search", {"query": query})
        return
    s1, want = world.ref("POST", "/a/_search", {"query": query})
    s2, got = world.port("POST", "/a/_search", {"query": query})
    assert s1 == s2 == 400, (want, got)
    assert got["error"]["type"] == want["error"]["type"]
    if "terms_set" in query:
        prefix = "failed to evaluate minimum_should_match_script"
        assert want["error"]["reason"].startswith(prefix) \
            == got["error"]["reason"].startswith(prefix)
    else:
        assert got["error"]["reason"] == want["error"]["reason"]


# -------------------------------------- the reference's test_queries_ext.py

@pytest.fixture()
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _seed_places(pair):
    pair.same("PUT", "/places", {"mappings": {"properties": {
        "location": {"type": "geo_point"}, "name": {"type": "keyword"}}}})
    for name, lat, lon in CITIES[:4]:
        pair.same("PUT", f"/places/_doc/{name}",
                  {"name": name, "location": {"lat": lat, "lon": lon}})
    pair.same("POST", "/places/_refresh")


@pytest.mark.parametrize("query,want", [
    ({"geo_distance": {"distance": "400km",
                       "location": {"lat": 48.85, "lon": 2.35}}},
     {"paris", "london"}),
    ({"geo_bounding_box": {"location": {
        "top_left": {"lat": 53.0, "lon": 0.0},
        "bottom_right": {"lat": 48.0, "lon": 14.0}}}},
     {"berlin", "paris"}),
    ({"geo_polygon": {"location": {"points": [
        {"lat": 43.0, "lon": 11.0}, {"lat": 43.0, "lon": 14.0},
        {"lat": 40.0, "lon": 12.5}]}}}, {"rome"}),
], ids=["distance", "bounding_box", "polygon"])
def test_reference_geo_cases(pair, query, want):
    _seed_places(pair)
    _, got = pair.same("POST", "/places/_search", {"query": query})
    assert {h["_id"] for h in got["hits"]["hits"]} == want


def test_reference_distance_feature_case(pair):
    _seed_places(pair)
    _, got = pair.same("POST", "/places/_search", {"query": {
        "distance_feature": {"field": "location",
                             "origin": {"lat": 48.85, "lon": 2.35},
                             "pivot": "100km"}}})
    assert got["hits"]["hits"][0]["_id"] == "paris"


def test_reference_more_like_this_case(pair):
    docs = {"1": "machine learning on tensor processing units",
            "2": "deep machine learning with tensor hardware accelerators",
            "3": "cooking pasta with tomato sauce",
            "4": "machine learning tensor compilers"}
    for i, text in docs.items():
        pair.same("PUT", f"/articles/_doc/{i}", {"body": text})
    pair.same("POST", "/articles/_refresh")
    _, got = pair.same("POST", "/articles/_search", {"query": {
        "more_like_this": {"fields": ["body"], "like": [{"_id": "1"}],
                           "min_term_freq": 1, "min_doc_freq": 2,
                           "minimum_should_match": 1}}})
    ids = {h["_id"] for h in got["hits"]["hits"]}
    assert "1" not in ids and {"2", "4"} <= ids and "3" not in ids


def test_reference_terms_set_case(pair):
    pair.same("PUT", "/skills", {"mappings": {"properties": {
        "langs": {"type": "keyword"}, "required": {"type": "long"}}}})
    pair.same("PUT", "/skills/_doc/1",
              {"langs": ["java", "python", "go"], "required": 2})
    pair.same("PUT", "/skills/_doc/2", {"langs": ["java"], "required": 2})
    pair.same("POST", "/skills/_refresh")
    _, got = pair.same("POST", "/skills/_search", {"query": {"terms_set": {
        "langs": {"terms": ["java", "python"],
                  "minimum_should_match_field": "required"}}}})
    assert [h["_id"] for h in got["hits"]["hits"]] == ["1"]


def _seed_texts(pair):
    pair.same("PUT", "/texts/_doc/1",
              {"line": "the quick brown fox jumps over the lazy dog"})
    pair.same("PUT", "/texts/_doc/2",
              {"line": "the dog was quick and brown was the fox"})
    pair.same("POST", "/texts/_refresh")


@pytest.mark.parametrize("query,want", [
    ({"span_near": {"clauses": [{"span_term": {"line": "quick"}},
                                {"span_term": {"line": "fox"}}],
                    "slop": 1, "in_order": True}}, {"1"}),
    ({"span_first": {"match": {"span_term": {"line": "dog"}}, "end": 3}},
     {"2"}),
    ({"span_not": {"include": {"span_term": {"line": "fox"}},
                   "exclude": {"span_near": {"clauses": [
                       {"span_term": {"line": "brown"}},
                       {"span_term": {"line": "fox"}}],
                       "slop": 0, "in_order": True}}}}, {"2"}),
    ({"intervals": {"line": {"match": {"query": "quick fox",
                                       "ordered": True, "max_gaps": 2}}}},
     {"1"}),
], ids=["span_near", "span_first", "span_not", "intervals"])
def test_reference_span_cases(pair, query, want):
    _seed_texts(pair)
    _, got = pair.same("POST", "/texts/_search", {"query": query})
    assert {h["_id"] for h in got["hits"]["hits"]} == want


def test_reference_wrapper_and_pinned_cases(pair):
    pair.same("PUT", "/w/_doc/1", {"k": "v"})
    pair.same("POST", "/w/_refresh")
    _, got = pair.same("POST", "/w/_search", {"query": {"wrapper": {
        "query": _b64({"term": {"k": "v"}})}}})
    assert [h["_id"] for h in got["hits"]["hits"]] == ["1"]
    for i in range(5):
        pair.same("PUT", f"/prods/_doc/{i}",
                  {"t": "widget widget" if i < 3 else "widget"})
    pair.same("POST", "/prods/_refresh")
    _, got = pair.same("POST", "/prods/_search", {"query": {"pinned": {
        "ids": ["4", "3"], "organic": {"match": {"t": "widget"}}}}})
    assert [h["_id"] for h in got["hits"]["hits"][:2]] == ["4", "3"]


# ------------------------------------------------- scripts and cache keys

@pytest.mark.parametrize("source,want", [
    ("2", 2), ("params.num_terms", 5), ("params.num_terms - 2", 3),
    ("min(params.num_terms, 3) * 2 % 5", 1), ("max(1, 7 // 2)", 3),
    ("(params.num_terms + 1) / 4", 1.5), ("Math.floor(params.num_terms / 2)",
                                          2), ("Math.pow(2, 3)", 8.0),
    ("-params.num_terms + 10", 5), ("2 ** 3", 8),
], ids=["number", "num_terms", "minus", "min_mod", "max_floordiv", "div",
        "floor", "pow", "negate", "power"])
def test_msm_script_forms(source, want):
    """Each form the reference's `eval` accepts gives its value."""
    assert queries_ext.eval_msm_script(source, 5) == want
    assert eval(source.replace("params.num_terms", "num_terms"),  # noqa: S307
                {"__builtins__": {}}, {"num_terms": 5, "min": min,
                                       "max": max,
                                       "Math": __import__("math")}) == want


@pytest.mark.parametrize("source", [
    "Math.min(params.num_terms, 2)", "().__class__.__mro__",
    "open('x')", "[].append", "num_terms if 1 else 2",
    "(lambda: 1)()", "Math.__dict__", "9 ** 9 ** 9"])
def test_msm_script_refusals(source):
    with pytest.raises(Exception) as e:
        queries_ext.eval_msm_script(source, 3)
    assert str(e.value).startswith(
        "failed to evaluate minimum_should_match_script")


def test_no_eval_in_the_port():
    import os
    import re
    root = os.path.dirname(port_queries.__file__)
    root = os.path.dirname(root)
    pat = re.compile(r"(^|[^.a-zA-Z_])(eval|exec)\(")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                for line in open(os.path.join(dirpath, f)):
                    assert not pat.search(line) or "def eval" in line, \
                        (f, line)


@pytest.mark.parametrize("query,exact", [
    ({"more_like_this": {"fields": ["t"], "like": "x"}}, True),
    ({"more_like_this": {"fields": ["t"], "like": "x",
                         "min_term_freq": 1}}, False),
    ({"more_like_this": {"fields": ["t"], "like": "x", "unlike": "y"}},
     False),
    ({"terms_set": {"t": {"terms": ["a"]}}}, True),
    ({"terms_set": {"t": {"terms": ["a"],
                          "minimum_should_match_field": "n"}}}, False),
    ({"terms_set": {"t": {"terms": ["a"], "minimum_should_match_script":
                          {"source": "1"}}}}, False),
    ({"geo_shape": {"area": {"shape": "POINT (1 2)"}}}, False),
    ({"distance_feature": {"field": "ts", "origin": "now",
                           "pivot": "1d"}}, True),
    ({"distance_feature": {"field": "ts", "origin": "now", "pivot": "1d",
                           "boost": 3}}, False),
    ({"pinned": {"ids": ["1"], "organic": {"match": {
        "t": {"query": "a", "fuzziness": 1}}}}}, False),
    ({"pinned": {"ids": ["1"], "organic": {"term": {"t": "a"}}}}, True),
    ({"span_near": {"clauses": [{"span_term": {"t": "a"}}], "slop": 3}},
     True),
    ({"geo_distance": {"distance": "1km", "p": [1, 2]}}, True),
], ids=["mlt", "mlt_tf", "mlt_unlike", "terms_set", "terms_set_field",
        "terms_set_script", "geo_shape", "distance_feature",
        "distance_feature_boost", "pinned_lossy", "pinned", "span",
        "geo_distance"])
def test_lossy_forms_are_not_cached(query, exact):
    """A clause whose reference `to_dict` drops an option that changes
    rows or scores never keys the query cache (`key_is_exact`)."""
    assert port_queries.parse_query(query).key_is_exact() is exact


def test_lossy_form_clauses_keep_their_own_rows(world):
    """Two `terms_set` filters that differ only in their script share the
    reference's cache key; the port evaluates each."""
    for src in ("1", "3", "1"):
        body = {"query": {"bool": {"filter": [{"terms_set": {"langs": {
            "terms": ["java", "python", "go"],
            "minimum_should_match_script": {"source": src}}}}]}},
            "size": 100, "request_cache": False}
        s, got = world.port("POST", "/g/_search", body)
        want = world.port("POST", "/g/_search", {
            "query": body["query"]["bool"]["filter"][0], "size": 100,
            "request_cache": False})[1]
        assert s == 200
        assert {h["_id"] for h in got["hits"]["hits"]} \
            == {h["_id"] for h in want["hits"]["hits"]}


ALL_QUERIES = {**{f"text_{k}": v for k, v in TEXT_QUERIES.items()},
               **{f"geo_{k}": v for k, v in GEO_QUERIES.items()}}


@pytest.mark.parametrize("case", sorted(ALL_QUERIES))
def test_to_dict_matches_reference(case):
    """Each kind's canonical form (the query cache's key) is the
    reference's string."""
    from elasticsearch_tpu.search.queries import parse_query as ref_parse

    def canonical(q):
        return json.dumps(q.to_dict(), sort_keys=True, default=str)

    body = ALL_QUERIES[case]
    assert canonical(port_queries.parse_query(body)) \
        == canonical(ref_parse(body))
