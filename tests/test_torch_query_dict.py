"""The queries' canonical form: for every query kind the port parses, the
port's `json.dumps(q.to_dict(), sort_keys=True, default=str)` equals the
reference's string byte for byte (numbers given as strings, `terms` lists,
`range` with `gt` / `lt` / `format`, `bool` with `minimum_should_match`,
`match` with `operator` and `fuzziness`, `sparse_vector` /
`weighted_tokens`, the `rank_feature` functions, `late_interaction`, `knn`
specs, the multi-term kinds, `query_string`, `dis_max`, `boosting`,
`function_score`, `script_score`), each new kind's `key_is_exact`, and
equivalent sources share one string, as they share one node query cache
entry. Then the same `bool` filters through both packages' REST layers at
1 and 3 shards: the same hits and the same query cache hit and miss
counts."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.search.knn_query import KnnQuery as RefKnnQuery
from elasticsearch_tpu.search.queries import parse_query as ref_parse
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.search.service import parse_knn

D = 8

QUERIES = {
    "term_keyword": {"term": {"tag": "even"}},
    "term_value_boost": {"term": {"tag": {"value": "odd", "boost": 2}}},
    "term_number": {"term": {"n": 7}},
    "term_number_as_string": {"term": {"n": "7"}},
    "term_bool": {"term": {"flag": True}},
    "term_id": {"term": {"_id": "d3"}},
    "term_text": {"term": {"title": "alpha"}},
    "terms_list": {"terms": {"tag": ["even", "odd"]}},
    "terms_numbers_as_strings": {"terms": {"n": ["1", "2", 3],
                                           "boost": 1.5}},
    "match_text": {"match": {"title": "alpha beta"}},
    "match_operator": {"match": {"title": {"query": "alpha beta",
                                           "operator": "AND"}}},
    "match_msm": {"match": {"title": {"query": "alpha beta gamma",
                                      "minimum_should_match": "2",
                                      "boost": 3.0}}},
    "match_phrase": {"match_phrase": {"title": "alpha beta"}},
    "match_phrase_slop": {"match_phrase": {"title": {"query": "alpha gamma",
                                                     "slop": 2}}},
    "multi_match": {"multi_match": {"query": "alpha", "fields": ["title",
                                                                 "body^2"]}},
    "multi_match_type": {"multi_match": {"query": "beta", "fields": ["t*"],
                                         "type": "most_fields"}},
    "multi_match_operator": {"multi_match": {
        "query": "alpha beta", "fields": ["title", "body"],
        "operator": "and"}},
    "range_gte_lt": {"range": {"n": {"gte": 10, "lt": 40}}},
    "range_gt_lte": {"range": {"n": {"gt": 5, "lte": 25.5}}},
    "range_strings": {"range": {"n": {"gte": "10", "lte": "30"}}},
    "range_from_to": {"range": {"n": {"from": 3, "to": 9}}},
    "range_format_boost": {"range": {"n": {"gte": 1, "format": "x",
                                           "boost": 2}}},
    "range_keyword": {"range": {"tag": {"gte": "e", "lt": "f"}}},
    "exists": {"exists": {"field": "tag"}},
    "ids": {"ids": {"values": ["d1", "d5", 7]}},
    "match_all": {"match_all": {}},
    "match_all_boost": {"match_all": {"boost": 2.0}},
    "match_none": {"match_none": {}},
    "constant_score": {"constant_score": {"filter": {"term": {"tag": "odd"}},
                                          "boost": 1.2}},
    "bool_dict_clause": {"bool": {"filter": {"term": {"tag": "even"}}}},
    "bool_list_clause": {"bool": {"filter": [{"term": {"tag": "even"}}]}},
    "bool_all_clauses": {"bool": {
        "must": [{"match": {"title": "alpha"}}],
        "filter": [{"range": {"n": {"gte": 2}}}],
        "should": [{"term": {"tag": "odd"}}, {"term": {"flag": False}}],
        "must_not": {"ids": {"values": ["d9"]}},
        "minimum_should_match": 1}},
    "bool_msm_percent": {"bool": {"should": [
        {"term": {"tag": "odd"}}, {"term": {"n": 3}},
        {"match": {"title": "beta"}}], "minimum_should_match": "50%"}},
    "bool_nested": {"bool": {"filter": [{"bool": {
        "filter": [{"terms": {"tag": ["even"]}}],
        "must_not": [{"range": {"n": {"lt": 3}}}]}}], "boost": 2}},
    "sparse_vector": {"sparse_vector": {"field": "tokens", "query_vector": {
        "t1": 1.5, "t2": 2, "t9": "0.25"}}},
    "sparse_vector_boost": {"sparse_vector": {
        "field": "tokens", "query_vector": {"t3": 1.0}, "boost": 0.5}},
    "weighted_tokens": {"weighted_tokens": {"tokens": {
        "tokens": {"t4": 0.5, "t1": 2.0}, "boost": 1.5}}},
    "rank_feature": {"rank_feature": {"field": "pop"}},
    "rank_feature_saturation": {"rank_feature": {
        "field": "pop", "saturation": {"pivot": 8}}},
    "rank_feature_log": {"rank_feature": {
        "field": "pop", "log": {"scaling_factor": 4}}},
    "rank_feature_sigmoid": {"rank_feature": {
        "field": "pop", "sigmoid": {"pivot": 10, "exponent": 0.6},
        "boost": 2}},
    "rank_feature_linear": {"rank_feature": {"field": "pop",
                                             "linear": {}}},
    "rank_feature_of_features": {"rank_feature": {"field": "tokens.t1"}},
    "late_interaction": {"late_interaction": {
        "field": "colv", "query_tokens": [[0.5, -0.25, 0.125, 1.0],
                                          [1.0, 0.0, 0.5, -1.0]]}},
    "late_interaction_flat": {"late_interaction": {
        "field": "colv", "query_tokens": [0.5, 0.25, -0.5, 0.75]}},
    "prefix": {"prefix": {"title": "al"}},
    "prefix_value": {"prefix": {"tag": {"value": "ev"}}},
    "wildcard": {"wildcard": {"title": {"value": "*ta"}}},
    "wildcard_key": {"wildcard": {"tag": {"wildcard": "?dd"}}},
    "regexp": {"regexp": {"title": "[ab].*"}},
    "fuzzy": {"fuzzy": {"title": "alpah"}},
    "fuzzy_two": {"fuzzy": {"title": {"value": "gamam", "fuzziness": 2}}},
    "span_multi": {"span_multi": {"match": {"prefix": {"tag": "o"}}}},
    "match_fuzziness": {"match": {"title": {"query": "alpah",
                                            "fuzziness": "AUTO"}}},
    "match_fuzziness_and": {"match": {"title": {
        "query": "alpah betta", "fuzziness": 1, "operator": "and"}}},
    "multi_match_bool_prefix": {"multi_match": {
        "query": "alpha be", "fields": ["title"], "type": "bool_prefix"}},
    "multi_match_bool_prefix_opts": {"multi_match": {
        "query": "alpah be", "fields": ["title", "body"],
        "type": "bool_prefix", "fuzziness": 1,
        "minimum_should_match": 2}},
    "match_phrase_prefix": {"match_phrase_prefix": {"title": "alpha g"}},
    "match_bool_prefix": {"match_bool_prefix": {"title": "beta al"}},
    "match_bool_prefix_and": {"match_bool_prefix": {"title": {
        "query": "gamma de", "operator": "and"}}},
    "query_string": {"query_string": {"query": "alpha OR title:gam*"}},
    "query_string_fields": {"query_string": {
        "query": "gamma delta", "fields": ["body"]}},
    "query_string_and": {"query_string": {
        "query": "beta delta", "default_operator": "AND"}},
    "simple_query_string": {"simple_query_string": {"query": "delta"}},
    "dis_max": {"dis_max": {"queries": [{"term": {"tag": "odd"}},
                                        {"match": {"title": "beta"}}],
                            "tie_breaker": 0.5}},
    "dis_max_lossy": {"dis_max": {"queries": [
        {"match": {"title": {"query": "delta beta gamma",
                             "minimum_should_match": 2}}}]}},
    "boosting": {"boosting": {"positive": {"match": {"title": "alpha"}},
                              "negative": {"term": {"tag": "odd"}},
                              "negative_boost": 0.3}},
    "function_score": {"function_score": {
        "query": {"match": {"title": "gamma"}},
        "field_value_factor": {"field": "n", "modifier": "log1p"}}},
    "function_score_modes": {"function_score": {
        "query": {"range": {"n": {"gte": 3}}},
        "functions": [{"weight": 2}, {"field_value_factor": {
            "field": "pop"}}],
        "score_mode": "sum", "boost_mode": "replace"}},
    "script_score": {"script_score": {
        "query": {"term": {"tag": "even"}},
        "script": {"source": "doc['n'].value + params.a",
                   "params": {"a": 2}}}},
}

# whether each new kind's `to_dict` holds every option that changes its
# rows or scores: the reference's form keeps only the query text of
# `query_string` and `match_bool_prefix`, and leaves out `match`'s
# `fuzziness` and `function_score`'s modes. (Each lossy case above has a
# text of its own: a clause that shares its form with another is served
# the other's rows by the reference's query cache.)
KEY_IS_EXACT = {
    "prefix": True, "wildcard": True, "regexp": True, "fuzzy_two": True,
    "span_multi": True, "match_fuzziness": False,
    "match_fuzziness_and": False, "multi_match_bool_prefix": True,
    "multi_match_bool_prefix_opts": False, "match_phrase_prefix": True,
    "match_bool_prefix": True, "match_bool_prefix_and": False,
    "query_string": True, "query_string_fields": False,
    "query_string_and": False, "simple_query_string": True,
    "dis_max": True, "dis_max_lossy": False, "boosting": True,
    "function_score": True, "function_score_modes": False,
    "script_score": True,
}

KNN_SPECS = {
    "plain": {"field": "emb", "query_vector": [0.1 * i for i in range(D)],
              "k": 5},
    "num_candidates": {"field": "emb", "query_vector": [1.0] * D, "k": 3,
                       "num_candidates": 30},
    "nc_only": {"field": "emb", "query_vector": [0.3] * D,
                "num_candidates": 7},
    "filter": {"field": "emb", "query_vector": [0.5] * D, "k": 4,
               "filter": {"bool": {"filter": [{"term": {"tag": "odd"}}]}}},
}


def _canonical(q) -> str:
    return json.dumps(q.to_dict(), sort_keys=True, default=str)


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_to_dict_matches_reference(case):
    body = QUERIES[case]
    assert _canonical(parse_query(body)) == _canonical(ref_parse(body))


def _ref_knn(spec):
    """The reference's KnnQuery as its query phase builds one from a
    body's `knn` spec."""
    return RefKnnQuery(
        field=spec["field"], query_vector=spec["query_vector"],
        k=int(spec.get("k", spec.get("num_candidates", 10))),
        num_candidates=int(spec.get("num_candidates", spec.get("k", 10))),
        filter_query=ref_parse(spec["filter"]) if spec.get("filter")
        else None, boost=float(spec.get("boost", 1.0)))


@pytest.mark.parametrize("case", sorted(KNN_SPECS))
def test_knn_to_dict_matches_reference(case):
    spec = KNN_SPECS[case]
    assert _canonical(parse_knn(spec)) == _canonical(_ref_knn(spec))


@pytest.mark.parametrize("a,b", [
    ("term_keyword", {"term": {"tag": {"value": "even"}}}),
    ("bool_dict_clause", "bool_list_clause"),
    ("range_from_to", {"range": {"n": {"gte": 3, "lte": 9}}}),
    ("match_all", "match_all_boost"),
])
def test_equivalent_sources_share_one_string(a, b):
    a, b = (QUERIES[x] if isinstance(x, str) else x for x in (a, b))
    assert _canonical(parse_query(a)) == _canonical(parse_query(b))
    assert _canonical(ref_parse(a)) == _canonical(ref_parse(b))


@pytest.mark.parametrize("case", sorted(KEY_IS_EXACT))
def test_key_is_exact(case):
    assert parse_query(QUERIES[case]).key_is_exact() is KEY_IS_EXACT[case]


def test_every_query_class_has_to_dict():
    """No parsed kind falls back to the base class (which raises, and so
    caches nothing)."""
    for body in QUERIES.values():
        parse_query(body).to_dict()


# ----------------------------------------------------- through both nodes

MAPPING = {"properties": {
    "tag": {"type": "keyword"}, "n": {"type": "integer"},
    "flag": {"type": "boolean"}, "title": {"type": "text"},
    "body": {"type": "text"}, "tokens": {"type": "rank_features"},
    "pop": {"type": "rank_feature"},
    "colv": {"type": "rank_vectors", "dims": 4},
    "emb": {"type": "dense_vector", "dims": D, "similarity": "cosine"}}}
WORDS = ["alpha", "beta", "gamma", "delta"]


def _raw(body, ndjson=False):
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return b"" if body is None else json.dumps(body).encode()


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request, tmp_path_factory):
    """Both nodes with the same 80 documents in index `q`, in two
    segments; yields (reference request, port request)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    ref = RefNode(str(tmp_path_factory.mktemp("ref")))
    port = Node(device="cpu")
    ref_rc, port_rc = RefController(), RestController()
    ref_register(ref_rc, ref)
    register_all(port_rc, port)

    def ref_req(method, path, body=None, ndjson=False):
        return ref_rc.dispatch(method, path, {}, _raw(body, ndjson),
                               "application/json")

    def port_req(method, path, body=None, ndjson=False):
        return port_rc.dispatch(method, path, {}, _raw(body, ndjson))

    rng = np.random.default_rng(17)
    docs = []
    for i in range(80):
        docs.append({
            "tag": "even" if i % 2 == 0 else "odd", "n": i % 37,
            "flag": bool(i % 3), "title": " ".join(rng.choice(WORDS, 3)),
            "body": " ".join(rng.choice(WORDS, 2)),
            "tokens": {f"t{t}": float(rng.uniform(0.1, 3.0))
                       for t in rng.choice(10, 3, replace=False)},
            "pop": float(rng.uniform(0.5, 20.0)),
            "colv": rng.standard_normal((2, 4)).tolist(),
            "emb": rng.standard_normal(D).tolist()})
    for req in (ref_req, port_req):
        assert req("PUT", "/q", {
            "settings": {"number_of_shards": request.param},
            "mappings": MAPPING})[0] == 200
        for lo, hi in ((0, 50), (50, 80)):
            bulk = []
            for i in range(lo, hi):
                bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
            status, resp = req("POST", "/q/_bulk", bulk, ndjson=True)
            assert status == 200 and not resp["errors"]
            assert req("POST", "/q/_refresh")[0] == 200
    yield ref_req, port_req
    ref.close()
    mp.undo()


def _query_cache(req):
    status, stats = req("GET", "/_stats/query_cache")
    assert status == 200
    qc = stats["_all"]["primaries"]["query_cache"]
    return qc["hit_count"], qc["miss_count"]


def _delta(before, after):
    return tuple(b - a for a, b in zip(before, after))


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_filters_through_both_nodes(nodes, case):
    """Each query as a `bool` filter clause, sent twice: the same hits,
    and each request moves the query cache's hit and miss counts as the
    reference's move, but for a clause whose `to_dict` leaves out an
    option that changes its rows: the reference caches it under a string
    it shares with other clauses, the port evaluates it every time."""
    ref_req, port_req = nodes
    exact = parse_query(QUERIES[case]).key_is_exact()
    body = {"query": {"bool": {"filter": [QUERIES[case]]}}, "size": 100,
            "_source": False}
    for _ in range(2):
        ref0, port0 = _query_cache(ref_req), _query_cache(port_req)
        s1, want = ref_req("POST", "/q/_search", body)
        s2, got = port_req("POST", "/q/_search", body)
        assert s1 == s2 == 200, (want, got)
        assert got["hits"]["total"] == want["hits"]["total"]
        assert sorted(h["_id"] for h in got["hits"]["hits"]) \
            == sorted(h["_id"] for h in want["hits"]["hits"])
        ref_moved = _delta(ref0, _query_cache(ref_req))
        assert ref_moved != (0, 0)
        assert _delta(port0, _query_cache(port_req)) \
            == (ref_moved if exact else (0, 0))


def test_equivalent_forms_hit_one_entry(nodes):
    """A clause sent in one form, then in its equivalent form: the second
    is a query cache hit on both nodes."""
    ref_req, port_req = nodes
    forms = ({"bool": {"filter": {"term": {"tag": {"value": "odd"}}},
                       "must_not": {"term": {"n": 4}}}},
             {"bool": {"filter": [{"term": {"tag": "odd"}}],
                       "must_not": [{"term": {"n": 4}}]}})
    ref0, port0 = _query_cache(ref_req), _query_cache(port_req)
    hits = []
    for form in forms:
        for req in (ref_req, port_req):
            status, _resp = req("POST", "/q/_search", {"query": form})
            assert status == 200
        hits.append(_delta(port0, _query_cache(port_req)))
        assert _delta(ref0, _query_cache(ref_req)) == hits[-1]
    assert hits[1][0] == hits[0][0] + 1
    assert hits[1][1] == hits[0][1]
