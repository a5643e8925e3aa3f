"""The port's filter queries (`search/queries.py`) and its keyword, numeric
and boolean mappers against the reference `Node` on the CPU: the same
mapping, the same documents (made from a seed with numpy, over `_bulk`,
in two segments, with updates that tombstone rows, multi-valued fields
and missing fields), and the same `_search {query}` bodies through both
REST layers. Term-level scores are constant boosts, so hits must match
exactly: ids in order, scores, total and max_score. Errors must have the
same status and type."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import DocValuesColumn
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController

N_DOCS = 240
KEYWORDS = ["red", "green", "blue", "Blue", "a b", "zeta"]

MAPPING = {"properties": {
    "v": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
    "kw": {"type": "keyword"},
    "tags": {"type": "keyword"},
    "short_kw": {"type": "keyword", "ignore_above": 4},
    "n": {"type": "integer"},
    "big": {"type": "long"},
    "s": {"type": "short"},
    "by": {"type": "byte"},
    "f": {"type": "float"},
    "d": {"type": "double"},
    "h": {"type": "half_float"},
    "sf": {"type": "scaled_float", "scaling_factor": 10},
    "m": {"type": "long"},
    "b": {"type": "boolean"},
    "lax": {"type": "integer", "ignore_malformed": True},
}}


def _raw(body, ndjson=False):
    if body is None:
        return b""
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return json.dumps(body).encode()


def _doc(rng, i):
    """Document i: each field present with some probability, some of them
    multi-valued."""
    doc = {"v": rng.standard_normal(4).astype(np.float32).tolist()}
    if rng.random() < 0.9:
        doc["kw"] = KEYWORDS[int(rng.integers(len(KEYWORDS)))]
    if rng.random() < 0.7:
        doc["tags"] = [KEYWORDS[int(j)] for j in
                       rng.integers(len(KEYWORDS), size=rng.integers(1, 4))]
    if rng.random() < 0.5:
        doc["short_kw"] = ["ab", "abcdef"][int(rng.integers(2))]
    if rng.random() < 0.85:
        doc["n"] = int(rng.integers(-20, 50))
    if i % 7 == 0:
        doc["n"] = [int(rng.integers(-20, 50)), int(rng.integers(-20, 50))]
    if rng.random() < 0.3:
        doc["big"] = int(rng.integers(0, 2**62))
    doc["s"] = int(rng.integers(-300, 300))
    doc["by"] = str(int(rng.integers(-100, 100)))     # numeric string
    if rng.random() < 0.9:
        doc["f"] = float(np.float32(rng.normal(5, 2)).round(2))
    doc["d"] = float(rng.normal(0, 1e3))
    doc["h"] = float(rng.integers(0, 8)) / 2
    doc["sf"] = float(rng.normal(3, 1))
    # the first doc's value is a list: the reference's column is then not
    # numeric, and numeric ranges compare strings
    doc["m"] = [int(rng.integers(0, 9)), 4] if i == 0 \
        else int(rng.integers(0, 9))
    if rng.random() < 0.8:
        doc["b"] = [True, False, "true", "false"][int(rng.integers(4))]
    doc["lax"] = "oops" if i % 11 == 0 else int(rng.integers(0, 5))
    return doc


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
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

    rng = np.random.default_rng(97)
    docs = [_doc(rng, i) for i in range(N_DOCS)]
    create = {"settings": {"number_of_shards": 1, "number_of_replicas": 0,
                           "index.max_terms_count": 8},
              "mappings": MAPPING}
    for req in (ref_req, port_req):
        assert req("PUT", "/q", create)[0] == 200
        for lo, hi in ((0, 150), (150, N_DOCS)):      # two segments
            bulk = []
            for i in range(lo, hi):
                bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
            status, resp = req("POST", "/q/_bulk", bulk, ndjson=True)
            assert status == 200 and not resp["errors"], resp["items"][:2]
            assert req("POST", "/q/_refresh")[0] == 200
        # updates tombstone rows in both segments; d3 loses its keyword
        for i in (3, 40, 170):
            doc = dict(docs[i], kw="green", n=7)
            if i == 3:
                del doc["kw"]
            assert req("PUT", f"/q/_doc/d{i}", doc)[0] in (200, 201)
        assert req("POST", "/q/_refresh")[0] == 200
    yield ref_req, port_req
    ref.close()
    mp.undo()


QUERIES = {
    "match_all": {"match_all": {}},
    "match_all_boost": {"match_all": {"boost": 2.5}},
    "match_none": {"match_none": {}},
    "term_kw": {"term": {"kw": "blue"}},
    "term_kw_case": {"term": {"kw": "Blue"}},
    "term_kw_space": {"term": {"kw": {"value": "a b", "boost": 3.0}}},
    "term_kw_absent": {"term": {"kw": "purple"}},
    "term_tags_multi": {"term": {"tags": "zeta"}},
    "term_ignore_above": {"term": {"short_kw": "abcdef"}},
    "term_ignore_above_kept": {"term": {"short_kw": "ab"}},
    "term_int": {"term": {"n": 7}},
    "term_int_string": {"term": {"n": "7"}},
    "term_int_float": {"term": {"n": 7.0}},
    "term_int_bad": {"term": {"n": "seven"}},
    "term_multi_int": {"term": {"n": 12}},
    "term_byte_string": {"term": {"by": 5}},
    "term_half": {"term": {"h": 1.5}},
    "term_bool": {"term": {"b": True}},
    "term_bool_string": {"term": {"b": "false"}},
    "term_id": {"term": {"_id": "d17"}},
    "term_id_deleted_row": {"term": {"_id": "d40"}},
    "term_unmapped": {"term": {"nope": "x"}},
    "term_ignored": {"term": {"_ignored": "lax"}},
    "terms_kw": {"terms": {"kw": ["red", "zeta", "purple"]}},
    "terms_boost": {"terms": {"tags": ["blue", "Blue"], "boost": 0.5}},
    "terms_int": {"terms": {"n": [1, 2, "3", 44]}},
    "terms_bool": {"terms": {"b": [True]}},
    "terms_id": {"terms": {"_id": ["d1", "d2", "d170", "missing"]}},
    "range_int": {"range": {"n": {"gte": 0, "lt": 10}}},
    "range_int_gt_lte": {"range": {"n": {"gt": -5, "lte": 5}}},
    "range_int_open": {"range": {"n": {"gte": 30}}},
    "range_from_to": {"range": {"n": {"from": 3, "to": 9}}},
    "range_float": {"range": {"f": {"gte": 4.5, "lt": 6.25}}},
    "range_double_boost": {"range": {"d": {"lt": 0, "boost": 2.0}}},
    "range_long": {"range": {"big": {"gte": 2**61}}},
    "range_short_string_bound": {"range": {"s": {"gte": "-10",
                                                  "lte": "100"}}},
    "range_scaled": {"range": {"sf": {"gte": 3.0}}},
    "range_listfirst": {"range": {"m": {"gte": 2, "lte": 5}}},
    "range_kw": {"range": {"kw": {"gte": "b", "lt": "r"}}},
    "range_tags": {"range": {"tags": {"gt": "blue"}}},
    "range_bool": {"range": {"b": {"gte": 1}}},
    "exists_kw": {"exists": {"field": "kw"}},
    "exists_int": {"exists": {"field": "n"}},
    "exists_vector": {"exists": {"field": "v"}},
    "exists_bool": {"exists": {"field": "b"}},
    "exists_id": {"exists": {"field": "_id"}},
    "exists_unmapped": {"exists": {"field": "nope"}},
    "ids": {"ids": {"values": ["d5", "d0", "d3", "d999", "d200"]}},
    "constant_score": {"constant_score": {"filter": {"term": {"kw": "red"}},
                                          "boost": 4.0}},
    "bool_filter": {"bool": {"filter": [{"term": {"kw": "blue"}},
                                        {"range": {"n": {"gte": 10}}}]}},
    "bool_must": {"bool": {"must": [{"term": {"kw": "red"}},
                                    {"terms": {"tags": ["red", "zeta"]}}]}},
    "bool_should": {"bool": {"should": [{"term": {"kw": "red"}},
                                        {"term": {"tags": "red"}},
                                        {"term": {"b": True}}]}},
    "bool_should_msm": {"bool": {"should": [
        {"term": {"kw": "red"}}, {"term": {"tags": "red"}},
        {"term": {"b": True}}], "minimum_should_match": 2}},
    "bool_should_msm_pct": {"bool": {"should": [
        {"term": {"kw": "blue"}}, {"term": {"tags": "blue"}},
        {"range": {"n": {"lt": 0}}}], "minimum_should_match": "-34%"}},
    "bool_must_should": {"bool": {"must": {"term": {"kw": "green"}},
                                  "should": [{"range": {"f": {"gt": 5}}}]}},
    "bool_filter_should_msm": {"bool": {
        "filter": {"exists": {"field": "tags"}},
        "should": [{"term": {"tags": "zeta"}}, {"term": {"kw": "zeta"}}],
        "minimum_should_match": 1}},
    "bool_must_not_only": {"bool": {"must_not": [{"term": {"kw": "red"}}]}},
    "bool_nested": {"bool": {
        "filter": [{"bool": {"should": [{"term": {"kw": "red"}},
                                        {"term": {"kw": "blue"}}]}}],
        "must_not": [{"range": {"n": {"lt": 0}}}, {"ids": {
            "values": ["d1", "d2"]}}],
        "boost": 2.0}},
}


def _assert_same(want, got):
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]
    assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] \
        == [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]
    for g, w in zip(got["hits"]["hits"], want["hits"]["hits"]):
        assert g.get("_source") == w.get("_source")


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(nodes, name):
    ref_req, port_req = nodes
    body = {"query": QUERIES[name], "size": 300}
    s1, want = ref_req("POST", "/q/_search", body)
    s2, got = port_req("POST", "/q/_search", body)
    assert s1 == s2 == 200, (want, got)
    _assert_same(want, got)


@pytest.mark.parametrize("body", [
    {}, {"size": 5, "from": 3}, {"query": {"term": {"kw": "blue"}},
                                 "size": 2, "from": 4, "_source": ["kw"]},
    {"query": {"match_all": {}}, "track_total_hits": 100, "size": 1},
    {"query": {"match_all": {}}, "track_total_hits": True, "size": 0},
    {"query": {"bool": {"should": [{"term": {"kw": "red"}},
                                   {"term": {"b": False}}]}},
     "size": 7, "_source": False},
])
def test_paging_total_and_source_match_reference(nodes, body):
    ref_req, port_req = nodes
    s1, want = ref_req("POST", "/q/_search", body)
    s2, got = port_req("POST", "/q/_search", body)
    assert s1 == s2 == 200, (want, got)
    _assert_same(want, got)


def test_total_relation_gte_past_ten_thousand(tmp_path):
    """More than 10,000 hits count as `gte` 10,000, as in the reference."""
    port = Node(device="cpu")
    rc = RestController()
    register_all(rc, port)
    port.create_index("big", {"mappings": {"properties": {
        "kw": {"type": "keyword"}}}})
    port.index("big").engine.index_many(
        [str(i) for i in range(10_050)], [{"kw": "x"}] * 10_050)
    port.refresh("big")
    status, resp = rc.dispatch("POST", "/big/_search", {}, _raw(
        {"query": {"term": {"kw": "x"}}, "size": 1}))
    assert status == 200
    assert resp["hits"]["total"] == {"value": 10_000, "relation": "gte"}


@pytest.mark.parametrize("case", [
    ("POST", "/q/_search", {"query": {"nosuchquery": {}}}),
    ("POST", "/q/_search", {"query": {"term": {"kw": "a", "n": 1}}}),
    ("POST", "/q/_search", {"query": {"terms": {"kw": "red"}}}),
    ("POST", "/q/_search", {"query": {"range": {"n": {"gte": "abc"}}}}),
    ("POST", "/q/_search", {"query": {"range": {"b": {"gte": "true"}}}}),
    ("POST", "/q/_search", {"query": {"exists": {"field": "_source"}}}),
    ("POST", "/q/_search", {"query": {"terms": {
        "kw": [f"k{i}" for i in range(9)]}}}),
    ("POST", "/q/_search", {"query": {"bool": {"should": [
        {"term": {"kw": "red"}}], "minimum_should_match": "x%"}}}),
    ("PUT", "/q/_doc/bad1", {"n": "seven"}),
    ("PUT", "/q/_doc/bad2", {"b": "yes"}),
    ("PUT", "/q/_doc/bad3", {"f": "NaN"}),
    ("PUT", "/q/_doc/bad4", {"n": True}),
    ("PUT", "/q/_doc/bad5", {"d": [1.0, "x"]}),
    ("PUT", "/bad_map", {"mappings": {"properties": {
        "x": {"type": "nosuchtype"}}}}),
    ("PUT", "/bad_map2", {"mappings": {"properties": {"x": {}}}}),
])
def test_errors_match_reference(nodes, case):
    ref_req, port_req = nodes
    s1, want = ref_req(*case)
    s2, got = port_req(*case)
    assert s1 == s2 and s1 >= 400, (want, got)
    assert got["error"]["type"] == want["error"]["type"]


def test_unported_query_kind_is_a_400(nodes):
    """No kind is left out any more: `nested` (and its mapping),
    `prefix` and `more_like_this`, each once left out, answer as the
    reference."""
    ref_req, port_req = nodes
    for body in ({"query": {"nested": {"path": "kw", "query": {
                     "match_all": {}}}}, "size": 50},
                 {"query": {"prefix": {"kw": "re"}}, "size": 50},
                 {"query": {"more_like_this": {
                     "fields": ["kw"], "like": "re", "min_term_freq": 1,
                     "min_doc_freq": 1}}, "size": 50}):
        (s1, want), (s2, got) = (ref_req("POST", "/q/_search", body),
                                 port_req("POST", "/q/_search", body))
        assert s1 == s2 == 200
        assert [h["_id"] for h in got["hits"]["hits"]] \
            == [h["_id"] for h in want["hits"]["hits"]]
    body = {"mappings": {"properties": {"x": {"type": "nested"}}}}
    assert port_req("PUT", "/t2", body) == ref_req("PUT", "/t2", body)


def test_doc_values_column_equals_reference_constructor():
    """The numpy column build gives the reference's per-value loop's
    values, float64 view and presence, with lists and a first list."""
    from elasticsearch_tpu.index.segment import DocValuesColumn as RefColumn
    rng = np.random.default_rng(3)
    for first_list in (False, True):
        n = 50
        locs = np.sort(rng.choice(n, 30, replace=False))
        vals = [int(v) if j % 3 else float(v) / 4 for j, v in
                enumerate(rng.integers(-100, 100, len(locs)))]
        vals[5] = [7, 8]
        if first_list:
            vals[0] = [1.5, 2]
        col = DocValuesColumn.build(n, locs, vals)
        ref_vals = [None] * n
        for loc, v in zip(locs, vals):
            ref_vals[loc] = v
        ref = RefColumn(ref_vals)
        assert list(col.values) == ref.values
        np.testing.assert_array_equal(col.present, ref.present)
        if ref.numeric is None:
            assert col.numeric is None
        else:
            np.testing.assert_array_equal(col.numeric, ref.numeric)


def test_parsed_document_equals_reference_parser():
    """Terms and doc values of one document, field by field."""
    from elasticsearch_tpu.index.mapping import MapperService as RefService
    rng = np.random.default_rng(5)
    ref_ms, port_ms = RefService(MAPPING), MapperService(MAPPING)
    for i in range(40):
        doc = _doc(rng, i)
        want = ref_ms.parse_document(f"d{i}", doc)
        got = port_ms.parse_document(doc)
        assert got.terms == want.terms
        assert got.doc_values == want.doc_values
        np.testing.assert_array_equal(got.vectors["v"], want.vectors["v"])
