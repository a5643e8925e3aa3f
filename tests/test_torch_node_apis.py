"""`_explain`, `_validate/query`, `_field_caps`, `_search_shards`,
`_termvectors` and `_analyze` through both REST layers on the CPU, request
for request (`tests/torch_rest_pair.py`).

Tolerance: the pair's 1e-4 on every float, but for a `knn` clause under
`_explain`. The reference scores it on its host in f32; the port scores
it on its store's exact route, over the bf16 rows it keeps, as its
searches do: the two values agree within 2 ** -8 (bf16's relative step),
and the port's value equals the port's own search score within 1e-4.
Node ids differ by design and are mapped."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

D = 8
MAPPING = {"properties": {
    "t": {"type": "text"}, "e": {"type": "text", "analyzer": "english"},
    "k": {"type": "keyword"}, "n": {"type": "long"},
    "v": {"type": "dense_vector", "dims": D, "similarity": "cosine"}}}
WIDE = {"properties": {
    "k": {"type": "keyword", "meta": {"unit": "none"}},
    "t": {"type": "text", "fields": {"raw": {"type": "keyword"}}},
    "l": {"type": "long", "meta": {"unit": "ms"}}, "i": {"type": "integer"},
    "s": {"type": "short"}, "b8": {"type": "byte"}, "d": {"type": "double"},
    "f": {"type": "float"}, "h": {"type": "half_float"},
    "sf": {"type": "scaled_float", "scaling_factor": 100},
    "ok": {"type": "boolean"}, "dt": {"type": "date"},
    "dn": {"type": "date_nanos"}, "ip": {"type": "ip"},
    "gp": {"type": "geo_point"}, "gs": {"type": "geo_shape"},
    "ir": {"type": "integer_range"}, "dr": {"type": "date_range"},
    "nk": {"type": "keyword", "index": False},
    "nd": {"type": "long", "doc_values": False},
    "v": {"type": "dense_vector", "dims": D},
    "rv": {"type": "rank_vectors", "dims": D},
    "rf": {"type": "rank_feature"}, "rfs": {"type": "rank_features"},
    "sv": {"type": "sparse_vector"},
    "obj": {"properties": {"a": {"type": "keyword"},
                           "b": {"properties": {"c": {"type": "long"}}}}},
    "nest": {"type": "nested", "properties": {"x": {"type": "keyword"}}},
    "j": {"type": "join", "relations": {"q": "a"}},
    "pq": {"type": "percolator"}, "bin": {"type": "binary"},
    "sayt": {"type": "search_as_you_type"},
    "tc": {"type": "token_count", "analyzer": "standard"},
    "w": {"type": "wildcard"}, "ck": {"type": "constant_keyword",
                                      "value": "c"},
    "mm": {"type": "murmur3"}, "hg": {"type": "histogram"},
    "fl": {"type": "flattened"}, "at": {"type": "annotated_text"},
    "al": {"type": "alias", "path": "l"}}}


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _vec(i, seed=0):
    return np.random.default_rng(seed * 1000 + i).standard_normal(D) \
        .round(3).tolist()


def _load(pair, name="a", shards=2, n=20, seed=0, settings=None):
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards, **(settings or {})},
        "mappings": MAPPING})
    ops = []
    for i in range(n):
        ops += [{"index": {"_id": str(i)}},
                {"t": f"quick brown fox {i % 4} jumps over fox",
                 "e": f"running runners ran {i}", "k": f"k{i % 3}",
                 "n": i, "v": _vec(i, seed)}]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


_EXPLAIN = [
    ("/a/_explain/3", {"query": {"match": {"t": "fox"}}}, None),
    ("/a/_explain/3", {"query": {"match": {"t": "cat"}}}, None),
    ("/a/_explain/nope", {"query": {"match": {"t": "fox"}}}, None),
    ("/a/_explain/4", {"query": {"bool": {
        "must": [{"match": {"t": "quick"}}],
        "filter": [{"range": {"n": {"gte": 2}}}]}}}, None),
    ("/a/_explain/1", {"query": {"term": {"k": "k1"}}}, None),
    ("/a/_explain/2", {"query": {"term": {"k": "k1"}}}, None),
    ("/a/_explain/5", {"query": {"match_all": {}}}, None),
    ("/a/_explain/5", {"query": {"match": {"e": "run"}}},
     {"_source": "true"}),
    ("/a/_explain/5", {"query": {"match": {"t": "fox"}}},
     {"_source": "false"}),
    ("/a/_explain/5", {"query": {"match": {"t": "fox"}}},
     {"_source": "t,k"}),
    ("/a/_explain/5", {"query": {"match": {"t": "fox"}}},
     {"_source_includes": "n", "_source_excludes": "v"}),
    ("/a/_explain/5", {"query": {"match": {"t": "fox"}}},
     {"_source_excludes": "v,e"}),
    ("/a/_explain/6", None, {"q": "t:brown"}),
    ("/a/_explain/6", None, {"q": "nothing", "df": "t"}),
    ("/a/_explain/6", {}, None),
    ("/a/_explain/6", {"query": {"bogus": {}}}, None),
    ("/x/_explain/7", {"query": {"match": {"t": "fox"}}}, None),
    ("/nope/_explain/7", {"query": {"match": {"t": "fox"}}}, None),
]


@pytest.mark.parametrize("path,body,query", _EXPLAIN)
def test_explain(pair, path, body, query):
    _load(pair)
    pair.same("POST", "/_aliases", {"actions": [{"add": {
        "index": "a", "alias": "x"}}]})
    pair.same("PUT", "/a/_doc/9", {"t": "unrefreshed fox"})
    pair.same("POST", path, body, query=query)


@pytest.mark.parametrize("k,doc", [(5, "top"), (5, "outside"), (20, "top")])
def test_explain_knn_on_the_exact_route(pair, k, doc):
    """A `knn` clause: the same `matched` as the reference, the value
    within bf16's step of the reference's host f32 score, and within the
    pair's tolerance of the port's own search score for the document."""
    _load(pair, shards=1, n=40)
    q = _vec(77)
    body = {"query": {"knn": {"field": "v", "query_vector": q, "k": k,
                              "num_candidates": 40}}}
    _, hits = pair.same("POST", "/a/_search", dict(body, size=40,
                                                   request_cache=False))
    ranked = [h["_id"] for h in hits["hits"]["hits"]]
    doc_id = ranked[0] if doc == "top" else str(
        next(i for i in range(40) if str(i) not in ranked))
    want = pair.ref("POST", f"/a/_explain/{doc_id}", body)
    got = pair.port("POST", f"/a/_explain/{doc_id}", body)
    assert want[0] == got[0] == 200
    assert got[1]["matched"] == want[1]["matched"]
    assert got[1]["explanation"]["description"] == \
        want[1]["explanation"]["description"]
    value = got[1]["explanation"]["value"]
    assert abs(value - want[1]["explanation"]["value"]) <= 2 ** -8
    if got[1]["matched"]:
        score = next(h["_score"] for h in hits["hits"]["hits"]
                     if h["_id"] == doc_id)
        assert abs(value - score) <= 1e-4


_VALIDATE = [
    ("/a/_validate/query", {"query": {"match": {"t": "fox"}}}, None),
    ("/a/_validate/query", {"query": {"match": {"t": "fox"}}},
     {"explain": "true"}),
    ("/a/_validate/query", {"query": {"bool": {
        "must": [{"term": {"k": "k1"}}],
        "should": [{"range": {"n": {"gte": 3, "lt": 9}}}],
        "must_not": [{"exists": {"field": "e"}}]}}}, {"explain": "true"}),
    ("/a/_validate/query", {"query": {"match_all": {}}},
     {"explain": "true"}),
    ("/a/_validate/query", None, {"explain": "true"}),
    ("/a/_validate/query", {"query": {"term": {"k": "k1"}}, "size": 3},
     {"explain": "true"}),
    ("/a/_validate/query", {"query": {"term": {"k": "k1"}}, "size": 3},
     None),
    ("/a/_validate/query", {"query": {"bogus": {"k": 1}}},
     {"explain": "true"}),
    ("/a/_validate/query", {"query": {"bogus": {"k": 1}}}, None),
    ("/a/_validate/query", None, {"q": "t:fox"}),
    ("/a/_validate/query", None, {"q": "t:fox", "explain": "true"}),
    ("/a,b/_validate/query", {"query": {"terms": {"k": ["k0", "k2"]}}},
     {"explain": "true"}),
    ("/*/_validate/query", {"query": {"match_phrase": {"t": "brown fox"}}},
     {"explain": "true"}),
    ("/x/_validate/query", {"query": {"prefix": {"k": "k"}}},
     {"explain": "true"}),
]


@pytest.mark.parametrize("path,body,query", _VALIDATE)
def test_validate_query(pair, path, body, query):
    _load(pair)
    _load(pair, "b", 1, seed=1)
    pair.same("POST", "/_aliases", {"actions": [{"add": {
        "index": "a", "alias": "x"}}]})
    pair.same("POST", path, body, query=query)


_FIELD_CAPS = [
    ("/w/_field_caps", {"fields": "*"}),
    ("/w/_field_caps", {"fields": "l,obj.*,nest*"}),
    ("/w,c/_field_caps", {"fields": "*"}),
    ("/w,c/_field_caps", {"fields": "*", "include_unmapped": "true"}),
    ("/w,c/_field_caps", {"fields": "k,l,only_c"}),
    ("/_field_caps", {"fields": "t*"}),
    ("/c*/_field_caps", {"fields": "k"}),
    ("/x/_field_caps", {"fields": "*"}),
    ("/nope/_field_caps", {"fields": "*"}),
]


@pytest.mark.parametrize("path,query", _FIELD_CAPS)
def test_field_caps(pair, path, query):
    """Every mapping type the port maps; two indices whose `k` and `l`
    differ in type; `include_unmapped`; `meta` merged."""
    pair.same("PUT", "/w", {"mappings": WIDE})
    pair.same("PUT", "/c", {"mappings": {"properties": {
        "k": {"type": "text"}, "l": {"type": "long", "meta": {
            "unit": "s"}}, "only_c": {"type": "keyword", "index": False},
        "t": {"type": "text"}}}})
    pair.same("POST", "/_aliases", {"actions": [{"add": {
        "indices": ["w", "c"], "alias": "x"}}]})
    pair.same("GET", path, query=query)
    pair.same("POST", path, {"fields": ["k", "t*"]})


def _shards_view(pair, method, path, query=None):
    out = []
    for node, (status, body) in (
            (pair.ref_node, pair.ref(method, path, query=query)),
            (pair.port_node, pair.port(method, path, query=query))):
        if status == 200:
            body["nodes"] = {"NODE": body["nodes"][node.node_id]}
            for group in body["shards"]:
                for s in group:
                    s["node"] = "NODE"
        out.append((status, body))
    return out


@pytest.mark.parametrize("path", [
    "/a/_search_shards", "/a,b/_search_shards", "/_search_shards",
    "/x/_search_shards", "/f/_search_shards", "/f,g/_search_shards",
    "/f,a/_search_shards", "/*/_search_shards", "/nope/_search_shards"])
def test_search_shards(pair, path):
    """The shards a search reaches over the murmur3 placement, and the
    aliases the expression names with their filters."""
    _load(pair, "a", 3)
    _load(pair, "b", 1, seed=1)
    pair.same("POST", "/_aliases", {"actions": [
        {"add": {"index": "a", "alias": "x"}},
        {"add": {"index": "a", "alias": "f",
                 "filter": {"term": {"k": "k1"}}}},
        {"add": {"index": "a", "alias": "g",
                 "filter": {"range": {"n": {"gte": 3}}}}}]})
    ref, port = _shards_view(pair, "GET", path)
    assert ref[0] == port[0], (ref, port)
    pair.match(ref[1], port[1], path)


_TERMVECTORS = [
    ("GET", "/a/_termvectors/3", None, None),
    ("GET", "/a/_termvectors/3", None, {"term_statistics": "true"}),
    ("POST", "/a/_termvectors/3", {"fields": ["e"],
                                   "term_statistics": True}, None),
    ("GET", "/a/_termvectors/nope", None, None),
    ("GET", "/a/_termvectors/50", None, {"realtime": "false"}),
    ("GET", "/a/_termvectors/50", None, {"realtime": "true"}),
    ("GET", "/a/_termvectors/4", None, {"realtime": "false"}),
    ("POST", "/a/_termvectors", {"doc": {"t": "the fox and the dog",
                                         "k": "x"}}, None),
    ("POST", "/a/_termvectors", {"doc": {"t": "fox fox", "e": "runs"},
                                 "term_statistics": True}, None),
    ("GET", "/x/_termvectors/3", None, None),
]


@pytest.mark.parametrize("method,path,body,query", _TERMVECTORS)
def test_termvectors(pair, method, path, body, query):
    _load(pair)
    pair.same("POST", "/_aliases", {"actions": [{"add": {
        "index": "a", "alias": "x"}}]})
    pair.same("DELETE", "/a/_doc/7")
    pair.same("PUT", "/a/_doc/50", {"t": "fresh unrefreshed fox"})
    pair.same(method, path, body, query=query)


ANALYSIS = {"analysis": {
    "analyzer": {"my": {"type": "custom", "tokenizer": "whitespace",
                        "filter": ["lowercase", "my_stop"]}},
    "filter": {"my_stop": {"type": "stop", "stopwords": ["the", "a"]}}}}


_ANALYZE = [
    ("/_analyze", {"text": "The Quick brown-fox", "analyzer": "standard"}),
    ("/_analyze", {"text": "The Quick brown-fox", "analyzer": "english"}),
    ("/_analyze", {"text": "The Quick brown-fox", "analyzer": "simple"}),
    ("/_analyze", {"text": "The Quick brown-fox",
                   "analyzer": "whitespace"}),
    ("/_analyze", {"text": "The Quick brown-fox", "analyzer": "keyword"}),
    ("/_analyze", {"text": "The Quick brown-fox", "analyzer": "stop"}),
    ("/_analyze", {"text": ["one two", "three"], "analyzer": "standard"}),
    ("/_analyze", {"text": "The Quick fox"}),
    ("/_analyze", {"text": "The Quick fox", "analyzer": "standard",
                   "explain": True}),
    ("/_analyze", {"text": "The QUICK fox", "tokenizer": "whitespace",
                   "filter": ["lowercase", "stop"]}),
    ("/_analyze", {"text": "The QUICK fox", "tokenizer": "standard",
                   "filter": ["lowercase"], "explain": True}),
    ("/_analyze", {"text": "quick", "tokenizer": {
        "type": "ngram", "min_gram": 2, "max_gram": 3}}),
    ("/_analyze", {"text": "Running Runners", "tokenizer": "standard",
                   "filter": [{"type": "stop", "stopwords": ["runners"]},
                              "lowercase", "porter_stem"]}),
    ("/_analyze", {"text": "Ünïcode café", "tokenizer": "standard",
                   "filter": "asciifolding"}),
    ("/_analyze", {"text": "no chain"}),
    ("/_analyze", {"text": "The A Quick", "analyzer": "bogus"}),
    ("/i/_analyze", {"text": "The A Quick Fox", "analyzer": "my"}),
    ("/i/_analyze", {"text": "The A Quick Fox", "analyzer": "my",
                     "explain": True}),
    ("/i/_analyze", {"text": "one two three"}),
    ("/i/_analyze", {"text": ["one two", "three four"]}),
    ("/i/_analyze", {"text": "one two three four five six"}),
    ("/_analyze", {"text": "one two three four five six"}),
]


@pytest.mark.parametrize("path,body", _ANALYZE)
def test_analyze(pair, path, body):
    """Builtin and index-scoped analyzers, inline tokenizers and filters,
    `explain`, and an index's `analyze.max_token_count` (4 here)."""
    pair.same("PUT", "/i", {"settings": {
        **ANALYSIS, "index.analyze.max_token_count": 4}})
    pair.same("POST", path, body)
    pair.same("GET", path, body)
