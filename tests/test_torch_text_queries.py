"""The port's BM25 text queries against the reference `Node` on the CPU:
the same mapping (text fields under the standard and the english
analyzer, a keyword and an integer field), the same seeded documents over
`_bulk` in two segments with updates that tombstone rows, at 1 and 3
shards, and the same `_search {query}` bodies through both REST layers.
Hits (ids in order), `_score`, `max_score` and `hits.total` must be equal;
BM25 reads the whole index's statistics in both."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController

N_DOCS = 300
WORDS = ["search", "searching", "engine", "engines", "vector", "vectors",
         "the", "a", "of", "fast", "faster", "quick", "brown", "fox",
         "running", "runs", "ran", "index", "indexed", "shard", "café",
         "Über", "東京", "data", "big", "small"]

MAPPING = {"properties": {
    "body": {"type": "text"},
    "title": {"type": "text", "analyzer": "english"},
    "kw": {"type": "keyword"},
    "n": {"type": "integer"},
}}


def _raw(body, ndjson=False):
    if body is None:
        return b""
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return json.dumps(body).encode()


def _docs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()

    def text(lo, hi):
        words = rng.choice(WORDS, int(rng.integers(lo, hi)), p=p)
        return " ".join(w.capitalize() if rng.random() < 0.1 else w
                        for w in words) + ("." if rng.random() < 0.5 else "")

    docs = []
    for i in range(n):
        doc = {"body": text(0, 30), "title": text(1, 6),
               "kw": f"k{i % 4}", "n": int(rng.integers(0, 100))}
        if i % 13 == 0:
            doc["body"] = [text(1, 5), text(1, 5)]
        if i % 29 == 3:
            del doc["title"]
        docs.append(doc)
    return docs


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request, tmp_path_factory):
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

    docs = _docs(41, N_DOCS)
    create = {"settings": {"number_of_shards": request.param},
              "mappings": MAPPING}
    for req in (ref_req, port_req):
        assert req("PUT", "/t", create)[0] == 200
        for lo, hi in ((0, 180), (180, N_DOCS)):
            bulk = []
            for i in range(lo, hi):
                bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
            status, resp = req("POST", "/t/_bulk", bulk, ndjson=True)
            assert status == 200 and not resp["errors"]
            assert req("POST", "/t/_refresh")[0] == 200
        for i in (5, 70, 200):
            assert req("PUT", f"/t/_doc/d{i}", docs[i + 1])[0] in (200, 201)
        assert req("POST", "/t/_refresh")[0] == 200
    yield ref_req, port_req
    ref.close()
    mp.undo()


QUERIES = {
    "match": {"match": {"body": "fast search engine"}},
    "match_short": {"match": {"body": "fox"}},
    "match_repeat": {"match": {"body": "fox fox quick"}},
    "match_oov": {"match": {"body": "zebra fox"}},
    "match_empty": {"match": {"body": "!!! ..."}},
    "match_and": {"match": {"body": {"query": "quick brown fox",
                                     "operator": "and"}}},
    "match_msm": {"match": {"body": {"query": "quick brown fox data big",
                                     "minimum_should_match": "60%"}}},
    "match_msm_int": {"match": {"body": {"query": "quick brown fox",
                                         "minimum_should_match": 2}}},
    "match_boost": {"match": {"body": {"query": "vector index",
                                       "boost": 2.5}}},
    "match_unicode": {"match": {"body": "CAFÉ über 東京"}},
    "match_english": {"match": {"title": "searching engines ran"}},
    "match_keyword": {"match": {"kw": "k1"}},
    "match_integer": {"match": {"n": 42}},
    "match_unmapped": {"match": {"nope": "x"}},
    "phrase": {"match_phrase": {"body": "quick brown"}},
    "phrase_slop0": {"match_phrase": {"body": {"query": "the fox",
                                               "slop": 0}}},
    "phrase_slop2": {"match_phrase": {"body": {"query": "the fox",
                                               "slop": 2, "boost": 3}}},
    "phrase_three": {"match_phrase": {"body": {"query": "search the engine",
                                               "slop": 2}}},
    "phrase_english": {"match_phrase": {"title": "running fox"}},
    "phrase_keyword": {"match_phrase": {"kw": "k2"}},
    "multi_best": {"multi_match": {"query": "search fox",
                                   "fields": ["body", "title^2"]}},
    "multi_most": {"multi_match": {"query": "search fox",
                                   "fields": ["body", "title"],
                                   "type": "most_fields"}},
    "multi_cross": {"multi_match": {"query": "quick data",
                                    "fields": ["body", "title"],
                                    "type": "cross_fields",
                                    "operator": "and"}},
    "multi_wildcard": {"multi_match": {"query": "engine k3",
                                       "fields": ["*"]}},
    "multi_phrase_type": {"multi_match": {"query": "brown fox",
                                          "fields": ["body", "title"],
                                          "type": "phrase"}},
    "term_text": {"term": {"body": "fox"}},
    "term_text_boost": {"term": {"body": {"value": "search", "boost": 2}}},
    "term_text_unanalyzed": {"term": {"body": "Fox"}},
    "terms_text": {"terms": {"body": ["fox", "vector", "zebra"]}},
    "bool_must_should": {"bool": {
        "must": [{"match": {"body": "search"}}],
        "should": [{"match": {"title": "fast"}},
                   {"term": {"body": "fox"}}]}},
    "bool_filter": {"bool": {
        "must": {"match": {"body": "engine vector"}},
        "filter": [{"range": {"n": {"gte": 20, "lt": 80}}},
                   {"term": {"kw": "k1"}}]}},
    "bool_should_msm": {"bool": {
        "should": [{"match": {"body": "fox"}}, {"match": {"body": "quick"}},
                   {"match_phrase": {"body": "brown fox"}}],
        "minimum_should_match": 2}},
    "bool_must_not": {"bool": {
        "should": [{"match": {"body": "data"}}],
        "must_not": [{"match": {"title": "small"}}], "boost": 1.5}},
    "constant_text": {"constant_score": {
        "filter": {"match": {"body": "fox"}}, "boost": 4}},
}


def _same(want, got):
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]
    assert [h["_id"] for h in got["hits"]["hits"]] \
        == [h["_id"] for h in want["hits"]["hits"]]
    assert [h["_score"] for h in got["hits"]["hits"]] \
        == [h["_score"] for h in want["hits"]["hits"]]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_text_query_matches_reference(nodes, name):
    ref_req, port_req = nodes
    body = {"query": QUERIES[name], "size": 25}
    s1, want = ref_req("POST", "/t/_search", body)
    s2, got = port_req("POST", "/t/_search", body)
    assert s1 == s2 == 200, (want, got)
    _same(want, got)


@pytest.mark.parametrize("frm,size", [(0, 10), (7, 5), (0, 300), (290, 20)])
def test_pagination_and_sources_match_reference(nodes, frm, size):
    ref_req, port_req = nodes
    body = {"query": {"match": {"body": "search fox the"}}, "from": frm,
            "size": size}
    (s1, want), (s2, got) = (ref_req("POST", "/t/_search", body),
                             port_req("POST", "/t/_search", body))
    assert s1 == s2 == 200
    _same(want, got)
    assert [h["_source"] for h in got["hits"]["hits"]] \
        == [h["_source"] for h in want["hits"]["hits"]]


@pytest.mark.parametrize("query", [
    {"match": {"body": {"query": "fox", "fuzziness": "AUTO"}}},
    {"multi_match": {"query": "fox", "fields": ["body"],
                     "type": "bool_prefix"}},
    {"prefix": {"body": "fo"}},
    {"match_phrase_prefix": {"body": "quick br"}},
])
def test_unported_text_options_are_a_400(nodes, query):
    """The options once left out (`fuzziness`, `bool_prefix`, `prefix`,
    `match_phrase_prefix`) are served now: the reference's hits."""
    ref_req, port_req = nodes
    body = {"query": query, "size": 20}
    (s1, want), (s2, got) = (ref_req("POST", "/t/_search", body),
                             port_req("POST", "/t/_search", body))
    assert s1 == s2 == 200
    assert got["hits"]["total"]["value"] > 0
    _same(want, got)


def test_custom_analyzer_settings_match_reference(tmp_path):
    """An index whose text field names an `index.analysis` analyzer (a
    custom one, and a search analyzer apart from the index one) scores
    as the reference's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    ref = RefNode(str(tmp_path))
    port = Node(device="cpu")
    ref_rc, port_rc = RefController(), RestController()
    ref_register(ref_rc, ref)
    register_all(port_rc, port)
    reqs = (lambda m, p, b=None, nd=False: ref_rc.dispatch(
                m, p, {}, _raw(b, nd), "application/json"),
            lambda m, p, b=None, nd=False: port_rc.dispatch(
                m, p, {}, _raw(b, nd)))
    create = {"settings": {"analysis": {
        "analyzer": {"folded": {"type": "custom", "tokenizer": "standard",
                                "filter": ["lowercase", "asciifolding",
                                           "my_stop"]}},
        "filter": {"my_stop": {"type": "stop",
                               "stopwords": ["the", "a"]}}}},
        "mappings": {"properties": {
            "t": {"type": "text", "analyzer": "folded",
                  "search_analyzer": "standard"}}}}
    docs = _docs(43, 60)
    try:
        for req in reqs:
            assert req("PUT", "/c", create)[0] == 200
            bulk = []
            for i, d in enumerate(docs):
                bulk += [{"index": {"_id": f"c{i}"}}, {"t": d["title"]
                                                       if "title" in d
                                                       else d["kw"]}]
            assert not req("POST", "/c/_bulk", bulk, True)[1]["errors"]
            assert req("POST", "/c/_refresh")[0] == 200
        for q in ({"match": {"t": "Café the searching"}},
                  {"match_phrase": {"t": "fox search"}},
                  {"term": {"t": "cafe"}}):
            body = {"query": q, "size": 20}
            (s1, want), (s2, got) = (reqs[0]("POST", "/c/_search", body),
                                     reqs[1]("POST", "/c/_search", body))
            assert s1 == s2 == 200
            _same(want, got)
    finally:
        ref.close()
        mp.undo()
