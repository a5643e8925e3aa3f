"""The fetch phase through both REST layers on the CPU, request for
request (`tests/torch_rest_pair.py`), on ~200 seeded mixed documents at 1
and 2 shards: `version` and `seq_no_primary_term` (read from each sealed
row: an updated document reads version 2), `stored_fields` (`[]`,
`_none_`, a list of `store: true` fields), `docvalue_fields` (with a
DecimalFormat pattern), `explain`, `_ignored`, `highlight` (the query's
terms, tags, `require_field_match`, `highlight_query`, wildcard fields,
keyword values under `ignore_above`, the `max_analyzed_offset` 400) and
the URL's `docvalue_fields`, `version` and `seq_no_primary_term`."""

import pytest

from tests.torch_rest_pair import Pair, hit_ids, load_mixed, mixed_vector


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


@pytest.mark.parametrize("shards", [1, 2])
def test_versions_and_seq_nos(pair, shards):
    rng = load_mixed(pair, "a", shards, 11)
    q = {"match": {"t": "alpha omega"}}
    for body in ({"query": q, "version": True, "size": 40},
                 {"query": q, "seq_no_primary_term": True, "size": 40},
                 {"query": q, "version": True, "seq_no_primary_term": True,
                  "sort": [{"n": "desc"}, "_doc"], "size": 40},
                 {"knn": {"field": "v", "query_vector": mixed_vector(rng),
                          "k": 10}, "version": True,
                  "seq_no_primary_term": True}):
        pair.same("POST", "/a/_search", body)
    # the updated documents (a1, a12, ...) read version 2 from their rows
    _, got = pair.same("POST", "/a/_search", {
        "query": {"ids": {"values": ["a1", "a12", "a23", "a2"]}},
        "version": True})
    versions = {h["_id"]: h["_version"] for h in got["hits"]["hits"]}
    assert versions == {"a1": 2, "a12": 2, "a23": 2, "a2": 1}
    pair.same("PUT", "/a/_doc/a2", {"n": 3, "t": "alpha"},
              query={"refresh": "true"})
    _, got = pair.same("POST", "/a/_search", {
        "query": {"ids": {"values": ["a2"]}}, "version": True,
        "seq_no_primary_term": True})
    assert got["hits"]["hits"][0]["_version"] == 2
    pair.same("GET", "/a/_search", query={
        "version": "true", "seq_no_primary_term": "true", "size": "30"})


@pytest.mark.parametrize("shards", [1, 2])
def test_stored_and_docvalue_fields(pair, shards):
    load_mixed(pair, "a", shards, 12)
    q = {"match": {"t": "beta gamma"}}
    for body in (
            {"query": q, "stored_fields": []},
            {"query": q, "stored_fields": "_none_"},
            {"query": q, "stored_fields": ["s", "tag", "_source"]},
            {"query": q, "stored_fields": ["s"], "_source": ["n"]},
            {"query": q, "docvalue_fields": ["n", "tag", "b", "k", "t",
                                             "_seq_no", "_primary_term"]},
            {"query": q, "docvalue_fields": [
                {"field": "f", "format": "#.0"}, "f",
                {"field": "n", "format": "0000"}], "_source": False},
            {"query": q, "explain": True, "size": 20},
            {"query": q, "explain": True, "sort": ["n"], "size": 20},
            {"size": 60, "_source": ["n"]}):
        pair.same("POST", "/a/_search", body)
    pair.same("GET", "/a/_search", query={"docvalue_fields": "n,f,tag",
                                          "size": "25"})


@pytest.mark.parametrize("shards", [1, 2])
def test_ignored_on_hits(pair, shards):
    """A malformed integer under `ignore_malformed` lands in `_ignored`,
    which every hit that has it carries, in `render_hits`' old path (a
    plain query) and the fused hybrid one alike."""
    rng = load_mixed(pair, "a", shards, 13)
    pair.same("PUT", "/a/_doc/bad", {"n": "xyz", "t": "alpha zz",
                                     "v": mixed_vector(rng)},
              query={"refresh": "true"})
    _, got = pair.same("POST", "/a/_search",
                       {"query": {"exists": {"field": "_ignored"}},
                        "size": 100})
    assert got["hits"]["hits"] and all(
        h["_ignored"] == ["n"] for h in got["hits"]["hits"])
    _, got = pair.same("POST", "/a/_search",
                       {"query": {"match": {"t": "zz"}}})
    assert got["hits"]["hits"][0]["_ignored"] == ["n"]
    body = {"query": {"match": {"t": "zz"}},
            "knn": {"field": "v", "query_vector": mixed_vector(rng), "k": 5},
            "rank": {"rrf": {}}}
    s1, want = pair.ref("POST", "/a/_search", body)
    s2, got = pair.port("POST", "/a/_search", dict(body,
                                                   request_cache=False))
    assert s1 == s2 == 200
    pair.match(want["hits"], got["hits"], "hybrid _ignored")
    assert any(h.get("_ignored") == ["n"] for h in got["hits"]["hits"])


HIGHLIGHTS = [
    {"query": {"match": {"t": "alpha gamma"}},
     "highlight": {"fields": {"t": {}}}},
    {"query": {"match_phrase": {"t": "alpha beta"}},
     "highlight": {"fields": {"t": {}}, "pre_tags": ["<b>"],
                   "post_tags": ["</b>"]}},
    {"query": {"bool": {"must": [{"match": {"t": "eta"}}],
                        "should": [{"term": {"tag": "red"}}],
                        "filter": [{"term": {"k": "short"}}]}},
     "highlight": {"fields": {"t": {}, "tag": {}, "k": {}}}},
    {"query": {"multi_match": {"query": "theta red", "fields": ["t", "tag"]}},
     "highlight": {"fields": {"*": {}}}},
    {"query": {"match": {"t": "kappa"}},
     "highlight": {"require_field_match": False,
                   "fields": [{"t": {}}, {"s": {}}]}},
    {"query": {"match": {"t": "delta"}},
     "highlight": {"fields": {"t": {"highlight_query": {
         "match": {"t": "zeta iota"}}}}}},
    {"query": {"term": {"k": "much-too-long"}},
     "highlight": {"fields": {"k": {}}}},
    {"query": {"bool": {"should": [{"term": {"k": "much-too-long"}},
                                   {"match": {"t": "alpha"}}]}},
     "highlight": {"fields": {"k": {}, "t": {"type": "plain"}}},
     "sort": [{"n": "desc"}], "size": 30},
]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("body", HIGHLIGHTS,
                         ids=[str(i) for i in range(len(HIGHLIGHTS))])
def test_highlight(pair, shards, body):
    load_mixed(pair, "a", shards, 14)
    _, got = pair.same("POST", "/a/_search", dict(body, size=30))
    if body["query"].get("match"):
        assert any("highlight" in h for h in got["hits"]["hits"])


def test_highlight_max_analyzed_offset(pair):
    pair.same("PUT", "/h", {"settings": {
        "index.highlight.max_analyzed_offset": 20},
        "mappings": {"properties": {
            "t": {"type": "text"},
            "o": {"type": "text", "index_options": "offsets"}}}})
    pair.same("PUT", "/h/_doc/1", {"t": "alpha " * 10, "o": "alpha " * 10},
              query={"refresh": "true"})
    for field, htype, status in (("t", None, 400), ("o", None, 200),
                                 ("o", "plain", 400)):
        spec = {} if htype is None else {"type": htype}
        _, got = pair.same("POST", "/h/_search", {
            "query": {"match": {field: "alpha"}},
            "highlight": {"fields": {field: spec}}})
        assert got.get("status", 200) == status, got
    _, got = pair.same("POST", "/h/_search", {
        "query": {"match": {"t": "alpha"}}})
    assert hit_ids(got) == ["1"]
