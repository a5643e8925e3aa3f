"""The ten mapping types of the reference beyond documents within documents,
through both REST layers on the CPU (`tests/torch_rest_pair.py`): for
each type, its mapping and `GET /_mapping`, good and bad writes (status
and message) and its query, at 1 and 2 shards: `binary` (base64 checked,
not searchable), `search_as_you_type` (`multi_match` `bool_prefix` over
its sub-fields), `token_count` (`term` and `range` on the count),
`wildcard`, `constant_keyword` (the first value written sets the
mapping's `value`), `murmur3` (its value under `docvalue_fields`),
`histogram` (`percentiles` answers null, as the reference's),
`flattened` (root and keyed terms, `depth_limit`), `annotated_text`
(`match` on an annotation) and `alias` (`term`, aggregations, sorts and
`collapse` read the target; a write is a 400). Then the port maps every
type the reference registers."""

import pytest

from elasticsearch_tpu.index import mapping as ref_mapping
from elasticsearch_tpu_torch.index import mapping as port_mapping
from tests.torch_rest_pair import Pair

WORDS = ["quick", "brown", "fox", "jumps", "over", "lazy", "dog", "quiet"]

CASES = {
    "binary": {
        "props": {"b": {"type": "binary"},
                  "nb": {"type": "binary", "doc_values": False}},
        "good": [{"b": "aGVsbG8=", "nb": "d29ybGQ="}, {"b": ["aGk=", "eW8="]}],
        "bad": [{"b": "not base64!"}, {"b": "aGVsbG8"}],
        "queries": [
            {"query": {"term": {"b": "aGVsbG8="}}},
            {"query": {"exists": {"field": "b"}}},
            {"docvalue_fields": ["b", "nb"], "_source": False},
        ],
    },
    "search_as_you_type": {
        "props": {"s": {"type": "search_as_you_type"}},
        "good": [{"s": " ".join(WORDS[i:i + 4])} for i in range(5)]
        + [{"s": ["quick dog", "lazy fox jumps"]}],
        "bad": [],
        "queries": [
            {"query": {"multi_match": {
                "query": "quick bro", "type": "bool_prefix",
                "fields": ["s", "s._2gram", "s._3gram"]}}},
            {"query": {"multi_match": {
                "query": "fox ju", "type": "bool_prefix",
                "fields": ["s", "s._2gram", "s._3gram",
                           "s._index_prefix"]}}},
            {"query": {"match": {"s._2gram": "lazy dog"}}},
            {"query": {"match_phrase_prefix": {"s": "over la"}}},
            {"query": {"term": {"s._index_prefix": "qu"}}},
        ],
    },
    "token_count": {
        "props": {"tc": {"type": "token_count", "analyzer": "standard"},
                  "name": {"type": "text", "fields": {
                      "length": {"type": "token_count",
                                 "analyzer": "standard"}}}},
        "good": [{"tc": "one two three", "name": "a b"}, {"tc": 7},
                 {"tc": "", "name": "x y z w"}, {"tc": ["a", "b c"]}],
        "bad": [],
        "queries": [
            {"query": {"term": {"tc": 3}}},
            {"query": {"term": {"name.length": 4}}},
            {"query": {"range": {"tc": {"gte": 2, "lte": 7}}}},
            {"size": 0, "aggs": {"s": {"sum": {"field": "tc"}}}},
        ],
    },
    "wildcard": {
        "props": {"w": {"type": "wildcard"}},
        "good": [{"w": "foobar"}, {"w": "barbaz"}, {"w": ["x-ray", "FOO"]}],
        "bad": [],
        "queries": [
            {"query": {"wildcard": {"w": "*bar*"}}},
            {"query": {"wildcard": {"w": {"value": "?oo*"}}}},
            {"query": {"term": {"w": "FOO"}}},
            {"size": 0, "aggs": {"t": {"terms": {"field": "w"}}}},
        ],
    },
    "constant_keyword": {
        "props": {"ck": {"type": "constant_keyword"},
                  "fixed": {"type": "constant_keyword", "value": "prod"}},
        "good": [{"ck": "c1"}, {"ck": "c1", "fixed": "prod"}, {"x": 1}],
        "bad": [{"ck": "c2"}, {"fixed": "dev"}],
        "queries": [
            {"query": {"term": {"ck": "c1"}}},
            {"query": {"term": {"ck": "c2"}}},
            {"query": {"term": {"fixed": "prod"}}},
        ],
    },
    "murmur3": {
        "props": {"m": {"type": "murmur3"}, "k": {"type": "keyword"}},
        "good": [{"m": "hello", "k": "a"}, {"m": "world", "k": "b"},
                 {"m": 12345, "k": "c"}, {"m": "", "k": "d"},
                 {"m": "élan", "k": "e"}],
        "bad": [],
        "queries": [
            {"docvalue_fields": ["m"], "_source": False,
             "sort": [{"k": "asc"}]},
            {"query": {"term": {"m": "hello"}}},
            {"size": 0, "aggs": {"c": {"cardinality": {"field": "m"}}}},
        ],
    },
    "histogram": {
        "props": {"h": {"type": "histogram"}},
        "good": [{"h": {"values": [0.1, 0.5, 1.0], "counts": [3, 7, 2]}},
                 {"h": {"values": [2.0], "counts": [1]}},
                 {"h": {"values": [], "counts": []}}],
        "bad": [{"h": {"values": [2.0, 1.0], "counts": [1, 1]}},
                {"h": {"values": [1.0], "counts": [1, 2]}},
                {"h": {"values": [1.0], "counts": [-1]}},
                {"h": {"values": [1.0]}}, {"h": 3}],
        "queries": [
            {"size": 0, "aggs": {"p": {"percentiles": {"field": "h"}}}},
            {"size": 0, "aggs": {"p": {"percentiles": {
                "field": "h", "percents": [50, 99]}}}},
            {"query": {"exists": {"field": "h"}}},
        ],
    },
    "flattened": {
        "props": {"fl": {"type": "flattened"},
                  "shallow": {"type": "flattened", "depth_limit": 1}},
        "good": [{"fl": {"a": "x", "b": {"c": 3, "d": True}}},
                 {"fl": {"a": ["y", "x"], "e": [{"f": "g"}]}},
                 {"shallow": {"a": {"b": 1}}}],
        "bad": [{"fl": "scalar"}, {"shallow": {"a": {"b": {"c": 1}}}}],
        "queries": [
            {"query": {"term": {"fl": "x"}}},
            {"query": {"term": {"fl.b.c": "3"}}},
            {"query": {"term": {"fl.b.d": "true"}}},
            {"query": {"term": {"fl.e.f": "g"}}},
            {"query": {"terms": {"fl.a": ["y", "z"]}}},
        ],
    },
    "annotated_text": {
        "props": {"at": {"type": "annotated_text"}},
        "good": [{"at": "visit [Paris](city&Q90) today"},
                 {"at": "the [fox](animal%20kind) runs"},
                 {"at": "no annotation here"}],
        "bad": [],
        "queries": [
            {"query": {"match": {"at": "Q90"}}},
            {"query": {"match": {"at": "city"}}},
            {"query": {"match": {"at": "animal kind"}}},
            {"query": {"match": {"at": "paris"}}},
            {"query": {"match_phrase": {"at": "visit paris"}}},
        ],
    },
    "alias": {
        "props": {"k": {"type": "keyword"}, "n": {"type": "long"},
                  "al": {"type": "alias", "path": "k"},
                  "aln": {"type": "alias", "path": "n"},
                  "al2": {"type": "alias", "path": "al"}},
        "good": [{"k": "kv1", "n": 3}, {"k": "kv2", "n": 1},
                 {"k": "kv1", "n": 2}],
        "bad": [{"al": "zz"}, {"aln": 4}],
        "queries": [
            {"query": {"term": {"al": "kv1"}}},
            {"query": {"term": {"al2": "kv1"}}},
            {"query": {"range": {"aln": {"gte": 2}}}},
            {"query": {"exists": {"field": "al"}}},
            {"size": 0, "aggs": {"t": {"terms": {"field": "al"}},
                                 "a": {"avg": {"field": "aln"}}}},
            {"sort": [{"aln": "desc"}]}, {"sort": [{"al": "asc"}]},
            {"collapse": {"field": "al"}},
        ],
    },
}


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def pair(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    p = Pair(tmp_path_factory.mktemp("extras"), mp)
    p.shards = request.param
    yield p
    p.close()
    mp.undo()


@pytest.mark.parametrize("tname", sorted(CASES))
def test_mapping_type(pair, tname):
    case = CASES[tname]
    name = tname.replace("_", "")
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": pair.shards},
        "mappings": {"properties": case["props"]}})
    pair.same("GET", f"/{name}/_mapping")
    for i, doc in enumerate(case["good"]):
        _, got = pair.same("PUT", f"/{name}/_doc/{i}", doc)
        assert got["result"] == "created", got
    for doc in case["bad"]:
        # each failed write takes a seq_no, as in the reference: the next
        # good write compares it
        _, got = pair.same("PUT", f"/{name}/_doc/bad", doc)
        assert got["status"] == 400, got
        pair.same("PUT", f"/{name}/_doc/after", case["good"][0])
    pair.same("POST", f"/{name}/_bulk",
              [x for doc in case["bad"] + case["good"][:1]
               for x in ({"index": {"_id": "bulk"}}, doc)], ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    # a first value written shows in the mapping (constant_keyword)
    pair.same("GET", f"/{name}/_mapping")
    for body in case["queries"]:
        pair.same("POST", f"/{name}/_search", body)


def test_constant_keyword_value_set_by_first_write(pair):
    """The first value written sets `value`; a query-side value never
    does."""
    pair.same("PUT", "/ck", {"settings": {"number_of_shards": pair.shards},
                             "mappings": {"properties": {
                                 "c": {"type": "constant_keyword"}}}})
    _, got = pair.same("POST", "/ck/_search", {"query": {"term": {
        "c": "q"}}})
    _, got = pair.same("GET", "/ck/_mapping")
    assert "value" not in got["ck"]["mappings"]["properties"]["c"]
    pair.same("PUT", "/ck/_doc/1", {"c": "first"})
    _, got = pair.same("GET", "/ck/_mapping")
    assert got["ck"]["mappings"]["properties"]["c"]["value"] == "first"
    _, got = pair.same("PUT", "/ck/_doc/2", {"c": "second"})
    assert got["status"] == 400


def test_percentiles_over_histogram_are_null(pair):
    pair.same("PUT", "/hh", {"settings": {"number_of_shards": pair.shards},
                             "mappings": {"properties": {
                                 "h": {"type": "histogram"}}}})
    pair.same("PUT", "/hh/_doc/1?refresh=true",
              {"h": {"values": [1.0, 2.0], "counts": [4, 1]}})
    _, got = pair.same("POST", "/hh/_search", {"size": 0, "aggs": {
        "p": {"percentiles": {"field": "h"}}}})
    assert set(got["aggregations"]["p"]["values"].values()) == {None}


def test_port_maps_every_reference_type():
    assert set(port_mapping.FIELD_TYPES) == set(ref_mapping.FIELD_TYPES)
    for tname, cls in port_mapping.FIELD_TYPES.items():
        assert cls.type_name == tname
