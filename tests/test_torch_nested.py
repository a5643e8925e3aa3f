"""`nested` through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`): the mapping and `GET /_mapping`, the
`index.mapping.nested_objects.limit` 400, the `nested` query at one and
two levels with and without a top-level field of the stripped name,
nested `inner_hits` (the looser matcher of the reference kept), the
`nested` and `reverse_nested` aggregations in final mode and in partial
mode over two indices with both `reverse_nested` 400s,
`search.allow_expensive_queries: false`, and `nested` inside a `bool` and
as a `knn` filter; on seeded question / answer data at 1 and 2 shards.
Then the source matcher: the port's `source_matches` against the
reference's on random objects and queries (hypothesis), and the
vectorized matcher `nested` runs against the port's own object by
object."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from elasticsearch_tpu.index.mapping import MapperService as RefMapperService
from elasticsearch_tpu.search import queries_ext as ref_ext
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.search import queries_ext
from elasticsearch_tpu_torch.search.service import nested_item_matches
from tests.torch_rest_pair import Pair

USERS = [f"u{i}" for i in range(7)]


def qa_mapping(shards: int, top_user: bool) -> dict:
    props = {
        "title": {"type": "text"}, "tag": {"type": "keyword"},
        "created": {"type": "date"},
        "v": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
        "answers": {"type": "nested", "properties": {
            "user": {"type": "keyword"}, "date": {"type": "date"},
            "score": {"type": "long"}, "body": {"type": "text"},
            "comments": {"type": "nested", "properties": {
                "who": {"type": "keyword"}}}}}}
    if top_user:
        # Rally's nested track: a top-level `user` beside `answers.user`
        props["user"] = {"type": "text"}
    return {"settings": {"number_of_shards": shards,
                         "index.mapping.nested_objects.limit": 12},
            "mappings": {"properties": props}}


def qa_docs(rng, n: int) -> list:
    docs = []
    for i in range(n):
        answers = []
        for _ in range(int(rng.integers(0, 5))):
            answers.append({
                "user": USERS[int(rng.integers(len(USERS)))],
                "date": f"2020-0{int(rng.integers(1, 10))}-"
                        f"1{int(rng.integers(0, 10))}",
                "score": int(rng.integers(0, 10)),
                "body": " ".join(rng.choice(["fast", "slow", "ok", "u3"],
                                            size=2)),
                "comments": [{"who": f"w{int(rng.integers(0, 3))}"}
                             for _ in range(int(rng.integers(0, 3)))]})
        doc = {"title": f"t{i % 5} word", "tag": f"g{i % 3}",
               "user": USERS[i % len(USERS)],
               "created": f"2019-1{i % 3}-0{1 + i % 9}",
               "v": np.round(rng.normal(size=8), 3).tolist()}
        if answers or rng.random() < 0.5:
            doc["answers"] = answers
        if rng.random() < 0.1 and answers:
            doc["answers"] = answers[0]          # one object, not a list
        docs.append(doc)
    return docs


def load_qa(pair, name: str, shards: int, seed: int, top_user: bool,
            n: int = 60):
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", qa_mapping(shards, top_user))
    ops = []
    for i, d in enumerate(qa_docs(rng, n)):
        if not top_user:
            d.pop("user")        # nor mapped dynamically
        ops += [{"index": {"_id": f"{name}{i}"}}, d]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    pair.same("POST", f"/{name}/_bulk",
              [{"delete": {"_id": f"{name}{i}"}} for i in range(0, n, 9)],
              ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("nested"), mp)
    load_qa(pair, "qa", request.param, 51, top_user=True)
    load_qa(pair, "qb", request.param, 52, top_user=False)
    yield pair
    pair.close()
    mp.undo()


def _total(body) -> int:
    return body["hits"]["total"]["value"]


def test_mapping_and_limit(world):
    """`nested` maps as the reference maps it, `GET /_mapping` renders
    `{"type": "nested", "properties": ...}`, and a document past the
    limit is the reference's 400, message and all."""
    _, got = world.same("GET", "/qa/_mapping")
    answers = got["qa"]["mappings"]["properties"]["answers"]
    assert answers["type"] == "nested"
    assert answers["properties"]["comments"]["type"] == "nested"
    # 5 answers with 2 comments each: 5 + 10 = 15 nested docs > 12
    doc = {"answers": [{"user": "u1", "comments": [{"who": "w1"}] * 2}] * 5}
    _, got = world.same("PUT", "/qb/_doc/over", doc)
    assert got["status"] == 400
    assert got["error"]["reason"].startswith(
        "The number of nested documents has exceeded the allowed limit "
        "of [12].")
    world.same("PUT", "/qb/_doc/under", {"answers": [{"user": "u1"}] * 12,
                                          "nested_free": [{"x": 1}] * 20})
    world.same("DELETE", "/qb/_doc/under")
    world.same("POST", "/qb/_refresh")


NESTED_QUERIES = {
    "term": {"term": {"answers.user": "u3"}},
    "terms": {"terms": {"answers.user": ["u1", "u5"]}},
    "range_date": {"range": {"answers.date": {"gte": "2020-05-01",
                                              "lt": "2020-08-01"}}},
    "range_score": {"range": {"answers.score": {"gt": 6}}},
    "bool_same_object": {"bool": {"must": [
        {"term": {"answers.user": "u2"}},
        {"range": {"answers.score": {"gte": 5}}}]}},
    "bool_should_msm": {"bool": {"should": [
        {"term": {"answers.user": "u2"}}, {"term": {"answers.user": "u4"}},
        {"range": {"answers.score": {"lte": 2}}}],
        "minimum_should_match": 2}},
    "bool_must_not": {"bool": {"must_not": [
        {"term": {"answers.user": "u0"}}], "filter": [
        {"exists": {"field": "answers.score"}}]}},
    # the stripped name `user` meets the top-level text mapper in `qa`
    "match_user": {"match": {"answers.user": "u3"}},
    "match_body_and": {"match": {"answers.body": {"query": "fast ok",
                                                  "operator": "and"}}},
    "prefix": {"prefix": {"answers.user": "U1"}},
    "wildcard": {"wildcard": {"answers.user": "u*3"}},
    "ids": {"ids": {"values": ["qa1"]}},
    "match_all": {"match_all": {}},
    "numeric_string_term": {"term": {"answers.score": "7"}},
}


@pytest.mark.parametrize("index", ["qa", "qb"])
@pytest.mark.parametrize("case", sorted(NESTED_QUERIES))
def test_nested_query(world, case, index):
    """One level, on an index with a top-level `user` field (the stripped
    name reads its mapper) and on one without (strings compare raw)."""
    body = {"query": {"nested": {"path": "answers", "query":
                                 NESTED_QUERIES[case],
                                 "score_mode": "max"}}, "size": 100}
    world.same("POST", f"/{index}/_search", body)


def test_stripped_name_meets_top_level_mapper(world):
    """`match` on `answers.user` analyzes with the top-level `user` mapper
    of `qa` (text: "U3!" is the token "u3"), and on `qb`, which has no
    such field, lowercases and splits on whitespace ("u3!" matches
    nothing); `term` "U3" matches neither."""
    body = {"query": {"nested": {"path": "answers", "query": {
        "match": {"answers.user": "U3!"}}}}}
    _, got = world.same("POST", "/qa/_search", body)
    assert _total(got) > 0
    _, got = world.same("POST", "/qb/_search", body)
    assert _total(got) == 0
    body["query"]["nested"]["query"] = {"term": {"answers.user": "U3"}}
    for index in ("qa", "qb"):
        _, got = world.same("POST", f"/{index}/_search", body)
        assert _total(got) == 0


@pytest.mark.parametrize("query", [
    {"nested": {"path": "answers.comments", "query": {
        "term": {"answers.comments.who": "w1"}}}},
    {"nested": {"path": "answers.comments", "query": {"bool": {
        "must_not": {"term": {"answers.comments.who": "w0"}}}}}},
    {"nested": {"path": "answers", "query": {"nested": {
        "path": "answers.comments", "query": {
            "term": {"answers.comments.who": "w1"}}}}}},
    {"nested": {"path": "answers", "query": {"more_like_this": {
        "like": "x"}}}},
    {"nested": {"path": "missing", "query": {"match_all": {}}}},
], ids=["two_levels", "two_levels_must_not", "nested_in_nested",
        "unsupported_kind", "missing_path"])
def test_nested_two_levels_and_refusals(world, query):
    world.same("POST", "/qa/_search", {"query": query, "size": 100})


@pytest.mark.parametrize("spec", [
    {}, {"size": 100, "name": "all", "version": True,
         "docvalue_fields": ["_seq_no", "_primary_term", "answers.user"]},
    {"size": 1},
], ids=["default", "size100", "size1"])
@pytest.mark.parametrize("inner", ["term", "match_user", "range_score",
                                   "bool_same_object", "match_all"])
def test_inner_hits(world, inner, spec):
    body = {"query": {"nested": {"path": "answers",
                                 "query": NESTED_QUERIES[inner],
                                 "inner_hits": spec}},
            "size": 20, "version": True}
    world.same("POST", "/qa/_search", body)


def test_inner_hits_use_the_looser_matcher(world):
    """The reference's inner hits list every object when the inner query
    is a kind their matcher does not know (`range`): an inner hit may hold
    an object the `nested` query itself would not match."""
    body = {"query": {"nested": {"path": "answers", "query": {
        "range": {"answers.score": {"gte": 8}}}, "inner_hits": {
            "size": 100}}}, "size": 100}
    _, got = world.same("POST", "/qa/_search", body)
    listed = [ih["_source"] for h in got["hits"]["hits"]
              for ih in h["inner_hits"]["answers"]["hits"]["hits"]]
    assert listed and any(o.get("score", 0) < 8 for o in listed)
    # `match` is a substring test there: "u1" lists "u1" only, but the
    # query's own analysis of "3 u" matches more
    item = {"user": "u13", "score": 1}
    assert nested_item_matches(item, "answers",
                               {"match": {"answers.user": "u1"}})
    assert not queries_ext.source_matches({"match": {"user": "u1"}}, item)


AGGS = {
    "terms_reverse": {"n": {"nested": {"path": "answers"}, "aggs": {
        "u": {"terms": {"field": "answers.user"}, "aggs": {
            "r": {"reverse_nested": {}},
            "s": {"max": {"field": "answers.score"}}}}}}},
    "date_histogram": {"n": {"nested": {"path": "answers"}, "aggs": {
        "d": {"date_histogram": {"field": "answers.date",
                                 "calendar_interval": "month"},
              "aggs": {"r": {"reverse_nested": {}, "aggs": {
                  "t": {"terms": {"field": "tag"}}}}}}}}},
    "two_levels": {"n": {"nested": {"path": "answers"}, "aggs": {
        "c": {"nested": {"path": "answers.comments"}, "aggs": {
            "w": {"terms": {"field": "answers.comments.who"}},
            "back": {"reverse_nested": {"path": "answers"}},
            "root": {"reverse_nested": {}}}}}}},
    "comments_count": {"n": {"nested": {"path": "answers.comments"}}},
    "under_terms": {"t": {"terms": {"field": "tag"}, "aggs": {
        "n": {"nested": {"path": "answers"}, "aggs": {
            "u": {"terms": {"field": "answers.user", "size": 3,
                            "order": {"_count": "asc"}}}}}}}},
    "reverse_outside": {"r": {"reverse_nested": {}}},
    "reverse_bad_path": {"n": {"nested": {"path": "answers"}, "aggs": {
        "r": {"reverse_nested": {"path": "answers"}}}}},
}


@pytest.mark.parametrize("case", sorted(AGGS))
def test_nested_aggs(world, case):
    """Final mode on one index, partial mode over two; the two
    `reverse_nested` cases are the reference's 400s."""
    body = {"size": 0, "aggs": AGGS[case], "request_cache": False,
            "query": {"range": {"created": {"gte": "2019-10-03"}}}}
    _, got = world.same("POST", "/qa/_search", body)
    if case.startswith("reverse_"):
        assert got["status"] == 400
    world.same("POST", "/qa,qb/_search", body)


def test_nested_terms_count_occurrences(world):
    """Inside `nested`, a `terms` bucket counts value occurrences (two
    answers of one question by one user count twice) while its
    `reverse_nested` counts the parents."""
    _, got = world.same("POST", "/qa/_search", {
        "size": 0, "aggs": AGGS["terms_reverse"]})
    buckets = got["aggregations"]["n"]["u"]["buckets"]
    assert sum(b["doc_count"] for b in buckets) \
        + got["aggregations"]["n"]["u"]["sum_other_doc_count"] \
        == got["aggregations"]["n"]["doc_count"]
    assert any(b["r"]["doc_count"] < b["doc_count"] for b in buckets)


def test_allow_expensive_queries_false(world):
    """`nested` is the reference's "joining" 400 while
    `search.allow_expensive_queries` is false, and answers once it is set
    back."""
    body = {"query": {"nested": {"path": "answers", "query": {
        "term": {"answers.user": "u3"}}}}, "request_cache": False}
    world.ref_node.cluster_settings.setdefault("persistent", {})[
        "search.allow_expensive_queries"] = "false"
    world.port_node.settings["search.allow_expensive_queries"] = "false"
    try:
        _, got = world.same("POST", "/qa/_search", body)
        assert got["status"] == 400 and "[joining]" in \
            got["error"]["reason"]
    finally:
        del world.ref_node.cluster_settings["persistent"][
            "search.allow_expensive_queries"]
        del world.port_node.settings["search.allow_expensive_queries"]
    world.same("POST", "/qa/_search", body)


@pytest.mark.parametrize("inner", ["term", "range_date", "bool_same_object"])
def test_nested_in_bool_and_as_knn_filter(world, inner):
    nested = {"nested": {"path": "answers", "query": NESTED_QUERIES[inner]}}
    qv = np.round(np.random.default_rng(7).normal(size=8), 3).tolist()
    world.same("POST", "/qa/_search", {"query": {"bool": {
        "must": [{"match": {"title": "word"}}], "filter": [nested],
        "must_not": [{"term": {"tag": "g0"}}]}}, "size": 50})
    world.same("POST", "/qa/_search", {"knn": {
        "field": "v", "query_vector": qv, "k": 5, "num_candidates": 40,
        "filter": nested}})
    world.same("POST", "/qa/_search", {"query": {"knn": {
        "field": "v", "query_vector": qv, "k": 5, "num_candidates": 40,
        "filter": [nested]}}})


# ---------------------------------------------------- the source matcher

_FIELDS = ["user", "t", "n", "d", "o.x", "o.y", "missing"]
_scalars = st.one_of(
    st.sampled_from(["u1", "u2", "U1", "7", "7.0", "x y", "2020-03-04",
                     "a-b", "3.5", ""]),
    st.integers(-3, 9), st.sampled_from([7.0, 3.5, -0.5]), st.booleans(),
    st.none())
_values = st.one_of(_scalars, st.lists(_scalars, max_size=3))
_objects = st.fixed_dictionaries({}, optional={
    "user": _values, "t": _values, "n": _values, "d": _values,
    "o": st.one_of(st.fixed_dictionaries({}, optional={"x": _values,
                                                       "y": _values}),
                   st.lists(st.fixed_dictionaries({"x": _scalars}),
                            max_size=2))})


def _leaf():
    field = st.sampled_from(_FIELDS)
    target = st.one_of(_scalars, st.sampled_from(["u", "U", "*1", "u?"]))
    bound = st.sampled_from([None, 0, 3, 7.0, "5", "2020-01-01",
                             "2020-06-01"])
    return st.one_of(
        st.builds(lambda f, t: {"term": {f: t}}, field, target),
        st.builds(lambda f, t: {"term": {f: {"value": t}}}, field, target),
        st.builds(lambda f, ts: {"terms": {f: ts}}, field,
                  st.lists(_scalars, max_size=3)),
        st.builds(lambda f, t, op: {"match": {f: {"query": t,
                                                  "operator": op}}},
                  field, st.sampled_from(["u1 x", "y", "7", "U2"]),
                  st.sampled_from(["or", "and"])),
        st.builds(lambda f, a, b: {"range": {f: {
            k: v for k, v in (("gte", a), ("lt", b)) if v is not None}}},
            field, bound, bound),
        st.builds(lambda f: {"exists": {"field": f}}, field),
        st.builds(lambda f, p: {"prefix": {f: p}}, field,
                  st.sampled_from(["u", "U1", "x", ""])),
        st.builds(lambda f, p: {"wildcard": {f: {"value": p}}}, field,
                  st.sampled_from(["u*", "*1", "x?y", "7*"])),
        st.just({"ids": {"values": ["1"]}}), st.just({"match_all": {}}),
        st.just({"match_none": {}}),
        st.just({"match_phrase": {"t": "x y"}}))


_queries = st.recursive(
    _leaf(), lambda inner: st.builds(
        lambda must, flt, not_, should, msm: {"bool": {
            k: v for k, v in (("must", must), ("filter", flt),
                              ("must_not", not_), ("should", should),
                              ("minimum_should_match", msm)) if v}},
        st.lists(inner, max_size=2), st.lists(inner, max_size=1),
        st.lists(inner, max_size=1), st.lists(inner, max_size=3),
        st.sampled_from([None, 1, 2])), max_leaves=6)

_MAPPING = {"properties": {"user": {"type": "keyword"},
                           "t": {"type": "text"}, "n": {"type": "long"}}}
_SERVICES = [(None, None), (RefMapperService(_MAPPING),
                            MapperService(_MAPPING))]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:   # noqa: BLE001
        return type(e).__name__


@settings(max_examples=400, deadline=None)
@given(query=_queries, obj=_objects, services=st.sampled_from(_SERVICES))
def test_source_matches_equals_reference(query, obj, services):
    """The port's matcher answers as the reference's on random objects
    and queries of every supported kind, and an unsupported kind
    (`match_phrase`) raises in both (unless a clause before it decides)."""
    ref_ms, port_ms = services
    want = _outcome(lambda: ref_ext.source_matches(query, obj, ref_ms))
    got = _outcome(lambda: queries_ext.source_matches(query, obj, port_ms))
    assert got == want


def test_unsupported_kind_raises_in_both():
    for fn in (ref_ext.source_matches, queries_ext.source_matches):
        with pytest.raises(Exception) as e:
            fn({"match_phrase": {"t": "x"}}, {"t": "x"})
        assert type(e.value).__name__ == "ParsingError"
        assert "[match_phrase] query is not supported" in str(e.value)


@settings(max_examples=300, deadline=None)
@given(query=_queries, objs=st.lists(_objects, min_size=1, max_size=6),
       services=st.sampled_from(_SERVICES))
def test_vectorized_matcher_equals_evaluator(query, objs, services):
    """Where `nested` runs the vectorized matcher, each object's answer is
    the evaluator's own."""
    port_ms = services[1]
    if not queries_ext._vectorizable(query, port_ms):
        return
    table = queries_ext._Objects(np.arange(len(objs)), objs)
    mask = queries_ext._objects_mask(query, table)
    want = [queries_ext.source_matches(query, o, port_ms) for o in objs]
    assert mask.tolist() == want
