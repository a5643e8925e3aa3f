"""The rest of the query DSL through both REST layers on the CPU, request
for request (`tests/torch_rest_pair.py`): `prefix`, `wildcard`, `regexp`,
`fuzzy` and `span_multi`; `fuzziness` on `match` and on `multi_match`'s
`bool_prefix`; `match_phrase_prefix` and `match_bool_prefix`;
`query_string` / `simple_query_string`; `dis_max`, `boosting` and
`function_score` (each score and boost mode); the URL `q` on `_search`
and `_count` with its parameters and its conflict with a body query; and
`search.allow_expensive_queries: false`, `index.max_regex_length` and the
kinds still left out. Over the seeded mixed index (`tests/torch_mixed.py`,
~200 documents with deletes and updates) and a small text index of near
spellings, at 1 and 2 shards; then the port's term enumeration against a
plain scan of every term."""

import numpy as np
import pytest

from elasticsearch_tpu.search import queries as ref_queries
from elasticsearch_tpu_torch.search import queries as port_queries
from tests.torch_rest_pair import Pair, load_mixed

SPELLINGS = ["search", "serch", "seach", "searching", "research", "fox",
             "foxes", "box", "quick", "quack", "quickly", "brown", "browne",
             "crown", "alpha", "alpah", "lapha", "zeta", "jump", "jumped"]


def text_docs(rng, n: int) -> list:
    return [{"title": " ".join(rng.choice(SPELLINGS,
                                          size=int(rng.integers(2, 7)))),
             "code": f"c{int(rng.integers(0, 40)):02d}",
             "rank": int(rng.integers(0, 100)),
             "w": round(float(rng.random() * 4), 3)}
            for _ in range(n)]


def load_text(pair, name: str, shards: int, seed: int, n: int = 120):
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards,
                     "index.max_regex_length": 12},
        "mappings": {"properties": {
            "title": {"type": "text"}, "code": {"type": "keyword"},
            "rank": {"type": "integer"}, "w": {"type": "float"}}}})
    docs = text_docs(rng, n)
    for lo, hi in ((0, n // 2), (n // 2, n)):
        ops = []
        for i in range(lo, hi):
            ops += [{"index": {"_id": f"{name}{i}"}}, docs[i]]
        pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        pair.same("POST", f"/{name}/_refresh")
    pair.same("POST", f"/{name}/_bulk",
              [{"delete": {"_id": f"{name}{i}"}} for i in range(0, n, 7)],
              ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("dsl"), mp)
    load_mixed(pair, "a", request.param, 31)
    load_text(pair, "w", request.param, 32)
    yield pair
    pair.close()
    mp.undo()


QUERIES = {
    "prefix_text": {"prefix": {"t": "al"}},
    "prefix_keyword": {"prefix": {"tag": {"value": "gr"}}},
    "prefix_none": {"prefix": {"t": "zzz"}},
    "wildcard_text": {"wildcard": {"t": "*eta"}},
    "wildcard_keyword": {"wildcard": {"tag": {"value": "?ed"}}},
    "wildcard_key": {"wildcard": {"s": {"wildcard": "s*"}}},
    "regexp_text": {"regexp": {"t": "[a-d].*a"}},
    "regexp_keyword": {"regexp": {"s": {"value": "s[0-3]"}}},
    "fuzzy_transposed": {"fuzzy": {"t": "alpah"}},
    "fuzzy_two": {"fuzzy": {"t": {"value": "gamam", "fuzziness": 2}}},
    "fuzzy_keyword": {"fuzzy": {"tag": {"value": "gren"}}},
    "fuzzy_short": {"fuzzy": {"t": "et"}},
    "match_fuzzy": {"match": {"t": {"query": "alpah betta",
                                    "fuzziness": "AUTO"}}},
    "match_fuzzy_and": {"match": {"t": {"query": "alpah zeat",
                                        "fuzziness": 1,
                                        "operator": "and"}}},
    "match_fuzzy_keyword": {"match": {"tag": {"query": "bleu",
                                              "fuzziness": "AUTO"}}},
    "multi_match_bool_prefix": {"multi_match": {
        "query": "alpha be", "fields": ["t"], "type": "bool_prefix"}},
    "multi_match_bool_prefix_fuzzy": {"multi_match": {
        "query": "alpah gam", "fields": ["t^2", "s"], "type": "bool_prefix",
        "fuzziness": "AUTO", "operator": "and"}},
    "multi_match_fuzziness_ignored": {"multi_match": {
        "query": "alpah", "fields": ["t"], "fuzziness": 1}},
    "match_phrase_prefix": {"match_phrase_prefix": {"t": "alpha be"}},
    "match_phrase_prefix_one": {"match_phrase_prefix": {
        "t": {"query": "ze"}}},
    "match_phrase_prefix_keyword": {"match_phrase_prefix": {"tag": "bl"}},
    "match_bool_prefix": {"match_bool_prefix": {"t": "gamma alpha e"}},
    "match_bool_prefix_opts": {"match_bool_prefix": {"t": {
        "query": "gamam alpha e", "fuzziness": "AUTO",
        "minimum_should_match": 2, "boost": 2.0}}},
    "span_multi": {"span_multi": {"match": {"prefix": {"t": "ka"}}}},
    "qs_and": {"query_string": {"query": "alpha AND beta"}},
    "qs_phrase": {"query_string": {"query": "\"alpha beta\""}},
    "qs_field_wildcard": {"query_string": {"query": "t:al*"}},
    "qs_or_not": {"query_string": {"query": "alpha OR -gamma eta"}},
    "qs_range": {"query_string": {"query": "n:[3 TO 10] AND tag:red"}},
    "qs_open_range": {"query_string": {"query": "f:{5 TO *]"}},
    "qs_not": {"query_string": {"query": "NOT beta",
                                "default_field": "t"}},
    "qs_regexp": {"query_string": {"query": "/al.*/"}},
    "qs_field_regexp": {"query_string": {"query": "s:/s[12]/ +t:iota"}},
    "qs_all": {"query_string": {"query": "*"}},
    "qs_operator_and": {"query_string": {"query": "alpha gamma",
                                         "default_operator": "AND",
                                         "fields": ["t", "s"]}},
    "qs_boost": {"query_string": {"query": "eta theta", "boost": 3.0}},
    "simple_query_string": {"simple_query_string": {
        "query": "kappa +zeta", "fields": ["t"]}},
    "dis_max": {"dis_max": {"queries": [
        {"match": {"t": "alpha"}}, {"match": {"t": "beta gamma"}},
        {"term": {"tag": "red"}}], "tie_breaker": 0.3}},
    "dis_max_plain": {"dis_max": {"queries": [
        {"match": {"t": "eta"}}, {"prefix": {"t": "th"}}]}},
    "boosting": {"boosting": {"positive": {"match": {"t": "alpha"}},
                              "negative": {"term": {"tag": "blue"}},
                              "negative_boost": 0.2}},
    "boosting_default": {"boosting": {
        "positive": {"match": {"t": "beta eta"}},
        "negative": {"range": {"n": {"lt": 10}}}}},
    "function_score_weight": {"function_score": {
        "query": {"match": {"t": "alpha"}}, "weight": 2.5}},
    "function_score_fvf": {"function_score": {
        "query": {"match": {"t": "gamma delta"}},
        "field_value_factor": {"field": "f", "factor": 1.5,
                               "modifier": "log1p", "missing": 2}}},
    "function_score_fvf_int": {"function_score": {
        "field_value_factor": {"field": "n", "modifier": "sqrt"},
        "boost_mode": "replace"}},
    "function_score_fvf_bool": {"function_score": {
        "field_value_factor": {"field": "b", "missing": 7},
        "boost_mode": "sum"}},
}

_MODES = ("multiply", "sum", "max", "min", "avg")
for _sm in _MODES:
    for _bm in _MODES + ("replace",):
        QUERIES[f"function_score_{_sm}_{_bm}"] = {"function_score": {
            "query": {"match": {"t": "zeta eta"}},
            "functions": [
                {"field_value_factor": {"field": "f",
                                        "modifier": "square"}},
                {"weight": 0.5},
                {"field_value_factor": {"field": "n", "factor": 0.1},
                 "weight": 3}],
            "score_mode": _sm, "boost_mode": _bm}}

TEXT_QUERIES = {
    "fuzzy_search": {"fuzzy": {"title": "serch"}},
    "fuzzy_long": {"fuzzy": {"title": "searchin"}},
    "fuzzy_code": {"fuzzy": {"code": {"value": "c1", "fuzziness": 1}}},
    "match_fuzzy": {"match": {"title": {"query": "quik brwn foks",
                                        "fuzziness": "AUTO"}}},
    "match_fuzzy_two": {"match": {"title": {"query": "jumpd",
                                            "fuzziness": 2}}},
    "prefix": {"prefix": {"title": "qu"}},
    "wildcard": {"wildcard": {"title": "*rown*"}},
    "wildcard_q": {"wildcard": {"code": "c?5"}},
    "regexp": {"regexp": {"title": "[fb]ox(es)?"}},
    "phrase_prefix": {"match_phrase_prefix": {"title": "quick b"}},
    "bool_prefix": {"match_bool_prefix": {"title": "alpah se"}},
    "qs": {"query_string": {"query": "title:fox* OR code:c1?",
                            "default_operator": "and"}},
    "qs_range_prefix": {"query_string": {
        "query": "rank:[10 TO 50} AND (jump OR alpha)"}},
    "fs": {"function_score": {"query": {"match": {"title": "search"}},
                              "field_value_factor": {"field": "w",
                                                     "modifier": "square"},
                              "boost_mode": "avg"}},
    "dis_max_fuzzy": {"dis_max": {"queries": [
        {"fuzzy": {"title": "crwn"}}, {"prefix": {"code": "c3"}}],
        "tie_breaker": 0.5}},
}


def _bodies(query):
    return ({"query": query, "size": 25},
            {"query": {"bool": {"filter": [query]}}, "size": 5,
             "_source": False},
            {"query": {"bool": {"must": [query],
                                "must_not": [{"term": {"tag": "cyan"}}]}},
             "size": 10, "from": 3})


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_query_kind_matches_reference(world, case):
    for body in _bodies(QUERIES[case]):
        world.same("POST", "/a/_search", body)
    world.same("POST", "/a/_count", {"query": QUERIES[case]})


@pytest.mark.parametrize("case", sorted(TEXT_QUERIES))
def test_text_query_matches_reference(world, case):
    want, _ = world.same("POST", "/w/_search",
                         {"query": TEXT_QUERIES[case], "size": 40})
    world.same("POST", "/w,a/_search",
               {"query": TEXT_QUERIES[case], "size": 10})


@pytest.mark.parametrize("query", [
    {"q": "alpha"},
    {"q": "t:beta OR tag:red", "size": "20"},
    {"q": "alpha gamma", "default_operator": "AND"},
    {"q": "alpha gamma", "default_operator": "and", "df": "t"},
    {"q": "s*", "df": "s", "analyze_wildcard": "true"},
    {"q": "n:[5 TO 9]", "lenient": "true", "sort": "n:desc"},
    {"q": "eta", "analyzer": "standard", "from": "2"},
], ids=["bare", "fields", "and", "df", "wildcard", "range", "analyzer"])
def test_uri_q_matches_reference(world, query):
    world.same("GET", "/a/_search", query=query)
    world.same("GET", "/a/_count", query={"q": query["q"],
                                          **({"df": query["df"]}
                                             if "df" in query else {})})
    world.same("POST", "/a/_search", {"size": 3}, query=query)


def test_uri_q_with_body_query_is_the_reference_400(world):
    for path in ("/a/_search", "/a/_count"):
        want, got = world.same("POST", path,
                               {"query": {"match_all": {}}},
                               query={"q": "alpha"})
        assert got["status"] == 400
        assert "cannot specify both [q] parameter" \
            in got["error"]["reason"]


@pytest.mark.parametrize("query", [
    {"prefix": {"t": "al"}}, {"wildcard": {"t": "a*"}},
    {"regexp": {"t": "a.*"}}, {"fuzzy": {"t": "alpah"}},
    {"match": {"t": {"query": "alpah", "fuzziness": 1}}},
    {"range": {"tag": {"gte": "b"}}}, {"range": {"t": {"lt": "c"}}},
    {"query_string": {"query": "t:al*"}},
], ids=["prefix", "wildcard", "regexp", "fuzzy", "match_fuzziness",
        "range_keyword", "range_text", "query_string"])
def test_allow_expensive_queries_false(world, query):
    """`search.allow_expensive_queries: false` (the reference's cluster
    setting, the port's node setting): each expensive kind is the
    reference's 400, alone and as a hybrid body's generic leg, a fuzzy
    `match` is not refused, and numeric ranges run; set back, the same
    bodies answer (no cached answer crosses the setting)."""
    world.ref_node.cluster_settings.setdefault("persistent", {})[
        "search.allow_expensive_queries"] = "false"
    world.port_node.settings["search.allow_expensive_queries"] = "false"
    hybrid = {"sub_searches": [{"query": query}, {"query": {"knn": {
        "field": "v", "query_vector": [0.5] * 16, "k": 5,
        "num_candidates": 20}}}], "rank": {"rrf": {}}, "size": 5}
    try:
        world.same("POST", "/a/_search", {"query": query,
                                          "request_cache": False})
        _same_hybrid(world, hybrid)
        world.same("POST", "/a/_search", {
            "query": {"range": {"n": {"gte": 4}}}, "request_cache": False})
    finally:
        del world.ref_node.cluster_settings["persistent"][
            "search.allow_expensive_queries"]
        del world.port_node.settings["search.allow_expensive_queries"]
    world.same("POST", "/a/_search", {"query": query})
    _same_hybrid(world, hybrid)


def _same_hybrid(world, body):
    """A hybrid body's status and hits, or its error, as the reference's
    (on this index the reference answers its fused path without
    `_shards`, whatever the legs)."""
    s1, want = world.ref("POST", "/a/_search", body)
    s2, got = world.port("POST", "/a/_search", body)
    assert s1 == s2, (want, got)
    if s1 == 200:
        world.match(want["hits"], got["hits"], "hybrid")
    else:
        world.match(want, got, "hybrid")


@pytest.mark.parametrize("query", [
    {"regexp": {"title": "(fox|box|crown)+"}},
    {"regexp": {"title": "[a-"}},
    {"query_string": {"query": "title:/(search|research)s?/"}},
    {"query_string": {"query": "default_operator", "default_operator":
                      "xor"}},
    {"nested": {"path": "x", "query": {"match_all": {}}}},
    {"more_like_this": {"fields": ["title"], "like": "fox"}},
    {"geo_distance": {"distance": "1km", "p": {"lat": 0, "lon": 0}}},
    {"fuzzy": {"title": {"value": "fox", "fuzziness": "AUTO:3,6"}}},
], ids=["regex_length", "regex_invalid", "qs_regex_length", "qs_operator",
        "nested", "more_like_this", "geo_distance", "fuzziness_format"])
def test_refusals_match_reference_status(world, query):
    """`index.max_regex_length` (12 on the text index) and an invalid
    regexp are the reference's 400s with its message; an unknown
    `default_operator` its parsing error; a `fuzziness` of another form
    the reference's 500; and the kinds once left out (`nested`,
    `more_like_this`, `geo_distance`) the reference's answer."""
    s2, got = world.port("POST", "/w/_search", {"query": query})
    if next(iter(query)) in ("more_like_this", "geo_distance", "nested"):
        world.same("POST", "/w/_search", {"query": query})
        return
    s1, want = world.ref("POST", "/w/_search", {"query": query})
    assert s1 == s2 and s2 in (400, 500), (want, got)
    assert got["error"]["type"] == want["error"]["type"]
    assert got["error"]["reason"] == want["error"]["reason"]


# ----------------------------------------------- the term enumeration alone

class _Postings:
    def __init__(self, terms):
        self.terms = np.asarray(sorted(set(terms)), dtype=str)
        self.term_shape = None


class _Segment:
    def __init__(self, terms):
        self.postings = {"f": _Postings(terms)}


class _View:
    def __init__(self, terms):
        self.segment = _Segment(terms)


class _Reader:
    def __init__(self, segments):
        self.views = [_View(t) for t in segments]


class _Ctx:
    def __init__(self, segments):
        self.reader = _Reader(segments)


def _vocab(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    alphabet = list("abcdeéz0129ß")
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 9))))
            for _ in range(n)]


@pytest.mark.parametrize("k", [1, 2])
def test_fuzzy_enumeration_matches_a_plain_scan(k):
    """The port's length and bag-distance prefilters before OSA drop no
    term a plain scan of every term with the reference's OSA admits, over
    two segments of random words (non-ASCII code points folded into
    buckets too)."""
    segs = [_vocab(5, 3000), _vocab(6, 2000)]
    ctx = _Ctx(segs)
    every = sorted(set(segs[0]) | set(segs[1]))
    for probe in _vocab(7, 60) + ["", "a", "ab0", "zzzzzzzzzz"]:
        want = sorted(t for t in every
                      if ref_queries._edit_distance_le(probe, t, k))
        assert port_queries._fuzzy_terms(ctx, "f", probe, k) == want
        assert port_queries._fuzzy_terms(
            ctx, "f", probe, k, exclude_self=True) \
            == [t for t in want if t != probe]


@pytest.mark.parametrize("prefix", ["", "a", "ab", "é", "z0", "ß",
                                    "zzzzzz", "\U0010ffff"])
def test_prefix_range_matches_startswith(prefix):
    segs = [_vocab(8, 2000), _vocab(9, 500) + ["\U0010ffffx"]]
    got = port_queries._pattern_terms(_Ctx(segs), "f",
                                      port_queries._prefix_select(prefix))
    assert got == sorted({t for s in segs for t in s
                          if t.startswith(prefix)})
