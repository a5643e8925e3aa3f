"""The bucket aggregations through both REST layers on the CPU, request for
request (`tests/torch_rest_pair.py`), on the seeded world of
`test_torch_aggs_metrics.py` (a one-shard index, a two-shard index and
two indices): `rare_terms`, a `terms` `script`, `significant_terms`
(JLH over background counts, merged across indices), `significant_text`
(with `filter_duplicate_text`), `auto_date_histogram` (re-bucketed after
the merge), `sampler`, `adjacency_matrix`, `composite` (`terms`,
`histogram`, `date_histogram` and `geotile_grid` sources, `after` paging,
`missing_bucket`), `geohash_grid` and `geotile_grid`, each alone and under
a bucket, a few under `nested`; the parameter checks of each; a
property test that the union of a composite's pages is its one-page
answer and the reference's; and one of random trees of every kind with
parent and sibling pipelines.

Aggregations compare with `==` on the decoded JSON: bucket keys, counts,
scores and sub-aggregations are the reference's to the bit, so no
tolerance is stated."""

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from tests.test_torch_aggs_metrics import (  # noqa: F401  (the fixture)
    TARGETS, a_, same_aggs, under_bucket, world,
)

SUB = {"a": {"avg": {"field": "n"}}, "c": {"cardinality": {"field": "tag"}}}
BUCKETS = {
    "rare_terms": {"x": {"rare_terms": {"field": "tag"}},
                   "y": {"rare_terms": {"field": "n", "max_doc_count": 3},
                         "aggs": SUB},
                   "z": {"rare_terms": {"field": "tags",
                                        "exclude": ["red"]}}},
    "terms_script": {"x": {"terms": {"script": "doc['n'].value"}},
                     "y": {"terms": {"script": {"source": "doc['pos'].value"},
                                     "size": 3}}},
    "significant_terms": {
        "x": {"significant_terms": {"field": "tags", "min_doc_count": 1}},
        "y": {"significant_terms": {"field": "n", "min_doc_count": 2,
                                    "size": 5}, "aggs": SUB}},
    "significant_text": {
        "x": {"significant_text": {"field": "t", "min_doc_count": 2}},
        "y": {"significant_text": {"field": "t", "min_doc_count": 1,
                                   "filter_duplicate_text": True}}},
    "auto_date_histogram": {
        "x": {"auto_date_histogram": {"field": "d", "buckets": 5},
              "aggs": SUB},
        "y": {"auto_date_histogram": {"field": "d", "buckets": 40}}},
    "sampler": {"x": {"sampler": {"shard_size": 30},
                      "aggs": {"t": {"terms": {"field": "tag"}}, **SUB}}},
    "adjacency_matrix": {"x": {"adjacency_matrix": {"filters": {
        "r": {"term": {"tag": "red"}}, "big": {"range": {"n": {"gte": 30}}},
        "t": {"term": {"b": True}}}}, "aggs": SUB}},
    "composite": {
        "x": {"composite": {"sources": [
            {"t": {"terms": {"field": "tag"}}},
            {"h": {"histogram": {"field": "n", "interval": 10}}}],
            "size": 7}, "aggs": SUB},
        "y": {"composite": {"sources": [
            {"d": {"date_histogram": {"field": "d",
                                      "calendar_interval": "month",
                                      "format": "yyyy-MM"}}},
            {"b": {"terms": {"field": "b", "missing_bucket": True}}}],
            "size": 20}},
        "z": {"composite": {"sources": [
            {"g": {"geotile_grid": {"field": "g", "precision": 2}}},
            {"ip": {"terms": {"field": "ip"}}}], "size": 9}},
        "w": {"composite": {"sources": [
            {"ts": {"terms": {"field": "tags"}}},
            {"f": {"date_histogram": {"field": "d",
                                      "fixed_interval": "7d"}}}],
            "size": 12, "after": {"ts": "blue", "f": 1578441600000}}}},
    "geohash_grid": {"x": {"geohash_grid": {"field": "g", "precision": 2},
                           "aggs": {"c": {"geo_centroid": {"field": "g"}},
                                    "b": {"geo_bounds": {"field": "g"}}}},
                     "y": {"geohash_grid": {"field": "g", "precision": 1,
                                            "size": 4}}},
    "geotile_grid": {"x": {"geotile_grid": {"field": "g", "precision": 3},
                           "aggs": SUB},
                     "y": {"geotile_grid": {"field": "g", "precision": 1}}},
}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_bucket_parity(world, case, target):
    """Each bucket kind alone and under a terms bucket over one index, two
    shards and two indices equals the reference (a composite under a
    bucket is the reference's 400)."""
    same_aggs(world, f"/{target}/_search", a_(**BUCKETS[case]))
    same_aggs(world, f"/{target}/_search", a_(**under_bucket(BUCKETS[case])))


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("query", [
    {"term": {"tag": "red"}}, {"range": {"n": {"gte": 40}}},
    {"match": {"t": "alpha gamma"}}], ids=["term", "range", "match"])
def test_significant_over_a_foreground(world, target, query):
    """significant_terms / significant_text over a query's rows against
    the whole index (or each index, merged)."""
    body = {"size": 0, "query": query, "request_cache": False, "aggs": {
        "st": {"significant_terms": {"field": "tag", "min_doc_count": 1}},
        "sn": {"significant_terms": {"field": "n", "min_doc_count": 1}},
        "sx": {"significant_text": {"field": "t", "min_doc_count": 1}},
        "sb": {"significant_terms": {"field": "b", "min_doc_count": 1,
                                     "include": ["true"]}}}}
    same_aggs(world, f"/{target}/_search", body)


NESTED = {
    "composite": {"cp": {"composite": {"sources": [
        {"a": {"terms": {"field": "c.a"}}}], "size": 5}}},
    "rare_terms": {"r": {"rare_terms": {"field": "c.a",
                                        "max_doc_count": 40}}},
    "sampler": {"s": {"sampler": {"shard_size": 10},
                      "aggs": {"a": {"terms": {"field": "c.a"}}}}},
}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("case", sorted(NESTED))
def test_bucket_under_nested(world, case, target):
    same_aggs(world, f"/{target}/_search",
              a_(n={"nested": {"path": "c"}, "aggs": NESTED[case]}))


def _pages(pair, send, target: str, sources: list, size: int) -> list:
    """Every page of a composite, following `after_key` to the end."""
    buckets, after = [], None
    for _ in range(200):
        spec = {"sources": sources, "size": size}
        if after is not None:
            spec["after"] = after
        resp = send("POST", f"/{target}/_search",
                    a_(c={"composite": spec}))[1]
        page = resp["aggregations"]["c"]
        buckets += page["buckets"]
        if not page["buckets"]:
            return buckets
        after = page["after_key"]
    raise AssertionError("the composite did not end")


SOURCES = [
    [{"t": {"terms": {"field": "tag"}}}],
    [{"t": {"terms": {"field": "tag", "missing_bucket": True}}},
     {"b": {"terms": {"field": "b"}}}],
    [{"h": {"histogram": {"field": "n", "interval": 7}}},
     {"t": {"terms": {"field": "tags"}}}],
    [{"d": {"date_histogram": {"field": "d", "calendar_interval": "week",
                               "format": "yyyy-MM-dd"}}}],
    [{"d": {"date_histogram": {"field": "d", "fixed_interval": "3d"}}},
     {"ip": {"terms": {"field": "ip"}}}],
    [{"g": {"geotile_grid": {"field": "g", "precision": 1}}}],
]


@settings(max_examples=12, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(which=st.integers(0, len(SOURCES) - 1), size=st.integers(1, 40),
       target=st.sampled_from(TARGETS))
def test_composite_pages_union_is_one_page(world, which, size, target):
    """The union of a composite's pages, paged with `after_key` to the end,
    is its one-page answer, and every page is the reference's."""
    sources = SOURCES[which]
    got = _pages(world, world.port, target, sources, size)
    want = _pages(world, world.ref, target, sources, size)
    assert got == want
    whole = world.port("POST", f"/{target}/_search", a_(c={"composite": {
        "sources": sources, "size": 10_000}}))[1]["aggregations"]["c"]
    assert got == whole["buckets"]


@pytest.mark.parametrize("body", [
    a_(c={"composite": {"sources": []}}),
    a_(c={"composite": {"sources": [{"a": {"terms": {"field": "tag"}}},
                                    {"a": {"terms": {"field": "n"}}}]}}),
    a_(c={"composite": {"sources": [{"a": {"nope": {"field": "tag"}}}]}}),
    a_(c={"composite": {"size": 100_000, "sources": [
        {"a": {"terms": {"field": "tag"}}}]}}),
    a_(s={"significant_terms": {"field": "tag", "sizes": 3}}),
    a_(s={"significant_text": {"field": "t", "huristic": {}}}),
    a_(r={"rare_terms": {"field": "n", "include": "1.*"}}),
    a_(f={"adjacency_matrix": {"filters": {"x": {"nope": {}}}}}),
], ids=["no_sources", "duplicate_sources", "unknown_source",
        "composite_size", "sig_unknown_key", "sig_text_unknown_key",
        "rare_regex_numeric", "adjacency_bad_query"])
def test_bucket_errors(world, body):
    for target in ("k1", "k1,kx"):
        want, got = world.same("POST", f"/{target}/_search", body)
        assert got["status"] >= 400, got


def test_typed_keys_of_new_buckets(world):
    body = a_(s={"significant_terms": {"field": "tag", "min_doc_count": 1}},
              n={"significant_terms": {"field": "n", "min_doc_count": 1}},
              x={"significant_text": {"field": "t", "min_doc_count": 1}},
              sm={"sampler": {}, "aggs": {"r": {"rare_terms": {
                  "field": "tag"}}}},
              c={"composite": {"sources": [{"t": {"terms": {
                  "field": "tag"}}}]}})
    for target in TARGETS:
        want, got = same_aggs(world, f"/{target}/_search", body,
                              query={"typed_keys": "true"})
        assert "sigsterms#s" in got["aggregations"]
        assert "siglterms#n" in got["aggregations"]


_METRIC_BODIES = [
    {"avg": {"field": "n"}}, {"stats": {"field": "pos"}},
    {"cardinality": {"field": "tags"}}, {"percentiles": {"field": "f"}},
    {"percentile_ranks": {"field": "n", "values": [20]}},
    {"median_absolute_deviation": {"field": "f"}},
    {"boxplot": {"field": "pos"}},
    {"weighted_avg": {"value": {"field": "f"}, "weight": {"field": "w"}}},
    {"string_stats": {"field": "tags"}},
    {"top_metrics": {"metrics": {"field": "f"}, "sort": {"pos": "desc"}}},
    {"matrix_stats": {"fields": ["n", "f"]}},
    {"top_hits": {"size": 2, "sort": [{"n": "asc"}]}},
    {"geo_bounds": {"field": "g"}}, {"geo_centroid": {"field": "g"}},
    {"percentiles": {"field": "pos", "hdr": {}}},
]
_BUCKET_BODIES = [
    {"terms": {"field": "tags", "size": 3}}, {"terms": {"field": "n"}},
    {"rare_terms": {"field": "tag", "max_doc_count": 30}},
    {"significant_terms": {"field": "tags", "min_doc_count": 1}},
    {"histogram": {"field": "pos", "interval": 25}},
    {"date_histogram": {"field": "d", "calendar_interval": "month"}},
    {"auto_date_histogram": {"field": "d", "buckets": 4}},
    {"sampler": {"shard_size": 40}},
    {"adjacency_matrix": {"filters": {"r": {"term": {"tag": "red"}},
                                      "h": {"range": {"n": {"gte": 30}}}}}},
    {"geotile_grid": {"field": "g", "precision": 1}},
    {"composite": {"sources": [{"t": {"terms": {"field": "tag"}}}],
                   "size": 4}},
]
_PARENTS = [{"derivative": {"buckets_path": "_count"}},
            {"cumulative_sum": {"buckets_path": "_count"}},
            {"bucket_sort": {"sort": [{"_count": "desc"}], "size": 2}}]


@st.composite
def _agg_trees(draw):
    """A body of one to three aggregations: a bucket kind with up to two
    metric or bucket sub-aggregations and maybe a parent pipeline, or a
    metric; and maybe a sibling pipeline over the first histogram."""
    aggs = {}
    for i in range(draw(st.integers(1, 3))):
        if draw(st.booleans()):
            aggs[f"m{i}"] = draw(st.sampled_from(_METRIC_BODIES))
            continue
        node = dict(draw(st.sampled_from(_BUCKET_BODIES)))
        subs = {f"s{j}": draw(st.sampled_from(_METRIC_BODIES
                                              + _BUCKET_BODIES[:3]))
                for j in range(draw(st.integers(0, 2)))}
        if "composite" not in node and draw(st.booleans()):
            subs["p"] = draw(st.sampled_from(_PARENTS))
        if subs:
            node["aggs"] = subs
        aggs[f"b{i}"] = node
    hist = [n for n, s in aggs.items() if "histogram" in s]
    if hist and draw(st.booleans()):
        aggs["sib"] = {draw(st.sampled_from(["avg_bucket", "max_bucket",
                                             "stats_bucket"])): {
            "buckets_path": f"{hist[0]}>_count"}}
    return a_(**aggs)


@settings(max_examples=25, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(body=_agg_trees(), target=st.sampled_from(TARGETS))
def test_random_trees_match_reference(world, body, target):
    """Trees drawn from the kinds above answer as the reference (status
    and body; a composite under a bucket is its 400 in both)."""
    want, got = world.same("POST", f"/{target}/_search", body)
    assert want.get("aggregations") == got.get("aggregations")
