"""Aggregations through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`): the reference runs its host path
(`search.aggs.device_enabled: false`); the port runs its device rung on
CPU tensors with the router off (`device`) or its host path (`host`).
Seeded documents with missing values, multi-valued keywords, deletes and
updates, in a one-shard index, a three-shard index and over two indices
(partial states, merged and finalized). Each ported kind with its
parameters, sub-aggregations three deep, `post_filter` scope, `typed_keys`,
`_msearch`, the request cache, a hybrid `rank: {rrf}` body, the
`max_buckets` error, and each kind once left out answering as the
reference (`test_torch_aggs_metrics.py`, `_buckets.py` and
`_pipelines.py` hold them to it in depth).

Aggregations compare with `==` on the decoded JSON: counts, sums, minima,
maxima and every float (the port runs the reference's numpy arithmetic,
and its device boards sum integral columns exactly), so no tolerance is
stated."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

TAGS = ["red", "green", "blue", "cyan", "teal"]
DAY = 86_400_000
T0 = 1_577_836_800_000          # 2020-01-01T00:00:00Z
MAPPING = {"properties": {
    "tag": {"type": "keyword"}, "tags": {"type": "keyword"},
    "n": {"type": "integer"}, "big": {"type": "long"},
    "f": {"type": "float"}, "d": {"type": "date"},
    "dn": {"type": "date_nanos"}, "ip": {"type": "ip"},
    "b": {"type": "boolean"}, "t": {"type": "text"}}}
MODES = {"device": {"search.aggs.device_enabled": "true",
                    "search.aggs.cost_router": "false"},
         "host": {"search.aggs.device_enabled": "false"}}


def _doc(rng, i: int, shift: int) -> dict:
    doc = {"t": " ".join(rng.choice(["alpha", "beta", "gamma", "delta"],
                                    size=int(rng.integers(1, 4))))}
    if rng.random() > 0.1:
        doc["tag"] = TAGS[int(rng.integers(len(TAGS) - shift))]
    if rng.random() > 0.5:
        doc["tags"] = [TAGS[int(j)] for j in rng.integers(0, 5, 2)]
    if rng.random() > 0.1:
        doc["n"] = int(rng.integers(0, 60)) + 3 * shift
    if rng.random() > 0.2:
        doc["big"] = int(rng.integers(-10 ** 9, 10 ** 9))
    if rng.random() > 0.1:
        doc["f"] = round(float(rng.random() * 10), 3)
    if rng.random() > 0.1:
        doc["d"] = T0 + int(rng.integers(0, 120 * DAY)) + shift * 40 * DAY
    if rng.random() > 0.3:
        doc["dn"] = f"2020-0{1 + int(rng.integers(0, 3))}-1" \
            f"{int(rng.integers(0, 9))}T0{int(rng.integers(0, 9))}:00:00Z"
    if rng.random() > 0.1:
        doc["ip"] = f"10.{shift}.{int(rng.integers(4))}." \
            f"{int(rng.integers(256))}"
    if rng.random() > 0.1:
        doc["b"] = bool(rng.random() > 0.4)
    return doc


def _load(pair, name: str, shards: int, seed: int, n: int,
          shift: int = 0) -> None:
    """n documents in two refreshed batches, then deletes and updates."""
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", {"settings": {"number_of_shards": shards},
                                  "mappings": MAPPING})
    for lo, hi in ((0, n // 2), (n // 2, n)):
        ops = []
        for i in range(lo, hi):
            ops += [{"index": {"_id": str(i)}}, _doc(rng, i, shift)]
        pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        pair.same("POST", f"/{name}/_refresh")
    ops = []
    for i in range(0, n, 17):
        ops += [{"delete": {"_id": str(i)}}]
    for i in range(5, n, 23):
        ops += [{"index": {"_id": str(i)}}, _doc(rng, i, shift)]
    pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")


class _Patch:
    def __init__(self):
        self.mp = pytest.MonkeyPatch()

    def setattr(self, *a):
        self.mp.setattr(*a)


@pytest.fixture(scope="module", params=sorted(MODES))
def world(request, tmp_path_factory):
    patch = _Patch()
    pair = Pair(tmp_path_factory.mktemp("aggs"), patch,
                settings=dict(MODES[request.param]))
    pair.ref_node.settings["search.aggs.device_enabled"] = "false"
    _load(pair, "ag", 1, 1, 300)
    _load(pair, "ag3", 3, 2, 300)
    _load(pair, "agx", 1, 3, 200, shift=1)
    pair.mode = request.param
    yield pair
    pair.close()
    patch.mp.undo()


def same_aggs(pair, path, body, query=None):
    want, got = pair.same("POST", path, body, query=query)
    assert want.get("aggregations") == got.get("aggregations"), \
        (path, body, want.get("aggregations"), got.get("aggregations"))
    return want, got


def _a(**aggs):
    return {"size": 0, "aggs": aggs, "request_cache": False}


METRICS = {"s": {"stats": {"field": "n"}}, "a": {"avg": {"field": "n"}},
           "mn": {"min": {"field": "f"}}, "mx": {"max": {"field": "f"}},
           "vc": {"value_count": {"field": "n"}}, "su": {"sum": {"field": "n"}},
           "sb": {"sum": {"field": "big"}}}
BODIES = {
    "terms_metrics": _a(t={"terms": {"field": "tag"}, "aggs": METRICS}),
    "terms_size_shard_size": _a(t={"terms": {"field": "tag", "size": 2,
                                             "shard_size": 3}}),
    "terms_numeric_key_desc": _a(t={"terms": {"field": "n", "size": 7,
                                              "order": {"_key": "desc"}},
                                    "aggs": {"a": {"avg": {"field": "big"}}}}),
    "terms_count_asc": _a(t={"terms": {"field": "tag",
                                       "order": {"_count": "asc"}}}),
    "terms_min_doc_count_0": {
        "size": 0, "query": {"term": {"tag": "red"}}, "request_cache": False,
        "aggs": {"t": {"terms": {"field": "tag", "min_doc_count": 0}},
                 "n": {"terms": {"field": "n", "min_doc_count": 0,
                                 "size": 100}}}},
    "terms_missing": _a(t={"terms": {"field": "tag", "missing": "zz"},
                           "aggs": {"m": {"max": {"field": "n"}}}},
                        u={"terms": {"field": "n", "missing": 7},
                           "aggs": {"m": {"min": {"field": "big"}}}}),
    "terms_types": _a(b={"terms": {"field": "b"}}, d={"terms": {
        "field": "d", "size": 3}}, ip={"terms": {"field": "ip", "size": 4}},
        idx={"terms": {"field": "_index"}}),
    "terms_multi_valued": _a(t={"terms": {"field": "tags"},
                                "aggs": {"c": {"value_count": {
                                    "field": "tags"}}}}),
    "terms_include_exclude": _a(
        i={"terms": {"field": "tag", "include": ["red", "blue", "zz"]}},
        e={"terms": {"field": "tag", "exclude": "c.*"}},
        p={"terms": {"field": "n", "size": 50,
                     "include": {"partition": 1, "num_partitions": 3}}}),
    "terms_order_by_metric": _a(t={"terms": {"field": "tag",
                                             "order": {"a": "desc"}},
                                   "aggs": {"a": {"avg": {"field": "f"}}}}),
    "histogram": _a(h={"histogram": {"field": "n", "interval": 5,
                                     "offset": 2},
                       "aggs": {"s": {"stats": {"field": "big"}}}},
                    h1={"histogram": {"field": "n", "interval": 10,
                                      "min_doc_count": 1,
                                      "format": "##0.0"}}),
    "histogram_bounds_missing": _a(
        h={"histogram": {"field": "n", "interval": 7, "missing": 100,
                         "extended_bounds": {"min": -20, "max": 130}},
           "aggs": {"c": {"value_count": {"field": "n"}}}}),
    "histogram_float": _a(h={"histogram": {"field": "f", "interval": 2.5},
                             "aggs": {"a": {"avg": {"field": "f"}}}}),
    "date_histogram_fixed": _a(
        d={"date_histogram": {"field": "d", "fixed_interval": "1d"},
           "aggs": {"s": {"sum": {"field": "n"}}}},
        o={"date_histogram": {"field": "d", "fixed_interval": "12h",
                              "offset": "+6h", "format": "yyyy-MM-dd",
                              "min_doc_count": 1}}),
    "date_histogram_calendar": _a(
        m={"date_histogram": {"field": "d", "calendar_interval": "month"},
           "aggs": {"mx": {"max": {"field": "n"}}}},
        w={"date_histogram": {"field": "d", "calendar_interval": "week",
                              "time_zone": "America/New_York"}},
        q={"date_histogram": {"field": "d", "calendar_interval": "1q",
                              "time_zone": "+05:30",
                              "format": "yyyy-MM-dd"}},
        y={"date_histogram": {"field": "d", "calendar_interval": "day",
                              "offset": "-3h", "min_doc_count": 2}}),
    "date_nanos": _a(d={"date_histogram": {"field": "dn",
                                           "fixed_interval": "1d"}},
                     c={"date_histogram": {"field": "dn",
                                           "calendar_interval": "month"}},
                     a={"avg": {"field": "dn"}}),
    "ranges": _a(
        r={"range": {"field": "n", "ranges": [
            {"to": 10}, {"from": 5, "to": 30, "key": "mid"}, {"from": 30}]},
           "aggs": {"a": {"avg": {"field": "n"}}, "m": {"min": {"field": "f"}}}},
        rf={"range": {"field": "f", "ranges": [{"to": 2.5}, {"from": 2.5}]}},
        dr={"date_range": {"field": "d", "ranges": [
            {"to": "2020-02-01"}, {"from": "2020-02-01", "to": "2020-04-15||+1d"}]}},
        ir={"ip_range": {"field": "ip", "ranges": [
            {"to": "10.0.2.0"}, {"from": "10.0.2.0"},
            {"mask": "10.0.1.0/24"}]}}),
    "single_buckets": _a(
        fl={"filter": {"term": {"tag": "red"}},
            "aggs": {"t": {"terms": {"field": "b"}}}},
        fs={"filters": {"filters": {"r": {"term": {"tag": "red"}},
                                    "big": {"range": {"n": {"gte": 30}}}}},
            "aggs": {"a": {"avg": {"field": "n"}}}},
        fa={"filters": {"filters": [{"match": {"t": "alpha"}},
                                    {"term": {"b": True}}]}},
        mi={"missing": {"field": "tag"},
            "aggs": {"s": {"stats": {"field": "n"}}}},
        g={"global": {}, "aggs": {"mx": {"max": {"field": "n"}}}}),
    "cardinality": _a(c={"cardinality": {"field": "tag"}},
                      cn={"cardinality": {"field": "n"}},
                      ci={"cardinality": {"field": "ip"}},
                      cm={"cardinality": {"field": "tag", "missing": "zz"}},
                      vk={"value_count": {"field": "tag"}}),
    "percentiles_extended": _a(
        p={"percentiles": {"field": "f"}},
        pk={"percentiles": {"field": "n", "percents": [10, 50, 99.9],
                            "keyed": False}},
        e={"extended_stats": {"field": "n", "sigma": 3}},
        ef={"extended_stats": {"field": "f"}}),
    "three_deep": _a(d={"date_histogram": {"field": "d",
                                           "calendar_interval": "month"},
                        "aggs": {"t": {"terms": {"field": "tag"},
                                       "aggs": {"h": {"histogram": {
                                           "field": "n", "interval": 20},
                                           "aggs": {"s": {"stats": {
                                               "field": "n"}},
                                               "c": {"cardinality": {
                                                   "field": "ip"}}}},
                                           "c": {"cardinality": {
                                               "field": "b"}}}},
                                 "a": {"avg": {"field": "big"}}}}),
    "four_deep": _a(t={"terms": {"field": "b"}, "aggs": {"u": {
        "terms": {"field": "tag"}, "aggs": {"h": {"histogram": {
            "field": "n", "interval": 30}, "aggs": {"w": {
                "date_histogram": {"field": "d",
                                   "calendar_interval": "month"}}}}}}}}),
    "tree_missing_and_meta": _a(
        h={"histogram": {"field": "n", "interval": 15}, "meta": {"x": 1},
           "aggs": {"t": {"terms": {"field": "tag", "missing": "none"},
                          "meta": {"y": 2},
                          "aggs": {"m": {"max": {"field": "big"},
                                         "meta": {"z": 3}}}}}}),
    "avg_date_meta": _a(a={"avg": {"field": "d"}, "meta": {"k": "v"}},
                        s={"stats": {"field": "d"}}),
    "post_filter_scope": {
        "size": 5, "query": {"match": {"t": "alpha"}},
        "post_filter": {"term": {"tag": "red"}}, "request_cache": False,
        "aggs": {"t": {"terms": {"field": "tag"}},
                 "h": {"histogram": {"field": "n", "interval": 10}}}},
    "no_match": {"size": 0, "query": {"term": {"tag": "nope"}},
                 "request_cache": False,
                 "aggs": {"t": {"terms": {"field": "tag"}},
                          "h": {"histogram": {"field": "n", "interval": 10,
                                              "min_doc_count": 0}},
                          "s": {"stats": {"field": "n"}},
                          "c": {"cardinality": {"field": "ip"}},
                          "p": {"percentiles": {"field": "f"}}}},
    "aggregations_key": {"size": 0, "request_cache": False,
                         "aggregations": {"t": {"terms": {"field": "b"}}}},
}
# bodies with at least one node the device rung serves
DEVICE_BODIES = {
    "terms_metrics", "terms_size_shard_size", "terms_numeric_key_desc",
    "terms_count_asc", "terms_min_doc_count_0", "terms_missing",
    "terms_types", "histogram", "histogram_bounds_missing",
    "date_histogram_fixed", "date_histogram_calendar", "date_nanos",
    "ranges", "cardinality", "three_deep", "tree_missing_and_meta",
    "avg_date_meta", "post_filter_scope", "no_match", "aggregations_key"}
TARGETS = ["ag", "ag3", "ag,agx"]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("case", sorted(BODIES))
def test_aggs_parity(world, case, target):
    """Each body over one index, three shards and two indices equals the
    reference; in device mode a body with an eligible node ran on the
    device rung."""
    before = world.port_node.aggs_stats()["device_nodes"]
    same_aggs(world, f"/{target}/_search", BODIES[case])
    ran = world.port_node.aggs_stats()["device_nodes"] - before
    if world.mode == "host":
        assert ran == 0
    elif case in DEVICE_BODIES:
        assert ran > 0, case


def test_sum_on_non_integral_column_takes_host(world):
    """A sum-bearing metric over a float column leaves the device with the
    reason `non_integral_sum`; an integral one stays."""
    stats = world.port_node.aggs_stats
    if world.mode == "host":
        # the device rung is off: no engine, the host path answers
        same_aggs(world, "/ag/_search", _a(s={"sum": {"field": "f"}}))
        assert stats()["searches"] == stats()["device_nodes"] == 0
        return

    def reasons():
        return stats()["fallback_reasons"].get("non_integral_sum",
                                               {}).get("count", 0)
    r0, d0 = reasons(), stats()["device_nodes"]
    same_aggs(world, "/ag/_search", _a(s={"sum": {"field": "f"}}))
    assert reasons() == r0 + 1 and stats()["device_nodes"] == d0
    same_aggs(world, "/ag/_search", _a(s={"sum": {"field": "n"}},
                                       m={"max": {"field": "f"}}))
    assert reasons() == r0 + 1 and stats()["device_nodes"] == d0 + 2


def test_typed_keys_and_msearch(world):
    body = _a(t={"terms": {"field": "tag"}, "aggs": {
        "n": {"terms": {"field": "n", "size": 3}},
        "p": {"percentiles": {"field": "f", "percents": [50]}}}},
        f={"filters": {"filters": {"x": {"term": {"b": True}}}},
           "aggs": {"a": {"avg": {"field": "n"}}}},
        i={"terms": {"field": "ip", "size": 2}},
        u={"terms": {"field": "unmapped", "size": 2}})
    for target in TARGETS:
        want, got = same_aggs(world, f"/{target}/_search", body,
                              query={"typed_keys": "true"})
        assert "sterms#t" in got["aggregations"]
    lines = [{"index": "ag"}, body, {"index": "ag,agx"}, BODIES["ranges"],
             {"index": "ag3"}, _a(x={"rare_terms": {"field": "tag"}})]
    for query in (None, {"typed_keys": "true"}):
        _, want = world.ref("POST", "/_msearch", lines, ndjson=True,
                            query=query)
        _, got = world.port("POST", "/_msearch", lines, ndjson=True,
                            query=query)
        for w, g in zip(want["responses"], got["responses"]):
            world.match(w, g, "msearch")
            assert w["aggregations"] == g["aggregations"]
        # rare_terms, once left out, answers as the reference
        key = "rare_terms#x" if query else "x"
        assert key in got["responses"][2]["aggregations"]


# the kinds once left out, each with a body that answers: alone, and
# under a terms bucket (a composite there is the reference's 400)
FORMERLY_LEFT_OUT = {
    "adjacency_matrix": {"filters": {"r": {"term": {"tag": "red"}},
                                     "n": {"range": {"n": {"gte": 20}}}}},
    "auto_date_histogram": {"field": "d", "buckets": 6},
    "avg_bucket": {"buckets_path": "h>_count"},
    "boxplot": {"field": "n"},
    "bucket_script": {"buckets_path": {"c": "_count"},
                      "script": "params.c * 2"},
    "bucket_selector": {"buckets_path": {"c": "_count"},
                        "script": "params.c > 5"},
    "bucket_sort": {"sort": [{"_count": "desc"}], "size": 3},
    "composite": {"sources": [{"t": {"terms": {"field": "tag"}}}]},
    "cumulative_sum": {"buckets_path": "_count"},
    "derivative": {"buckets_path": "_count"},
    "extended_stats_bucket": {"buckets_path": "h>_count"},
    "geo_bounds": {"field": "n"},
    "geo_centroid": {"field": "n"},
    "geohash_grid": {"field": "n"},
    "geotile_grid": {"field": "n"},
    "matrix_stats": {"fields": ["n", "f"]},
    "max_bucket": {"buckets_path": "h>_count"},
    "median_absolute_deviation": {"field": "f"},
    "min_bucket": {"buckets_path": "h>_count"},
    "moving_fn": {"buckets_path": "_count", "window": 2,
                  "script": "MovingFunctions.unweightedAvg(values)"},
    "percentile_ranks": {"field": "n", "values": [10, 40]},
    "percentiles_bucket": {"buckets_path": "h>_count"},
    "rare_terms": {"field": "tag"},
    "sampler": {"shard_size": 50},
    "scripted_metric": {"init_script": "state.c = 0",
                        "map_script": "state.c += 1",
                        "combine_script": "return state.c"},
    "serial_diff": {"buckets_path": "_count"},
    "significant_terms": {"field": "tag", "min_doc_count": 1},
    "significant_text": {"field": "t", "min_doc_count": 1},
    "stats_bucket": {"buckets_path": "h>_count"},
    "string_stats": {"field": "tag"},
    "sum_bucket": {"buckets_path": "h>_count"},
    "top_hits": {"size": 2, "sort": [{"n": "desc"}]},
    "top_metrics": {"metrics": {"field": "f"}, "sort": {"n": "desc"}},
    "weighted_avg": {"value": {"field": "n"}, "weight": {"field": "f"}},
}
# a parent pipeline reads its parent's buckets; a sibling one reads "h"
_PARENT_PIPELINES = {"bucket_script", "bucket_selector", "bucket_sort",
                     "cumulative_sum", "derivative", "moving_fn",
                     "serial_diff"}


def _left_out_body(kind: str, under_bucket: bool) -> dict:
    spec = {kind: FORMERLY_LEFT_OUT[kind]}
    hist = {"histogram": {"field": "n", "interval": 10}}
    if kind in _PARENT_PIPELINES:
        x = {"x": {**hist, "aggs": {"p": spec}}}
    elif kind.endswith("_bucket"):
        x = {"h": hist, "x": spec}
    else:
        x = {"x": spec}
    if under_bucket:
        x = {"t": {"terms": {"field": "tag"}, "aggs": x}}
    return _a(**x)


@pytest.mark.parametrize("kind", sorted(FORMERLY_LEFT_OUT) + [
    "nested", "reverse_nested"])
def test_left_out_kind_is_a_400_naming_it(world, kind):
    """Each kind once left out answers as the reference, alone and under a
    bucket, over one index and over two; `nested` and `reverse_nested`,
    left out before them, too."""
    if kind in FORMERLY_LEFT_OUT:
        for target in ("ag", "ag,agx"):
            same_aggs(world, f"/{target}/_search",
                      _left_out_body(kind, False))
            same_aggs(world, f"/{target}/_search",
                      _left_out_body(kind, True))
        return
    body = _a(x={kind: {"field": "n"}})
    world.same("POST", "/ag/_search", body)
    world.same("POST", "/ag/_search", _a(
        t={"terms": {"field": "tag"}, "aggs": {"x": {kind: {}}}}))


@pytest.mark.parametrize("body", [
    _a(s={"sum": {"field": "n", "script": "doc['n'].value"}}),
    _a(p={"percentiles": {"field": "n", "hdr": {}}}),
], ids=["script", "hdr"])
def test_left_out_options_are_400s(world, body):
    """`script` and HDR percentiles, once left out, answer as the
    reference on a one-shard index and over two; HDR over a negative value
    on an index of several shards is the one 400 left, naming ROADMAP.md
    queue 1 item 12."""
    for target in ("ag", "ag,agx"):
        same_aggs(world, f"/{target}/_search", body)
    status, got = world.port("POST", "/ag3/_search", _a(
        p={"percentiles": {"field": "big", "hdr": {}}}))
    assert status == 400 and "is not supported by this build" \
        in got["error"]["reason"]
    assert "ROADMAP.md queue 1 item 12" in got["error"]["reason"]


@pytest.mark.parametrize("body", [
    _a(p={"percentiles": {"field": "f", "percents": []}}),
    _a(p={"percentiles": {"field": "f", "percents": [120]}}),
    _a(e={"extended_stats": {"field": "n", "sigma": -1}}),
    _a(c={"cardinality": {"field": "n", "precision_threshold": -5}}),
    _a(f={"filters": {"filters": {}}}),
    _a(x={"no_such_kind": {"field": "n"}}),
    _a(x={"avg": {"field": "n"}, "max": {"field": "n"}}),
    _a(h={"histogram": {"field": "n", "interval": 0.0001}}),
    _a(t={"terms": {"field": "n", "include": "1.*"}}),
    _a(s={"sum": {"field": "tag"}}),
    _a(d={"date_histogram": {"field": "d", "calendar_interval": "2d"}}),
    _a(t={"terms": {"field": "n", "missing": "abc"}}),
], ids=["empty_percents", "percent_range", "sigma", "precision",
        "empty_filters", "unknown_kind", "two_kinds", "span", "regex_num",
        "sum_keyword", "bad_calendar", "bad_missing"])
def test_agg_errors(world, body):
    want, got = world.same("POST", "/ag/_search", body)
    assert got["status"] in (400, 503), got
    # over two indices the histogram span is only filled up to a guard
    same_aggs(world, "/ag,agx/_search", body)


def test_max_buckets(world):
    """`search.max_buckets` bounds each bucket list: a 503 in both."""
    world.ref_node.cluster_settings.setdefault("persistent", {})[
        "search.max_buckets"] = 3
    world.port_node.settings["search.max_buckets"] = 3
    try:
        for body in (_a(t={"terms": {"field": "tag"}}),
                     _a(h={"histogram": {"field": "n", "interval": 10}}),
                     _a(d={"date_histogram": {"field": "d",
                                              "calendar_interval": "month"}}),
                     _a(t={"terms": {"field": "b"}, "aggs": {
                         "u": {"terms": {"field": "tag"}}}})):
            for target in ("ag", "ag,agx"):
                want, got = world.same("POST", f"/{target}/_search", body)
                assert got["status"] == 503, got
                assert got["error"]["type"] == "too_many_buckets_exception"
        same_aggs(world, "/ag/_search", _a(t={"terms": {"field": "b"}}))
    finally:
        world.ref_node.cluster_settings["persistent"].pop(
            "search.max_buckets")
        world.port_node.settings.pop("search.max_buckets")


def test_request_cache_keys_final_and_partial(world):
    """A `size: 0` aggs body caches in the host rung: a repeat hits and
    runs no device node; the same body over two indices (partial states)
    keys apart from the one-index (final) entry."""
    body = {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}, "aggs": {
        "a": {"avg": {"field": "n"}}}}, "c": {"cardinality": {
            "field": "ip"}}}}
    stats = world.port_node.aggs_stats
    same_aggs(world, "/ag/_search", body)
    d0, h0 = stats()["device_nodes"], stats()["host_nodes"]
    hits0 = world.port_node.caches.request.stats()["hit_count"]
    for target in ("ag", "ag,agx", "ag"):
        same_aggs(world, f"/{target}/_search", body)
    st = world.port_node.caches.request.stats()
    assert st["hit_count"] == hits0 + 2
    if world.mode == "device":
        # the two-index search ran agx's nodes and ag's partial ones
        assert stats()["device_nodes"] == d0 + 4
    assert stats()["host_nodes"] == h0


def test_hybrid_rrf_body_with_aggs(world):
    """The reference's hybrid paths ignore `aggs`: no `aggregations` key,
    through the fused path (one index) and the general one."""
    pair = world
    pair.same("PUT", "/hy", {"mappings": {"properties": {
        "v": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
        "t": {"type": "text"}, "n": {"type": "integer"}}}})
    rng = np.random.default_rng(9)
    ops = []
    for i in range(40):
        ops += [{"index": {"_id": str(i)}},
                {"v": np.round(rng.standard_normal(4), 3).tolist(),
                 "t": ["alpha", "beta gamma"][i % 2], "n": i}]
    pair.same("POST", "/hy/_bulk", ops, ndjson=True)
    pair.same("POST", "/hy/_refresh")
    body = {"query": {"match": {"t": "alpha"}},
            "knn": {"field": "v", "query_vector": [0.1, 0.2, 0.3, 0.4],
                    "k": 5, "num_candidates": 20},
            "rank": {"rrf": {}}, "size": 5,
            "aggs": {"t": {"terms": {"field": "n"}}}}
    for extra in ({}, {"highlight": {"fields": {"t": {}}}}):
        s1, want = pair.ref("POST", "/hy/_search", dict(body, **extra))
        s2, got = pair.port("POST", "/hy/_search",
                            dict(body, request_cache=False, **extra))
        assert s1 == s2 == 200
        # the fused responses differ in `_shards` only (the port's has it)
        pair.match(want["hits"], got["hits"], "hybrid")
        assert "aggregations" not in want and "aggregations" not in got
    pair.same("DELETE", "/hy")
