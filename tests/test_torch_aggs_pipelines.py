"""The pipeline aggregations through both REST layers on the CPU, request
for request (`tests/torch_rest_pair.py`), on the seeded world of
`test_torch_aggs_metrics.py` (a one-shard index, a two-shard index and
two indices, where the top-level pipelines run at the coordinator's
finalize): the sibling kinds (`avg_bucket`, `sum_bucket`, `max_bucket`,
`min_bucket`, `stats_bucket`, `extended_stats_bucket`,
`percentiles_bucket`) at the top level and under a bucket, the parent
kinds (`derivative`, `cumulative_sum`, `serial_diff`, `moving_fn`,
`bucket_script`, `bucket_selector`, `bucket_sort`) under histograms and
terms, chained, and their errors. In the port's `device` mode the
top-level pipelines read the device rung's outputs: the profile's
`aggregations` entries and `Node.aggs_stats()` show the routes the
reference's plan gives each node.

Aggregations compare with `==` on the decoded JSON, so no tolerance is
stated."""

import pytest

from tests.test_torch_aggs_metrics import (  # noqa: F401  (the fixture)
    TARGETS, a_, same_aggs, under_bucket, world,
)

DAILY = {"date_histogram": {"field": "d", "calendar_interval": "week"}}
HIST = {"histogram": {"field": "pos", "interval": 10}}
TERMS = {"terms": {"field": "tag"}}


def _with(parent: dict, subs: dict) -> dict:
    return {**parent, "aggs": subs}


SIBLING = {
    kind: {"h": _with(DAILY, {"a": {"avg": {"field": "n"}}}),
           "p": {kind: {"buckets_path": "h>a"}},
           "c": {kind: {"buckets_path": "h>_count"}}}
    for kind in ("avg_bucket", "sum_bucket", "max_bucket", "min_bucket",
                 "stats_bucket", "extended_stats_bucket",
                 "percentiles_bucket")}
SIBLING["percentiles_bucket_percents"] = {
    "t": _with(TERMS, {"s": {"stats": {"field": "pos"}}}),
    "p": {"percentiles_bucket": {"buckets_path": "t>s.avg",
                                 "percents": [10, 50, 90]}}}
SIBLING["extended_stats_bucket_sigma"] = {
    "h": _with(HIST, {"m": {"max": {"field": "f"}}}),
    "p": {"extended_stats_bucket": {"buckets_path": "h>m", "sigma": 1.5}}}
SIBLING["chained"] = {
    "h": _with(HIST, {"s": {"sum": {"field": "n"}}}),
    "mx": {"max_bucket": {"buckets_path": "h>s"}},
    "mn": {"min_bucket": {"buckets_path": "h>s"}},
    "fl": {"filters": {"filters": {"r": {"term": {"tag": "red"}},
                                   "g": {"term": {"tag": "green"}}}},
           "aggs": {"a": {"avg": {"field": "pos"}}}},
    "fa": {"avg_bucket": {"buckets_path": "fl>a"}}}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("case", sorted(SIBLING))
def test_sibling_pipelines(world, case, target):
    """Each sibling kind over a histogram's metric and its counts, at the
    top level and under a terms bucket."""
    same_aggs(world, f"/{target}/_search", a_(**SIBLING[case]))
    same_aggs(world, f"/{target}/_search", a_(**under_bucket(SIBLING[case])))


PARENT = {
    "derivative": {"dv": {"derivative": {"buckets_path": "a"}},
                   "dc": {"derivative": {"buckets_path": "_count"}}},
    "cumulative_sum": {"cs": {"cumulative_sum": {"buckets_path": "a"}}},
    "serial_diff": {"sd": {"serial_diff": {"buckets_path": "a", "lag": 2}}},
    "moving_fn": {"mf": {"moving_fn": {
        "buckets_path": "a", "window": 3,
        "script": "MovingFunctions.unweightedAvg(values)"}}},
    "bucket_script": {"bs": {"bucket_script": {
        "buckets_path": {"v": "a", "c": "_count"},
        "script": "params.v * params.c - 1"}}},
    "bucket_selector": {"sel": {"bucket_selector": {
        "buckets_path": {"c": "_count"}, "script": "params.c > 3"}}},
    "bucket_sort": {"bs": {"bucket_sort": {"sort": [{"a": "desc"}],
                                           "size": 4, "from": 1}}},
    "bucket_sort_count": {"bs": {"bucket_sort": {
        "sort": [{"_count": {"order": "asc"}}, {"a": "desc"}]}}},
    "chained": {"cs": {"cumulative_sum": {"buckets_path": "a"}},
                "dv": {"derivative": {"buckets_path": "cs"}},
                "sel": {"bucket_selector": {"buckets_path": {"v": "a"},
                                            "script": "params.v > 20"}}},
}
PARENTS = {"histogram": HIST, "date_histogram": DAILY, "terms": TERMS}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("parent", sorted(PARENTS))
@pytest.mark.parametrize("case", sorted(PARENT))
def test_parent_pipelines(world, case, parent, target):
    """Each parent kind under a histogram, a date histogram and a terms
    bucket, and the same two levels down (under a terms bucket)."""
    subs = {"a": {"avg": {"field": "n"}}, **PARENT[case]}
    body = {"p": _with(PARENTS[parent], subs)}
    same_aggs(world, f"/{target}/_search", a_(**body))
    same_aggs(world, f"/{target}/_search", a_(**under_bucket(body)))


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("pipes", [
    {"cs": {"cumulative_sum": {"buckets_path": "_count"}},
     "dv": {"derivative": {"buckets_path": "a"}}},
    {"bs": {"bucket_sort": {"sort": [{"_count": "desc"}], "size": 2}},
     "sel": {"bucket_selector": {"buckets_path": {"c": "_count"},
                                 "script": "params.c > 1"}}},
], ids=["cumulative_derivative", "sort_select"])
def test_pipelines_under_nested(world, pipes, target):
    """Parent pipelines over a histogram of a nested field, and a sibling
    pipeline beside it inside the `nested` aggregation (whose path the
    reference reads through the nested bucket: its 400)."""
    hist = _with({"histogram": {"field": "c.st", "interval": 1}},
                 {"a": {"avg": {"field": "pos"}}, **pipes})
    same_aggs(world, f"/{target}/_search", a_(
        n={"nested": {"path": "c"}, "aggs": {"h": hist}}))
    world.same("POST", f"/{target}/_search", a_(
        n={"nested": {"path": "c"}, "aggs": {
            "h": hist, "m": {"max_bucket": {"buckets_path": "h>_count"}}}}))


def test_sibling_under_a_bucket_lands_in_its_results(world):
    """A sibling kind declared under a bucket runs over that bucket's own
    list (the reference keeps its answer in `__pipeline_results__`)."""
    body = a_(h=_with(HIST, {"a": {"avg": {"field": "n"}},
                             "m": {"max_bucket": {"buckets_path": "a"}}}))
    for target in TARGETS:
        want, got = same_aggs(world, f"/{target}/_search", body)
        assert "__pipeline_results__" in got["aggregations"]["h"]


@pytest.mark.parametrize("body", [
    a_(p={"avg_bucket": {"buckets_path": "nope>a"}}),
    a_(h=_with(HIST, {"a": {"avg": {"field": "n"}}}),
       p={"avg_bucket": {"buckets_path": "h>t"}}),
    a_(h=_with(TERMS, {"t": TERMS}), p={"avg_bucket": {
        "buckets_path": "h>t"}}),
    a_(h=_with(TERMS, {"t": _with(TERMS, {"a": {"avg": {"field": "n"}}})}),
       p={"avg_bucket": {"buckets_path": "h>t>a"}}),
    a_(h=_with(TERMS, {"p": {"percentiles": {"field": "n"}}}),
       x={"max_bucket": {"buckets_path": "h>p"}}),
    a_(m={"max": {"field": "n"}}, p={"sum_bucket": {"buckets_path": "m"}}),
    a_(h=_with(HIST, {"mf": {"moving_fn": {"buckets_path": "_count",
                                           "window": 0}}})),
    a_(h=_with(HIST, {"mf": {"moving_fn": {"buckets_path": "_count",
                                           "window": "x"}}})),
    a_(h=_with(HIST, {"bs": {"bucket_script": {
        "buckets_path": {"c": "_count"}, "script": "params.z + 1"}}})),
], ids=["unknown_agg", "unknown_metric", "multi_bucket_end",
        "multi_bucket_mid", "multi_value", "no_buckets", "window_zero",
        "window_type", "unknown_variable"])
def test_pipeline_errors(world, body):
    for target in ("k1", "k1,kx"):
        want, got = world.same("POST", f"/{target}/_search", body)
        assert got.get("status", 200) >= 400 \
            or got["aggregations"]["h"]["buckets"], got


def test_top_level_pipelines_read_device_outputs(world):
    """A top-level pipeline over a histogram the device rung serves: the
    histogram node ran on the device (one device node, no host node), the
    pipeline over its output."""
    stats = world.port_node.aggs_stats
    body = a_(h=_with({"date_histogram": {"field": "d",
                                          "fixed_interval": "1d"}},
                      {"s": {"sum": {"field": "pos"}}}),
              ab={"avg_bucket": {"buckets_path": "h>s"}},
              mb={"max_bucket": {"buckets_path": "h>_count"}},
              pb={"percentiles_bucket": {"buckets_path": "h>s"}},
              bs={"bucket_sort": {"buckets_path": {},
                                  "sort": [{"s": "desc"}], "size": 10}})
    for target in TARGETS:
        before = stats()
        same_aggs(world, f"/{target}/_search", body)
        after = stats()
        if world.mode == "device":
            n_idx = len(target.split(","))
            assert after["device_nodes"] - before["device_nodes"] == n_idx
            assert after["host_nodes"] == before["host_nodes"]
        else:
            assert after["device_nodes"] == before["device_nodes"]


@pytest.mark.parametrize("body", [
    a_(h=_with(HIST, {"s": {"sum": {"field": "pos"}}}),
       ab={"avg_bucket": {"buckets_path": "h>s"}},
       t={"terms": {"field": "tag"}}),
    a_(h=_with(HIST, {"s": {"sum": {"field": "pos"}},
                      "cs": {"cumulative_sum": {"buckets_path": "s"}}}),
       m={"max": {"field": "n"}},
       sb={"stats_bucket": {"buckets_path": "h>_count"}}),
    a_(c={"composite": {"sources": [{"t": {"terms": {"field": "tag"}}}]}},
       r={"rare_terms": {"field": "tag"}},
       g={"geo_bounds": {"field": "g"}},
       a={"avg": {"field": "n"}},
       w={"weighted_avg": {"value": {"field": "n"},
                           "weight": {"field": "w"}}}),
], ids=["sibling", "parent_sub", "new_kinds"])
def test_profile_routes_match_reference(world, body):
    """The profile's aggregation entries name the route the reference's
    plan (`elasticsearch_tpu.search.agg_plan.compile_plan`) gives each
    node: `device`, or `host` with its reason (`unsupported_sub_agg` for a
    bucket with a pipeline sub-aggregation, `unsupported_agg` for a new
    kind); a pipeline entry names no engine; the answer is the
    reference's."""
    from elasticsearch_tpu.search.agg_plan import compile_plan
    spec = body["aggs"]
    plan = compile_plan(spec, world.ref_node.indices.get(
        "k1").mapper_service)
    want = {}
    for name, node in plan.nodes.items():
        if node.host_reason == "pipeline":
            want[name] = (None, None)
        elif node.mode != "host" and world.mode == "device":
            want[name] = ("device", None)
        elif world.mode == "device":
            want[name] = ("host", node.host_reason)
    prof = dict(body, profile=True)
    s1, ref = world.ref("POST", "/k1/_search", prof)
    s2, got = world.port("POST", "/k1/_search", prof)
    assert s1 == s2 == 200, got
    assert ref["aggregations"] == got["aggregations"]
    entries = got["profile"]["shards"][0]["aggregations"]
    routes = {e["description"]: (e.get("engine"), e.get("fallback_reason"))
              for e in entries}
    if world.mode == "device":
        assert routes == want, (routes, want)
    else:
        assert all(r == (None, None) for r in routes.values()), routes


