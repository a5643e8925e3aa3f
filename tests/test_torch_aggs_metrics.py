"""The metric aggregations through both REST layers on the CPU, request for
request (`tests/torch_rest_pair.py`): `weighted_avg`, `percentile_ranks`,
`median_absolute_deviation`, `boxplot`, HDR `percentiles`, a `script` in
place of a field, `string_stats`, `top_metrics`, `matrix_stats`,
`scripted_metric`, `top_hits`, `geo_bounds` and `geo_centroid`, each alone
and under a bucket, over a one-shard index, a two-shard index and two
indices (partial states, merged and finalized), some under `nested`; the
reference runs its host path, the port its device rung on CPU tensors with
the router off (`device`) or its host path (`host`). HDR over a negative
value: the reference's shard failure on a one-shard index, and the 400
that names ROADMAP.md queue 1 item 12 on an index of several shards.

Aggregations compare with `==` on the decoded JSON: the port runs the
reference's arithmetic in the same order (final mode's exact quantiles,
partial mode's t-digest on the same merge order), so no tolerance is
stated.

The seeded world (`world`, `load_world`) is shared with
`test_torch_aggs_buckets.py` and `test_torch_aggs_pipelines.py`."""

import random

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

DAY = 86_400_000
T0 = 1_577_836_800_000          # 2020-01-01T00:00:00Z
TAGS = ["red", "green", "blue", "cyan", "teal"]
MAPPING = {"properties": {
    "tag": {"type": "keyword"}, "tags": {"type": "keyword"},
    "n": {"type": "integer"}, "pos": {"type": "integer"},
    "m": {"type": "integer"}, "neg": {"type": "integer"},
    "w": {"type": "integer"}, "f": {"type": "float"},
    "d": {"type": "date"}, "ip": {"type": "ip"}, "b": {"type": "boolean"},
    "t": {"type": "text"}, "s": {"type": "keyword"},
    "g": {"type": "geo_point"},
    "c": {"type": "nested", "properties": {"a": {"type": "keyword"},
                                           "st": {"type": "integer"}}}}}
MODES = {"device": {"search.aggs.device_enabled": "true",
                    "search.aggs.cost_router": "false"},
         "host": {"search.aggs.device_enabled": "false"}}
# one shard, two shards, and two indices (partial states)
TARGETS = ["k1", "k2", "k1,kx"]
WORDS = ["alpha", "beta", "gamma", "delta", "omega", "sigma"]


def _doc(rng, shift: int) -> dict:
    doc = {"pos": int(rng.integers(0, 100)),
           "t": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 8)))),
           "neg": int(rng.integers(-3, 20)),
           "m": int(rng.integers(0, 50)) - 5 * shift}
    if rng.random() > 0.1:
        doc["tag"] = TAGS[int(rng.integers(len(TAGS) - shift))]
    if rng.random() > 0.5:
        doc["tags"] = [TAGS[int(j)] for j in rng.integers(0, 5, 2)]
    if rng.random() > 0.1:
        doc["n"] = int(rng.integers(0, 60)) + 3 * shift
    if rng.random() > 0.1:
        doc["f"] = round(float(rng.random() * 10), 3)
    if rng.random() > 0.2:
        doc["w"] = int(rng.integers(1, 6))
    if rng.random() > 0.1:
        doc["d"] = T0 + int(rng.integers(0, 120 * DAY)) + shift * 40 * DAY
    if rng.random() > 0.1:
        doc["ip"] = f"10.{shift}.{int(rng.integers(4))}." \
            f"{int(rng.integers(256))}"
    if rng.random() > 0.1:
        doc["b"] = bool(rng.random() > 0.4)
    if rng.random() > 0.2:
        doc["s"] = f"GET /{rng.choice(WORDS)}/{int(rng.integers(30))}.html"
    if rng.random() > 0.15:
        pts = [{"lat": round(float(rng.uniform(-60, 70)), 4),
                "lon": round(float(rng.uniform(-170, 170)), 4)}
               for _ in range(1 + int(rng.random() > 0.9))]
        doc["g"] = pts[0] if len(pts) == 1 else pts
    doc["c"] = [{"a": TAGS[int(rng.integers(3))],
                 "st": int(rng.integers(0, 6))}
                for _ in range(int(rng.integers(0, 3)))]
    return doc


def load_world(pair, name: str, shards: int, seed: int, n: int,
               shift: int = 0) -> None:
    """n documents in two refreshed batches, then deletes and updates."""
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", {"settings": {"number_of_shards": shards},
                                  "mappings": MAPPING})
    for lo, hi in ((0, n // 2), (n // 2, n)):
        ops = []
        for i in range(lo, hi):
            ops += [{"index": {"_id": str(i)}}, _doc(rng, shift)]
        pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        pair.same("POST", f"/{name}/_refresh")
    ops = [{"delete": {"_id": str(i)}} for i in range(0, n, 17)]
    for i in range(5, n, 23):
        ops += [{"index": {"_id": str(i)}}, _doc(rng, shift)]
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
    pair = Pair(tmp_path_factory.mktemp("aggk"), patch,
                settings=dict(MODES[request.param]))
    pair.ref_node.settings["search.aggs.device_enabled"] = "false"
    load_world(pair, "k1", 1, 21, 160)
    load_world(pair, "k2", 2, 22, 160)
    load_world(pair, "kx", 1, 23, 120, shift=1)
    pair.mode = request.param
    yield pair
    pair.close()
    patch.mp.undo()


def a_(**aggs) -> dict:
    return {"size": 0, "aggs": aggs, "request_cache": False}


def same_aggs(pair, path, body, query=None):
    want, got = pair.same("POST", path, body, query=query)
    assert want.get("aggregations") == got.get("aggregations"), \
        (path, body, want.get("aggregations"), got.get("aggregations"))
    return want, got


def under_bucket(aggs: dict) -> dict:
    """The same aggregations under a terms bucket."""
    return {"by_tag": {"terms": {"field": "tag"}, "aggs": aggs}}


METRICS = {
    "weighted_avg": {"x": {"weighted_avg": {
        "value": {"field": "f"}, "weight": {"field": "w", "missing": 2}}}},
    "percentile_ranks": {"x": {"percentile_ranks": {
        "field": "f", "values": [1, 5.5, 9]}},
        "y": {"percentile_ranks": {"field": "n", "values": [10, 30]}}},
    "median_absolute_deviation": {
        "x": {"median_absolute_deviation": {"field": "f"}},
        "y": {"median_absolute_deviation": {"field": "n",
                                            "compression": 500}}},
    "boxplot": {"x": {"boxplot": {"field": "n"}},
                "y": {"boxplot": {"field": "f"}}},
    "hdr": {"x": {"percentiles": {"field": "pos", "hdr": {
        "number_of_significant_value_digits": 2}}},
        "y": {"percentiles": {"field": "f", "hdr": {},
                              "percents": [10, 50, 90]}}},
    "script": {"x": {"avg": {"script": "doc['pos'].value * 2"}},
               "y": {"max": {"script": {"source": "doc['pos'].value + "
                                                  "params.k",
                                        "params": {"k": 3}}}},
               "z": {"stats": {"script": "doc['pos'].value / 4"}}},
    "string_stats": {"x": {"string_stats": {"field": "s"}},
                     "y": {"string_stats": {"field": "tags",
                                            "show_distribution": True}}},
    "top_metrics": {"x": {"top_metrics": {"metrics": {"field": "n"},
                                          "sort": {"d": "desc"}}},
                    "y": {"top_metrics": {"metrics": [{"field": "f"},
                                                      {"field": "tag"}],
                                          "sort": [{"pos": "asc"}],
                                          "size": 3}}},
    "matrix_stats": {"x": {"matrix_stats": {"fields": ["n", "f", "pos"]}}},
    "scripted_metric": {"x": {"scripted_metric": {
        "init_script": "state.t = 0",
        "map_script": "state.t += doc['pos'].value",
        "combine_script": "return state.t",
        "reduce_script": "double s = 0; for (t in states) { s += t } "
                         "return s"}},
        "y": {"scripted_metric": {
            "init_script": "state.c = 0",
            "map_script": "if (doc['pos'].value > params.lim) "
                          "{ state.c += 1 }",
            "combine_script": "return state.c",
            "params": {"lim": 50}}}},
    "top_hits": {"x": {"top_hits": {"size": 3, "sort": [{"n": "desc"}]}},
                 "y": {"top_hits": {"size": 2,
                                    "seq_no_primary_term": True}}},
    "geo_bounds": {"x": {"geo_bounds": {"field": "g"}}},
    "geo_centroid": {"x": {"geo_centroid": {"field": "g"}}},
}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_parity(world, case, target):
    """Each metric kind alone and under a terms bucket over one index, two
    shards and two indices equals the reference."""
    same_aggs(world, f"/{target}/_search", a_(**METRICS[case]))
    same_aggs(world, f"/{target}/_search",
              a_(**under_bucket(METRICS[case])))


NESTED = {
    "top_hits": {"h": {"top_hits": {"size": 3, "sort": [{"c.st": "desc"}]}}},
    "top_hits_asc": {"h": {"top_hits": {"size": 4, "sort": ["c.st"]}}},
    "string_stats": {"s": {"string_stats": {"field": "c.a"}}},
    "percentile_ranks": {"p": {"percentile_ranks": {"field": "c.st",
                                                    "values": [1, 3]}}},
    "boxplot": {"b": {"boxplot": {"field": "c.st"}}},
    "weighted_avg": {"w": {"weighted_avg": {"value": {"field": "c.st"},
                                            "weight": {"field": "pos"}}}},
}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("case", sorted(NESTED))
def test_metric_under_nested(world, case, target):
    """Under `nested` (and a terms bucket in it): top_hits lists the
    nested objects sorted by one of their fields, the others read the
    nested fields, as the reference answers."""
    body = a_(n={"nested": {"path": "c"}, "aggs": {
        **NESTED[case], "by_a": {"terms": {"field": "c.a"},
                                 "aggs": NESTED[case]}}})
    same_aggs(world, f"/{target}/_search", body)


@pytest.mark.parametrize("query", [
    {"term": {"tag": "red"}}, {"range": {"n": {"gte": 30}}},
    {"match": {"t": "alpha"}}])
def test_metrics_over_a_query(world, query):
    """Every metric kind over a query's rows, one body."""
    aggs = {f"{k}_{n}": v for k, body in METRICS.items()
            for n, v in body.items()}
    for target in TARGETS:
        same_aggs(world, f"/{target}/_search",
                  {"size": 0, "query": query, "aggs": aggs,
                   "request_cache": False})


def test_scripted_metric_reads_scores(world):
    """A map_script that reads `_score` sees each row's query score."""
    body = {"size": 0, "query": {"match": {"t": "alpha beta"}},
            "request_cache": False, "aggs": {"x": {"scripted_metric": {
                "init_script": "state.s = 0.0",
                "map_script": "state.s += _score",
                "combine_script": "return state.s"}}}}
    for target in TARGETS:
        want, got = world.same("POST", f"/{target}/_search", body)
        assert want["aggregations"] == got["aggregations"]


def test_hdr_over_a_negative_value(world):
    """HDR percentiles over a negative value fail the shard: on a
    one-shard index the search is the reference's 503 "all shards
    failed"; over two indices the partial states are t-digests, which
    record it, as in the reference; on an index of several shards, a 400
    that names ROADMAP.md queue 1 item 12."""
    for field in ("neg", "m"):
        body = a_(p={"percentiles": {"field": field, "hdr": {}}})
        target = "/k1/_search" if field == "neg" else "/kx/_search"
        want, got = world.same("POST", target, body)
        assert got["status"] == 503
        assert got["error"]["reason"] == "all shards failed"
        same_aggs(world, "/k1,kx/_search", body)
    status, got = world.port("POST", "/k2/_search",
                             a_(p={"percentiles": {"field": "neg",
                                                   "hdr": {}}}))
    assert status == 400, got
    assert "[hdr] is not supported by this build" in got["error"]["reason"]
    assert "ROADMAP.md queue 1 item 12" in got["error"]["reason"]
    # an index of several shards without a negative answers
    same_aggs(world, "/k2/_search",
              a_(p={"percentiles": {"field": "m", "hdr": {}}}))


@pytest.mark.parametrize("body", [
    a_(p={"percentiles": {"field": "f", "hdr": {
        "number_of_significant_value_digits": 6}}}),
    a_(p={"percentiles": {"field": "f", "hdr": {
        "number_of_significant_value_digits": "x"}}}),
    a_(m={"median_absolute_deviation": {"field": "f", "compression": 0}}),
    a_(m={"median_absolute_deviation": {"field": "f",
                                        "compression": "x"}}),
    a_(w={"weighted_avg": {"value": {"field": "tag"},
                           "weight": {"field": "w"}}}),
    a_(b={"boxplot": {"field": "tag"}}),
    a_(s={"scripted_metric": {"init_script": "state.x = 0"}}),
    a_(s={"avg": {"script": "doc['n'].value"}}),
], ids=["hdr_digits", "hdr_digits_type", "mad_compression",
        "mad_compression_type", "weighted_keyword", "boxplot_keyword",
        "no_map_script", "script_missing_value"])
def test_metric_errors(world, body):
    """Each check's error, as the reference gives it."""
    for target in ("k1", "k1,kx"):
        want, got = world.same("POST", f"/{target}/_search", body)
        assert got.get("status", 200) >= 400 or "aggregations" in got


def test_typed_keys_of_new_metrics(world):
    body = a_(h={"percentiles": {"field": "f", "hdr": {}}},
              t={"percentiles": {"field": "f"}},
              r={"percentile_ranks": {"field": "f", "values": [2]}},
              g={"geo_bounds": {"field": "g"}},
              th={"top_hits": {"size": 1}},
              ss={"string_stats": {"field": "s"}})
    for target in TARGETS:
        want, got = same_aggs(world, f"/{target}/_search", body,
                              query={"typed_keys": "true"})
        assert "hdr_percentiles#h" in got["aggregations"]
        assert "tdigest_percentile_ranks#r" in got["aggregations"]


# ------------------------------------------- the reference's reduce tests

RED_MAPPING = {"properties": {
    "cat": {"type": "keyword"}, "name": {"type": "keyword"},
    "v": {"type": "double"}, "w": {"type": "double"},
    "ts": {"type": "date"}, "pt": {"type": "geo_point"}}}


def _red_docs() -> list:
    """The documents of the reference's `tests/test_agg_reduce.py`."""
    rng = random.Random(7)
    return [{"cat": ["red", "green", "blue", "teal"][i % 4],
             "name": f"u{i % 37}", "v": float(i), "w": float(1 + (i % 5)),
             "ts": 1_600_000_000_000 + (i % 6) * 3_600_000,
             "pt": {"lat": rng.uniform(-60, 60),
                    "lon": rng.uniform(-170, 170)}}
            for i in range(240)]


@pytest.fixture(scope="module")
def red(world):
    """The reference's reduce-test index in both layers, and each
    package's search context over it."""
    from elasticsearch_tpu.search.queries import SearchContext as RefContext
    from elasticsearch_tpu_torch.search.queries import SearchContext
    world.same("PUT", "/red", {"mappings": RED_MAPPING})
    ops = []
    for i, d in enumerate(_red_docs()):
        ops += [{"index": {"_id": str(i)}}, d]
    world.same("POST", "/red/_bulk", ops, ndjson=True)
    world.same("POST", "/red/_refresh")
    svc = world.port_node.index("red")
    rsvc = world.ref_node.indices.get("red")
    ctx = SearchContext(svc.combined_reader(), svc.mapper_service)
    rctx = RefContext(rsvc.combined_reader(), rsvc.mapper_service)
    assert np.array_equal(ctx.all_rows(), rctx.all_rows())
    yield ctx, rctx
    world.same("DELETE", "/red")


REDUCE_SPECS = {
    "exact_metrics": {
        "the_avg": {"avg": {"field": "v"}}, "the_sum": {"sum": {"field": "v"}},
        "the_stats": {"stats": {"field": "v"}},
        "the_count": {"value_count": {"field": "v"}},
        "the_wavg": {"weighted_avg": {"value": {"field": "v"},
                                      "weight": {"field": "w"}}},
        "ext": {"extended_stats": {"field": "v"}}},
    "percentiles_mad_boxplot_ranks": {
        "pct": {"percentiles": {"field": "v", "percents": [25, 50, 75, 99]}},
        "mad": {"median_absolute_deviation": {"field": "v"}},
        "box": {"boxplot": {"field": "v"}},
        "ranks": {"percentile_ranks": {"field": "v",
                                       "values": [60.0, 200.0]}}},
    "range_filters_composite": {
        "r": {"range": {"field": "v", "ranges": [
            {"to": 60.0}, {"from": 60.0, "to": 180.0}, {"from": 180.0}]},
            "aggs": {"m": {"max": {"field": "w"}}}},
        "f": {"filters": {"filters": {
            "reds": {"term": {"cat": "red"}},
            "high": {"range": {"v": {"gte": 120}}}}},
            "aggs": {"a": {"avg": {"field": "v"}}}},
        "c": {"composite": {"size": 6, "sources": [
            {"cc": {"terms": {"field": "cat"}}}]}}},
    "geo_string_matrix": {
        "gb": {"geo_bounds": {"field": "pt"}},
        "gc": {"geo_centroid": {"field": "pt"}},
        "ss": {"string_stats": {"field": "name"}},
        "mx": {"matrix_stats": {"fields": ["v", "w"]}}},
    "pipelines_after_reduce": {
        "h": {"histogram": {"field": "v", "interval": 60.0},
              "aggs": {"s": {"sum": {"field": "w"}},
                       "cum": {"cumulative_sum": {"buckets_path": "s"}}}},
        "avg_of_sums": {"avg_bucket": {"buckets_path": "h>s"}}},
    "auto_date_histogram": {
        "adh": {"auto_date_histogram": {"field": "ts", "buckets": 3},
                "aggs": {"m": {"avg": {"field": "v"}}}}},
    "scripted_metric": {"profit": {"scripted_metric": {
        "init_script": "state.vals = []",
        "map_script": "state.vals.add(doc['v'].value)",
        "combine_script":
            "double s = 0; for (t in state.vals) { s += t } return s",
        "reduce_script":
            "double s = 0; for (a in states) { s += a } return s"}}},
    "scripted_metric_states": {"m": {"scripted_metric": {
        "init_script": "state.n = 0", "map_script": "state.n += 1",
        "combine_script": "return state.n"}}},
    "grids_top_hits_rare": {
        "gh": {"geohash_grid": {"field": "pt", "precision": 1},
               "aggs": {"c": {"geo_centroid": {"field": "pt"}}}},
        "gt": {"geotile_grid": {"field": "pt", "precision": 2}},
        "th": {"terms": {"field": "cat"}, "aggs": {"top": {"top_hits": {
            "size": 2, "sort": [{"v": "desc"}]}}}},
        "tm": {"top_metrics": {"metrics": {"field": "w"},
                               "sort": {"v": "desc"}, "size": 2}},
        "rt": {"rare_terms": {"field": "name", "max_doc_count": 6}},
        "sig": {"significant_terms": {"field": "name",
                                      "min_doc_count": 1}}},
}


def _reduce(mod_partials, ctx, splits, spec):
    parts = [mod_partials.compute_partial_aggs(ctx, rows, spec)
             for rows in splits]
    merged = parts[0]
    for p in parts[1:]:
        merged = mod_partials.merge_partial_aggs(merged, p, spec)
    return merged, mod_partials.finalize_aggs(merged, spec)


@pytest.mark.parametrize("case", sorted(REDUCE_SPECS))
def test_skewed_reduce_matches_reference(red, case):
    """The reference's reduce tests (`tests/test_agg_reduce.py`) on its
    documents: three skewed row splits, partial states merged in the same
    order and finalized, and the one-pass answer, each equal to the
    reference's (t-digests, HLLs and power sums included)."""
    from elasticsearch_tpu.search import agg_partials as ref_partials
    from elasticsearch_tpu.search import aggregations as ref_aggs
    from elasticsearch_tpu_torch.search import agg_partials, aggregations
    ctx, rctx = red
    rows = ctx.all_rows()
    n = len(rows)
    splits = [rows[:n // 6], rows[n // 6:n // 2], rows[n // 2:]]
    spec = REDUCE_SPECS[case]
    assert _reduce(agg_partials, ctx, splits, spec) \
        == _reduce(ref_partials, rctx, splits, spec)
    assert aggregations.compute_aggs(ctx, rows, spec) \
        == ref_aggs.compute_aggs(rctx, rows, spec)
