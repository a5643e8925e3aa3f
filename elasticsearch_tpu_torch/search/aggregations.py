"""Aggregations over a query's rows: the host framework (port of
`elasticsearch_tpu/search/aggregations.py`).

Every aggregation reduces vectorised over the matched row set, and each
bucket carries its rows, so sub-aggregations recurse to any depth
(`compute_aggs`). Values come from the doc-values columns: numbers
through `search/service.py::numeric_values` (a multi-valued doc's first
value, a boolean as 1.0 or 0.0), raw values through `all_values` (every
value of a multi-valued doc), geo points through `geo_point_values`
(the (lat, lon) views kept with each segment's column).

Metrics: `avg`, `sum`, `min`, `max`, `stats`, `extended_stats`,
`value_count`, `cardinality` (exact here: a set of the values; the shard
partials of `search/agg_partials.py` carry an HLL), `percentiles`
(t-digest singleton interpolation, or HDR's highest equivalent value),
`percentile_ranks`, `median_absolute_deviation`, `boxplot`,
`weighted_avg`, `string_stats`, `top_metrics`, `matrix_stats`,
`geo_bounds`, `geo_centroid`, `top_hits` (the nested objects directly
under a `nested` aggregation sorted by one of their fields),
`scripted_metric` (Painless init / map / combine / reduce), and a
`script` in place of a metric's `field`. Buckets: `terms` (`size`,
`order`, `missing`, `min_doc_count`, `include` / `exclude`,
`value_type`), `rare_terms`, `significant_terms` and `significant_text`
(JLH over background counts), `histogram`, `date_histogram` (calendar
and fixed intervals, `offset`, `time_zone`, `format`,
`extended_bounds`; a range field counts in every bucket it overlaps),
`auto_date_histogram`, `range`, `date_range`, `ip_range`, `filter`,
`filters`, `adjacency_matrix`, `missing`, `global`, `sampler`,
`composite` (`terms`, `histogram`, `date_histogram` and `geotile_grid`
sources, `after` paging, `missing_bucket`), `geohash_grid`,
`geotile_grid`, `nested` (its `doc_count` the nested objects of its
rows; inside it a `terms` bucket on a field under the path counts each
value occurrence, while its sub-aggregations run over the unique parent
rows) and `reverse_nested`. The pipelines (`search/agg_pipelines.py`) run
over the outputs, at the top level and as sub-aggregations of a bucket.
`search.max_buckets` (`ctx.max_buckets`) bounds each bucket list.

Left out, a 400 that names it (`LEFT_OUT`): HDR `percentiles` over a
negative value on an index of several shards, which the reference answers
by retrying without the failing shards (ROADMAP.md queue 1 item 12);
`node.py` raises it when a query phase of such an index fails with
`ArrayIndexOutOfBoundsError`.
"""

from __future__ import annotations

import bisect
import datetime as dt
import difflib
import ipaddress
import itertools
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.cluster.routing import murmur3_x86_32_many
from elasticsearch_tpu_torch.common.errors import (
    ArrayIndexOutOfBoundsError, IllegalArgumentError, ParsingError,
    TooManyBucketsError,
)
from elasticsearch_tpu_torch.index.mapping import (
    IpFieldMapper, RangeFieldMapperBase, parse_date_millis,
)
from elasticsearch_tpu_torch.search.queries import SearchContext, parse_query
from elasticsearch_tpu_torch.search.service import (
    not_ported, numeric_values as _numeric_columns,
)

MAX_BUCKETS = 65536  # search.max_buckets default; bounds histogram spans

BUCKET_AGGS = {"terms", "histogram", "date_histogram", "range", "date_range",
               "ip_range", "filter", "filters", "missing", "global",
               "nested", "reverse_nested", "composite", "significant_terms",
               "significant_text", "rare_terms", "sampler",
               "auto_date_histogram", "adjacency_matrix", "geohash_grid",
               "geotile_grid"}
METRIC_AGGS = {"avg", "sum", "min", "max", "stats", "extended_stats",
               "value_count", "cardinality", "percentiles",
               "percentile_ranks", "top_hits", "weighted_avg",
               "median_absolute_deviation", "geo_bounds", "geo_centroid",
               "boxplot", "string_stats", "top_metrics", "matrix_stats",
               "scripted_metric"}
PIPELINE_AGGS = {"avg_bucket", "max_bucket", "min_bucket", "sum_bucket",
                 "stats_bucket", "extended_stats_bucket",
                 "percentiles_bucket", "derivative", "cumulative_sum",
                 "bucket_script", "bucket_selector", "bucket_sort",
                 "serial_diff", "moving_fn"}
# what the reference serves that this build leaves out, and why
LEFT_OUT = {
    "hdr_multi_shard": "HDR percentiles over a negative value on an index "
                       "of several shards fail that shard, and the retry "
                       "without it is not ported (ROADMAP.md queue 1 item "
                       "12)",
}
_NUMERIC_ONLY_METRICS = {"sum", "avg", "min", "max", "stats",
                         "extended_stats", "percentiles", "percentile_ranks",
                         "median_absolute_deviation", "weighted_avg"}
_STRUCTURAL = ("aggs", "aggregations", "meta")


def hdr_multi_shard_error() -> IllegalArgumentError:
    """The 400 of HDR percentiles that fail a shard of a multi-shard
    index."""
    return not_ported("hdr", LEFT_OUT["hdr_multi_shard"])


# ---------------------------------------------------------------- values

def raw_values(ctx: SearchContext, rows: np.ndarray, field: str) -> np.ndarray:
    """Each row's doc value of `field` as its column holds it (a list for a
    multi-valued doc; None when the doc has none), as an object array."""
    field = ctx.mapper_service.resolve_field(field)
    rows = np.asarray(rows, dtype=np.int64)
    out = np.empty(len(rows), dtype=object)
    if not len(rows):
        return out
    vi, local = ctx.reader.locate_many(rows)
    for v in np.unique(vi):
        col = ctx.reader.views[v].segment.doc_values.get(field)
        if col is None:
            continue
        at = np.nonzero(vi == v)[0]
        out[at] = col.values[local[at]]
    return out


def numeric_values(ctx: SearchContext, rows: np.ndarray, field: str,
                   missing: Optional[float] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(values f64, present) of one field over rows; with `missing` every
    absent value takes it and every row is present."""
    vals, present = _numeric_columns(
        ctx.reader, rows, ctx.mapper_service.resolve_field(field))
    if missing is not None:
        vals[~present] = missing
        present = np.ones(len(vals), dtype=bool)
    return vals, present


def _single_valued(col) -> bool:
    """Whether a column holds no list (kept with the column)."""
    got = col.derived.get("single")
    if got is None:
        got = not any(isinstance(v, list) for v in col.values.tolist())
        col.derived["single"] = got
    return got


def value_arrays(ctx: SearchContext, rows: np.ndarray,
                 field: str) -> Tuple[np.ndarray, List[Any]]:
    """(row positions, values) of a field over rows, a multi-valued doc's
    values one after another: `all_values` as two sequences. Columns of
    one value a doc gather at once."""
    rows = np.asarray(rows, dtype=np.int64)
    n = len(rows)
    if field == "_index":
        return (np.arange(n, dtype=np.int64),
                [getattr(ctx, "index_name", "index")] * n)
    field = ctx.mapper_service.resolve_field(field)
    if not n:
        return np.zeros(0, dtype=np.int64), []
    vi, local = ctx.reader.locate_many(rows)
    segs = np.unique(vi).tolist()
    cols = [ctx.reader.views[v].segment.doc_values.get(field) for v in segs]
    if all(c is None or _single_valued(c) for c in cols):
        raw = np.empty(n, dtype=object)
        for v, col in zip(segs, cols):
            if col is not None:
                at = np.nonzero(vi == v)[0]
                raw[at] = col.values[local[at]]
        pos = np.nonzero(np.not_equal(raw, None))[0]
        return pos.astype(np.int64), raw[pos].tolist()
    pos, vals = [], []
    for i, v in enumerate(raw_values(ctx, rows, field).tolist()):
        if v is None:
            continue
        if isinstance(v, list):
            for item in v:
                if item is not None:
                    pos.append(i)
                    vals.append(item)
        else:
            pos.append(i)
            vals.append(v)
    return np.asarray(pos, dtype=np.int64), vals


def all_values(ctx: SearchContext, rows: np.ndarray,
               field: str) -> List[Tuple[int, Any]]:
    """[(row position, value)] expanded over multi-valued fields."""
    pos, vals = value_arrays(ctx, rows, field)
    return list(zip(pos.tolist(), vals))


def _single_points(col) -> bool:
    """Whether a geo column holds at most one point a document (kept with
    the column)."""
    got = col.derived.get("geo_single")
    if got is None:
        got = not any(isinstance(v, list) and v
                      and isinstance(v[0], (list, tuple))
                      for v in col.values.tolist())
        col.derived["geo_single"] = got
    return got


def _walk_points(vals) -> Tuple[List[int], List[float], List[float]]:
    """(row position, lat, lon) of every point of raw geo values, in
    order, a multi-valued doc's points one after another."""
    pos, lats, lons = [], [], []
    for i, v in enumerate(vals):
        if v is None:
            continue
        if isinstance(v, list) and v and isinstance(v[0], (list, tuple)):
            for p in v:
                pos.append(i)
                lats.append(float(p[0]))
                lons.append(float(p[1]))
        elif isinstance(v, (list, tuple)) and len(v) == 2:
            pos.append(i)
            lats.append(float(v[0]))
            lons.append(float(v[1]))
    return pos, lats, lons


def geo_point_values(ctx: SearchContext, rows: np.ndarray, field: str
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row position, lat, lon) of every point of `field` over rows, in
    row order. Single-point columns read the segment's (lat, lon) view
    (`queries_ext._geo_view`); a column with several points a document
    walks its values."""
    from elasticsearch_tpu_torch.search.queries_ext import _geo_view
    field = ctx.mapper_service.resolve_field(field)
    rows = np.asarray(rows, dtype=np.int64)
    n = len(rows)
    lat, lon = np.zeros(n), np.zeros(n)
    have = np.zeros(n, dtype=bool)
    if n:
        vi, local = ctx.reader.locate_many(rows)
        for v in np.unique(vi).tolist():
            col = ctx.reader.views[v].segment.doc_values.get(field)
            if col is None:
                continue
            if not _single_points(col):
                pos, lats, lons = _walk_points(
                    raw_values(ctx, rows, field).tolist())
                return (np.asarray(pos, dtype=np.int64), np.asarray(lats),
                        np.asarray(lons))
            at = np.nonzero(vi == v)[0]
            vlat, vlon, vpresent = _geo_view(col)
            ok = vpresent[local[at]]
            lat[at[ok]] = vlat[local[at[ok]]]
            lon[at[ok]] = vlon[local[at[ok]]]
            have[at[ok]] = True
    pos = np.nonzero(have)[0]
    return pos, lat[pos], lon[pos]


def _hashable(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _sort_key(v):
    if v is None:
        return (2, "")
    if isinstance(v, bool):
        return (1, str(v))
    if isinstance(v, (int, float)):
        return (0, float(v))
    return (1, str(v))


def _mix64(k: int) -> int:
    """hppc BitMixer.mix64, the terms include partition's hash of a
    number; signed, so Python's % is Java's Math.floorMod."""
    m = 0xFFFFFFFFFFFFFFFF
    k &= m
    k = ((k ^ (k >> 32)) * 0x4CD6944C5CC20B6D) & m
    k = ((k ^ (k >> 29)) * 0xFC12C5B19D3259E9) & m
    k = k ^ (k >> 32)
    return k - (1 << 64) if k >= (1 << 63) else k


def _murmur3_x86_32(data: bytes, seed: int) -> int:
    """Lucene StringHelper.murmurhash3_x86_32 (signed int32), the terms
    include partition's hash of a string (seed 31)."""
    return int(murmur3_x86_32_many([data], seed)[0])


# --------------------------------------------------------------- metrics

def _es_percentile(v_sorted: np.ndarray, p: float):
    """TDigest singleton-centroid quantile: centroid i sits at cumulative
    position i + 0.5, the extremes clamp to min / max."""
    n = len(v_sorted)
    if n == 0:
        return None
    if n == 1:
        return float(v_sorted[0])
    return float(np.interp(p / 100.0 * n, np.arange(n) + 0.5, v_sorted))


def _metric_stats(vals: np.ndarray, present: np.ndarray) -> dict:
    v = vals[present]
    if len(v) == 0:
        return {"count": 0, "min": None, "max": None, "avg": None,
                "sum": 0.0}
    return {"count": int(len(v)), "min": float(v.min()),
            "max": float(v.max()), "avg": float(v.mean()),
            "sum": float(v.sum())}


def _extended_stats(vals: np.ndarray, present: np.ndarray,
                    sigma: float = 2.0) -> dict:
    base = _metric_stats(vals, present)
    v = vals[present]
    if len(v) == 0:
        base.update({"sum_of_squares": None, "variance": None,
                     "std_deviation": None,
                     "std_deviation_bounds": {"upper": None, "lower": None}})
        return base
    var = float(v.var())
    std = float(v.std())
    mean = base["avg"]
    base.update({
        "sum_of_squares": float((v ** 2).sum()), "variance": var,
        "variance_population": var,
        "variance_sampling": float(v.var(ddof=1)) if len(v) > 1 else 0.0,
        "std_deviation": std,
        "std_deviation_bounds": {"upper": mean + sigma * std,
                                 "lower": mean - sigma * std},
    })
    return base


def metric_numeric(ctx: SearchContext, rows: np.ndarray, spec: dict
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A metric's (values, present): its `script` evaluated over every
    row when it names no `field`, else the field's values."""
    script = spec.get("script")
    if script is not None and spec.get("field") is None:
        from elasticsearch_tpu_torch.search.script_score import Script
        vals = Script(script).evaluate(
            ctx, rows, np.zeros(len(rows), dtype=np.float32)
        ).astype(np.float64)
        return vals, np.ones(len(rows), dtype=bool)
    return numeric_values(ctx, rows, spec.get("field"), spec.get("missing"))


def _hdr_digits(hdr: dict) -> int:
    raw = hdr.get("number_of_significant_value_digits", 3)
    try:
        digits = int(raw)
    except (TypeError, ValueError):
        digits = -1
    if not 0 <= digits <= 5:
        raise IllegalArgumentError(
            "[numberOfSignificantValueDigits] must be between 0 and 5")
    return digits


def _hdr_quantize(v: np.ndarray, x: float, digits: int) -> float:
    """DoubleHistogram's highest equivalent value: the top of x's bucket at
    the precision (2^ceil(log2(10^digits)) sub-buckets, the unit ranged
    from the smallest positive value recorded)."""
    if x <= 0 or len(v) == 0:
        return float(x)
    sub = 1 << math.ceil(math.log2(10 ** max(digits, 1)))
    vmin = float(v[v > 0][0]) if (v > 0).any() else 1.0
    unit = 2.0 ** math.floor(math.log2(vmin)) / sub
    erange = max(2.0 ** math.floor(math.log2(x)) / sub, unit)
    return math.floor(x / erange) * erange + erange - unit


def _percentiles(v: np.ndarray, spec: dict, name: str) -> dict:
    pcts = spec.get("percents", [1, 5, 25, 50, 75, 95, 99])
    tdigest = spec.get("tdigest")
    if tdigest is not None and "compression" in tdigest:
        comp = float(tdigest["compression"] or 0)
        if comp < 0:
            raise IllegalArgumentError(
                f"[compression] must be greater than or equal to 0. "
                f"Found [{comp}] in [{name}]")
    v = np.sort(v)
    hdr = spec.get("hdr")
    digits = 3
    if hdr is not None:
        if v.size and v[0] < 0:
            # HDR cannot record a negative: the shard fails, as the
            # reference's DoubleHistogram fails it
            raise ArrayIndexOutOfBoundsError("out of covered value range")
        digits = _hdr_digits(hdr)

    def one(p):
        if len(v) == 0:
            return None
        if hdr is not None:
            # the value at the rank (round half up), no interpolation
            rank = min(max(int(math.floor(p / 100.0 * len(v) + 0.5)), 1),
                       len(v))
            return _hdr_quantize(v, float(v[rank - 1]), digits)
        return _es_percentile(v, float(p))
    if spec.get("keyed", True) is False:
        return {"values": [{"key": float(p), "value": one(float(p))}
                           for p in pcts]}
    return {"values": {f"{float(p)}": one(float(p)) for p in pcts}}


def _boxplot(v: np.ndarray) -> dict:
    if len(v) == 0:
        return {"min": None, "max": None, "q1": None, "q2": None,
                "q3": None, "lower": None, "upper": None}
    q1, q2, q3 = (float(np.percentile(v, p)) for p in (25, 50, 75))
    iqr = q3 - q1
    inside = v[(v >= q1 - 1.5 * iqr) & (v <= q3 + 1.5 * iqr)]
    return {"min": float(v.min()), "max": float(v.max()),
            "q1": q1, "q2": q2, "q3": q3,
            "lower": float(inside.min()) if len(inside) else q1,
            "upper": float(inside.max()) if len(inside) else q3}


def weighted_avg_parts(ctx, rows, spec) -> Tuple[np.ndarray, np.ndarray]:
    """(values, weights) of the rows holding both; a weight's `missing`
    defaults to 1."""
    vspec = spec.get("value", {})
    wspec = spec.get("weight", {})
    vv, vp = numeric_values(ctx, rows, vspec.get("field"),
                            vspec.get("missing"))
    wv, wp = numeric_values(ctx, rows, wspec.get("field"),
                            wspec.get("missing", 1.0))
    both = vp & wp
    return vv[both], wv[both]


def compute_metric(ctx: SearchContext, rows: np.ndarray, kind: str,
                   spec: dict, name: str = "") -> Any:
    field = spec.get("field")
    if kind in _NUMERIC_ONLY_METRICS and field:
        tname = getattr(ctx.mapper_service.get(field), "type_name", None)
        if tname in ("keyword", "text"):
            raise IllegalArgumentError(
                f"Field [{field}] of type [{tname}] is not supported for "
                f"aggregation [{kind}]")
    missing = spec.get("missing")
    if kind == "string_stats":
        return compute_string_stats(ctx, rows, spec)
    if kind == "top_metrics":
        return compute_top_metrics(ctx, rows, spec)
    if kind == "matrix_stats":
        return compute_matrix_stats(ctx, rows, spec)
    if kind == "scripted_metric":
        state = scripted_metric_map_combine(ctx, rows, spec)
        return {"value": scripted_metric_reduce(spec, [state])}
    if kind == "top_hits":
        return top_hits(ctx, rows, spec)

    if kind == "value_count":
        if field is None:
            return {"value": len(rows)}
        values = all_values(ctx, rows, field)
        count = len(values)
        if missing is not None:
            count += len(rows) - len({i for i, _ in values})
        return {"value": count}

    if kind in ("geo_bounds", "geo_centroid"):
        _, lats, lons = geo_point_values(ctx, rows, field)
        if not len(lats):
            return ({"bounds": None} if kind == "geo_bounds"
                    else {"count": 0})
        if kind == "geo_bounds":
            return {"bounds": {
                "top_left": {"lat": float(lats.max()),
                             "lon": float(lons.min())},
                "bottom_right": {"lat": float(lats.min()),
                                 "lon": float(lons.max())}}}
        return {"location": {"lat": float(lats.mean()),
                             "lon": float(lons.mean())},
                "count": int(len(lats))}

    if kind == "cardinality":
        pt = spec.get("precision_threshold")
        if pt is not None and int(pt) < 0:
            raise IllegalArgumentError(
                f"[precisionThreshold] must be greater than or equal to 0. "
                f"Found [{int(pt)}] in [{name}]")
        values = all_values(ctx, rows, field)
        distinct = {_hashable(v) for _, v in values}
        if missing is not None and len({i for i, _ in values}) < len(rows):
            distinct.add(_hashable(missing))
        return {"value": len(distinct)}

    if kind == "weighted_avg":
        vv, wv = weighted_avg_parts(ctx, rows, spec)
        den = wv.sum()
        return {"value": float((vv * wv).sum() / den) if den else None}

    vals, present = metric_numeric(ctx, rows, spec)
    v = vals[present]
    if kind == "avg":
        out = {"value": float(v.mean()) if len(v) else None}
        tname = getattr(ctx.mapper_service.get(field), "type_name", None) \
            if field else None
        if out["value"] is not None and tname in ("date", "date_nanos"):
            ms = out["value"] / 1e6 if tname == "date_nanos" \
                else out["value"]
            out["value_as_string"] = _millis_to_iso(int(round(ms)))
        return out
    if kind == "sum":
        return {"value": float(v.sum())}
    if kind == "min":
        return {"value": float(v.min()) if len(v) else None}
    if kind == "max":
        return {"value": float(v.max()) if len(v) else None}
    if kind == "stats":
        return _metric_stats(vals, present)
    if kind == "extended_stats":
        sigma = float(spec.get("sigma", 2.0))
        if sigma < 0:
            raise IllegalArgumentError(
                f"[sigma] must be greater than or equal to 0. "
                f"Found [{sigma}] in [{name}]")
        return _extended_stats(vals, present, sigma)
    if kind == "median_absolute_deviation":
        if len(v) == 0:
            return {"value": None}
        return {"value": float(np.median(np.abs(v - np.median(v))))}
    if kind == "percentiles":
        return _percentiles(v, spec, name)
    if kind == "percentile_ranks":
        v = np.sort(v)
        return {"values": {
            f"{float(t)}": (None if len(v) == 0 else float(
                100.0 * np.searchsorted(v, t, side="right") / len(v)))
            for t in spec.get("values", [])}}
    if kind == "boxplot":
        return _boxplot(v)
    raise ParsingError(f"unknown metric aggregation [{kind}]")


def script_source(s) -> str:
    if isinstance(s, dict):
        return s.get("source") or s.get("inline") or ""
    return s or ""


def scripted_metric_map_combine(ctx: SearchContext, rows: np.ndarray,
                                spec: dict):
    """One index's init, map and combine: `init_script` seeds `state`,
    `map_script` runs a matched document with the `doc[...]` bindings of
    `script_score` (and its `_score` when it reads one), and
    `combine_script` folds the state into what the coordinator
    reduces."""
    from elasticsearch_tpu_torch.script.painless import (
        FrozenParams, compile_painless, execute,
    )
    from elasticsearch_tpu_torch.search.script_score import _ScalarDoc
    params = FrozenParams(spec.get("params") or {})
    state: Dict[str, Any] = {}
    bindings = {"state": state, "params": params}
    init = script_source(spec.get("init_script"))
    if init:
        execute(compile_painless(init), dict(bindings))
    map_src = script_source(spec.get("map_script"))
    if not map_src:
        raise IllegalArgumentError(
            "[map_script] must be provided in [scripted_metric]")
    prog = compile_painless(map_src)
    score_of = None
    if "_score" in map_src:
        srows = getattr(ctx, "agg_score_rows", None)
        if srows is not None:
            score_of = {int(r): float(s)
                        for r, s in zip(srows, ctx.agg_scores)}.get
    for row in rows.tolist():
        execute(prog, {**bindings, "doc": _ScalarDoc(ctx, int(row)),
                       "_score": score_of(int(row), 0.0)
                       if score_of else 0.0})
    combine = script_source(spec.get("combine_script"))
    if combine:
        return execute(compile_painless(combine), dict(bindings))
    return state


def scripted_metric_reduce(spec: dict, states: list):
    """The coordinator's `reduce_script` over every combined state; the
    states themselves when there is none."""
    from elasticsearch_tpu_torch.script.painless import (
        FrozenParams, compile_painless, execute,
    )
    reduce_src = script_source(spec.get("reduce_script"))
    if not reduce_src:
        return list(states)
    return execute(compile_painless(reduce_src),
                   {"states": list(states),
                    "params": FrozenParams(spec.get("params") or {})})


def string_stats_state(ctx: SearchContext, rows: np.ndarray,
                       field) -> dict:
    """count, length sum / min / max and the character counts (first
    occurrence order) of a field's values as strings."""
    values = [v if type(v) is str else str(v)
              for v in value_arrays(ctx, rows, field)[1]]
    lengths = np.fromiter(map(len, values), dtype=np.int64,
                          count=len(values))
    some = len(values) > 0
    return {"n": len(values), "len_sum": int(lengths.sum()),
            "min_len": int(lengths.min()) if some else None,
            "max_len": int(lengths.max()) if some else None,
            "freq": char_counts("".join(values))}


def char_counts(text: str) -> Dict[str, int]:
    """Each character's count, in the order of its first occurrence (the
    order a per-character walk fills a dict in)."""
    codes = (np.frombuffer(text.encode("ascii"), dtype=np.uint8)
             if text.isascii()
             else np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32))
    if not len(codes):
        return {}
    counts = np.bincount(codes)
    first = np.zeros(len(counts), dtype=np.int64)
    # written back to front, each code keeps its first position
    first[codes[::-1]] = np.arange(len(codes) - 1, -1, -1)
    seen = np.nonzero(counts)[0]
    seen = seen[np.argsort(first[seen], kind="stable")]
    return {chr(c): int(k) for c, k in zip(seen.tolist(),
                                           counts[seen].tolist())}


def finalize_string_stats(spec: dict, state: dict) -> dict:
    if state["n"] == 0:
        return {"count": 0, "min_length": None, "max_length": None,
                "avg_length": None, "entropy": 0.0}
    total_chars = sum(state["freq"].values())
    entropy = 0.0
    for c in state["freq"].values():
        p = c / total_chars
        entropy -= p * math.log2(p)
    out = {"count": state["n"], "min_length": state["min_len"],
           "max_length": state["max_len"],
           "avg_length": state["len_sum"] / state["n"],
           "entropy": round(entropy, 10)}
    if spec.get("show_distribution"):
        out["distribution"] = {ch: c / total_chars
                               for ch, c in sorted(state["freq"].items())}
    return out


def compute_string_stats(ctx: SearchContext, rows: np.ndarray,
                         spec: dict) -> dict:
    return finalize_string_stats(
        spec, string_stats_state(ctx, rows, spec.get("field")))


def top_metrics_sort(spec: dict) -> Tuple[str, str]:
    """(sort field, order) of a top_metrics spec (`_doc` ascending by
    default)."""
    sort_spec = spec.get("sort", [{"_doc": "asc"}])
    if isinstance(sort_spec, (str, dict)):
        sort_spec = [sort_spec]
    entry = sort_spec[0]
    if isinstance(entry, str):
        return entry, "asc"
    field, order = next(iter(entry.items()))
    if isinstance(order, dict):
        order = order.get("order", "asc")
    return field, order


def compute_top_metrics(ctx: SearchContext, rows: np.ndarray,
                        spec: dict) -> dict:
    """The metric values of the top `size` rows by the sort key."""
    metrics = spec.get("metrics", [])
    if isinstance(metrics, dict):
        metrics = [metrics]
    size = int(spec.get("size", 1))
    sort_field, order = top_metrics_sort(spec)
    if sort_field == "_doc":
        keys = rows.astype(np.float64)
        kp = np.ones(len(rows), dtype=bool)
    else:
        keys, kp = numeric_values(ctx, rows, sort_field)
    idx = np.nonzero(kp)[0]
    idx = idx[np.argsort(keys[idx], kind="stable")]
    if order == "desc":
        idx = idx[::-1]
    top = []
    for i in idx[:size].tolist():
        row = int(rows[i])
        mvals = {}
        for m in metrics:
            mf = m.get("field")
            v = ctx.reader.get_doc_value(
                ctx.mapper_service.resolve_field(mf), row)
            if isinstance(v, list):
                v = v[0] if v else None
            mvals[mf] = float(v) if isinstance(v, (int, float)) \
                and not isinstance(v, bool) else v
        top.append({"sort": [float(keys[i])], "metrics": mvals})
    return {"top": top}


def matrix_columns(ctx, rows, fields) -> Tuple[dict, np.ndarray]:
    """Each field's values over the rows holding every field (listwise
    deletion) and that mask."""
    cols, presents = {}, {}
    for f in fields:
        cols[f], presents[f] = numeric_values(ctx, rows, f)
    mask = (np.logical_and.reduce([presents[f] for f in fields])
            if fields else np.zeros(0, dtype=bool))
    return {f: cols[f][mask] for f in fields}, mask


def compute_matrix_stats(ctx: SearchContext, rows: np.ndarray,
                         spec: dict) -> dict:
    """Per-field moments and the pairwise covariance and correlation."""
    fields = spec.get("fields", [])
    cols, mask = matrix_columns(ctx, rows, fields)
    n = int(mask.sum())
    if n == 0:
        return {"doc_count": 0, "fields": []}
    stats = {}
    for f in fields:
        v = cols[f]
        mean = float(v.mean())
        centered = v - mean
        var = float((centered ** 2).sum() / (n - 1)) if n > 1 else 0.0
        stats[f] = (mean, centered, var, math.sqrt(var))
    cov: Dict[str, Dict[str, float]] = {f: {} for f in fields}
    for i, f in enumerate(fields):
        for g in fields[i:]:
            c = float((stats[f][1] * stats[g][1]).sum() / (n - 1)) \
                if n > 1 else 0.0
            cov[f][g] = cov[g][f] = c
    out_fields = []
    for f in fields:
        mean, centered, var, sd = stats[f]
        skew = float(((centered / sd) ** 3).mean()) if sd else 0.0
        kurt = float(((centered / sd) ** 4).mean()) if sd else 0.0
        corr = {}
        for g in fields:
            sd_g = stats[g][3]
            corr[g] = (cov[f][g] / (sd * sd_g)) if sd and sd_g else (
                1.0 if f == g else 0.0)
        out_fields.append({"name": f, "count": n, "mean": mean,
                           "variance": var, "skewness": skew,
                           "kurtosis": kurt, "covariance": cov[f],
                           "correlation": corr})
    return {"doc_count": n, "fields": out_fields}


# ------------------------------------------------------------ validation

def _parse_float_param(spec: dict, key: str, default: float,
                       agg_name: str) -> float:
    raw = spec.get(key, default)
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise ParsingError(
            f"x_content_parse_exception: [{key}] failed to parse value "
            f"[{raw}] in [{agg_name}]")


def _parse_int_param(spec: dict, key: str, default: int,
                     agg_name: str) -> int:
    raw = spec.get(key, default)
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise ParsingError(
            f"x_content_parse_exception: [{key}] failed to parse value "
            f"[{raw}] in [{agg_name}]")


def agg_kind(name: str, spec) -> str:
    """The one aggregation type of a named spec."""
    if not isinstance(spec, dict):
        raise ParsingError(f"aggregation [{name}] must be an object")
    kinds = [k for k in spec if k not in _STRUCTURAL]
    if len(kinds) != 1:
        raise ParsingError(
            f"aggregation [{name}] must define exactly one type")
    return kinds[0]


def sub_aggs_of(spec: dict) -> dict:
    return spec.get("aggs") or spec.get("aggregations") or {}


def validate_aggs(aggs_spec: dict, field_type=None) -> None:
    """Parse-time checks before any shard runs (the reference validates
    each aggregation as it parses it, so errors surface for zero-shard
    searches too). `field_type(field) -> type name or None` enables the
    mapping-aware checks."""
    for name, spec in (aggs_spec or {}).items():
        if not isinstance(spec, dict):
            raise ParsingError(f"aggregation [{name}] must be an object")
        for kind, body in spec.items():
            if kind in _STRUCTURAL or not isinstance(body, dict):
                continue
            if kind == "extended_stats":
                sigma = _parse_float_param(body, "sigma", 2.0, name)
                if sigma < 0:
                    raise IllegalArgumentError(
                        f"[sigma] must be greater than or equal to 0. "
                        f"Found [{sigma}] in [{name}]")
            if kind == "cardinality" and "precision_threshold" in body:
                pt = _parse_int_param(body, "precision_threshold", 0, name)
                if pt < 0:
                    raise IllegalArgumentError(
                        f"[precisionThreshold] must be greater than or "
                        f"equal to 0. Found [{pt}] in [{name}]")
            if kind == "percentiles":
                td = body.get("tdigest")
                if isinstance(td, dict) and "compression" in td:
                    comp = _parse_float_param(td, "compression", 100.0, name)
                    if comp < 0:
                        raise IllegalArgumentError(
                            f"[compression] must be greater than or equal "
                            f"to 0. Found [{comp}] in [{name}]")
                if "percents" in body:
                    pc = body["percents"]
                    if not isinstance(pc, list) or not pc:
                        raise IllegalArgumentError(
                            "[percents] must not be empty")
                    for p in pc:
                        try:
                            fp = float(p)
                        except (TypeError, ValueError):
                            raise ParsingError(
                                f"x_content_parse_exception: [percents] "
                                f"failed to parse [{p}]")
                        if not 0.0 <= fp <= 100.0:
                            raise IllegalArgumentError(
                                f"percent must be in [0,100], got [{fp}]")
                hdr = body.get("hdr")
                if isinstance(hdr, dict):
                    _hdr_digits(hdr)
            if kind == "median_absolute_deviation" and "compression" in body:
                comp = _parse_float_param(body, "compression", 1000.0, name)
                if comp <= 0:
                    raise IllegalArgumentError(
                        f"[compression] must be greater than 0. "
                        f"Found [{comp}] in [{name}]")
            if kind == "moving_fn" and body.get("window") is not None:
                if _parse_int_param(body, "window", 5, name) <= 0:
                    raise IllegalArgumentError(
                        "[window] must be a positive, non-zero integer.")
            if kind == "filters" and not body.get("filters"):
                raise IllegalArgumentError("[filters] cannot be empty")
            if kind in ("significant_terms", "significant_text"):
                for k in body:
                    if k not in SIG_KNOWN_FIELDS:
                        close = difflib.get_close_matches(
                            k, SIG_KNOWN_FIELDS, n=1)
                        hint = f" did you mean [{close[0]}]?" if close \
                            else ""
                        raise ParsingError(
                            f"[{kind}] unknown field [{k}]{hint}")
            if kind in ("terms", "significant_terms", "significant_text",
                        "rare_terms"):
                inc, exc = body.get("include"), body.get("exclude")
                # a regex include / exclude applies to string fields only
                if isinstance(inc, str) or isinstance(exc, str):
                    tname = (field_type(body.get("field", ""))
                             if field_type else None)
                    if tname is not None and tname not in (
                            "keyword", "text", "wildcard",
                            "constant_keyword"):
                        raise IllegalArgumentError(
                            f"Aggregation [{name}] cannot support regular "
                            f"expression style include/exclude settings as "
                            f"they can only be applied to string fields. "
                            f"Use an array of values for include/exclude "
                            f"clauses")
        sub = sub_aggs_of(spec)
        if sub:
            validate_aggs(sub, field_type)


# ----------------------------------------------------------------- trees

def compute_aggs(ctx: SearchContext, rows: np.ndarray,
                 aggs_spec: dict) -> dict:
    """An aggregation tree over candidate rows, final form. A bucket
    aggregation's parent pipelines run over its bucket list once it is
    built, the top level's pipelines over the outputs at the end."""
    from elasticsearch_tpu_torch.search import agg_pipelines as P
    out: Dict[str, Any] = {}
    pipelines: List[Tuple[str, str, dict]] = []
    for name, spec in (aggs_spec or {}).items():
        kind = agg_kind(name, spec)
        if kind in PIPELINE_AGGS:
            pipelines.append((name, kind, spec[kind]))
            continue
        if kind in METRIC_AGGS:
            out[name] = compute_metric(ctx, rows, kind, spec[kind], name=name)
        elif kind in BUCKET_AGGS:
            normal, pipes = split_pipelines(sub_aggs_of(spec))
            out[name] = _compute_bucket(ctx, rows, kind, spec[kind], normal)
            P.run_parent_pipelines(out[name], pipes)
        else:
            raise ParsingError(f"unknown aggregation type [{kind}]")
        if isinstance(spec.get("meta"), dict) \
                and isinstance(out.get(name), dict):
            out[name]["meta"] = spec["meta"]
    P.run_sibling_pipelines(out, pipelines)
    return out


def is_pipeline(spec) -> bool:
    kinds = [k for k in spec if k not in _STRUCTURAL] \
        if isinstance(spec, dict) else []
    return len(kinds) == 1 and kinds[0] in PIPELINE_AGGS


def split_pipelines(sub: dict) -> Tuple[dict, List[Tuple[str, str, dict]]]:
    """A bucket's sub-aggregations -> (the others, [(name, kind, body)] of
    its pipelines)."""
    normal, pipes = {}, []
    for sname, sspec in (sub or {}).items():
        if is_pipeline(sspec):
            kind = next(k for k in sspec if k not in _STRUCTURAL)
            pipes.append((sname, kind, sspec[kind]))
        else:
            normal[sname] = sspec
    return normal, pipes


def _bucketize(ctx, sub_aggs, buckets: List[Tuple[Any, np.ndarray]],
               recurse) -> List[dict]:
    out = []
    for key, brows in buckets:
        b = {"key": key, "doc_count": int(len(brows))}
        if sub_aggs:
            b.update(recurse(ctx, brows, sub_aggs))
        out.append(b)
    return out


def _one_bucket(ctx, brows, sub_aggs, recurse) -> dict:
    b = {"doc_count": int(len(brows))}
    if sub_aggs:
        b.update(recurse(ctx, brows, sub_aggs))
    return b


def _coerce_missing(mv, tname):
    """A terms `missing` value in the field's type."""
    if tname in ("date", "date_nanos") and isinstance(mv, str):
        try:
            return parse_date_millis(mv)
        except Exception:
            return mv
    if tname in ("long", "integer", "short", "byte"):
        try:
            return int(mv)
        except (TypeError, ValueError):
            raise ParsingError(
                f"failed to parse [missing] value [{mv}] as a long")
    if tname in ("double", "float", "half_float"):
        try:
            return float(mv)
        except (TypeError, ValueError):
            raise ParsingError(
                f"failed to parse [missing] value [{mv}] as a double")
    return mv


def format_terms_keys(buckets: List[dict], tname) -> None:
    """Keys rendered by the field's type: ip integers as addresses,
    booleans as 1 / 0 with `key_as_string`, dates with their ISO string."""
    if tname == "ip":
        for b in buckets:
            b["key"] = _fmt_ip(b["key"])
    elif tname == "boolean":
        for b in buckets:
            truthy = bool(b["key"])
            b["key"] = 1 if truthy else 0
            b["key_as_string"] = "true" if truthy else "false"
    elif tname == "date":
        for b in buckets:
            if isinstance(b["key"], (int, float)):
                b["key_as_string"] = _millis_to_iso(int(b["key"]))


def _fmt_ip(k):
    try:
        return IpFieldMapper.format_value(int(k))
    except (ValueError, TypeError):
        return k


def value_codes(vals: List[Any]) -> Tuple[np.ndarray, List[Any]]:
    """(each value's code, the distinct values in the order of their first
    occurrence), values equal as dict keys sharing a code; plain ints
    group with numpy."""
    if vals and all(type(v) is int for v in vals):
        try:
            arr = np.asarray(vals, dtype=np.int64)
        except OverflowError:
            arr = None
        if arr is not None:
            uniq, first, inverse = np.unique(arr, return_index=True,
                                             return_inverse=True)
            by_first = np.argsort(first, kind="stable")
            remap = np.empty(len(uniq), dtype=np.int64)
            remap[by_first] = np.arange(len(uniq))
            return remap[inverse.reshape(-1)], uniq[by_first].tolist()
    index: Dict[Any, int] = {}
    codes = np.fromiter((index.setdefault(_hashable(v), len(index))
                         for v in vals), dtype=np.int64, count=len(vals))
    return codes, list(index)


class TermGroups:
    """The distinct values over row positions, in the order of their
    first occurrence (`keys`): each value's occurrences (`occ`) and
    distinct rows (`distinct`), its row positions made when asked
    (`rows_of`)."""

    def __init__(self, pos: np.ndarray, vals: List[Any]):
        codes, self.keys = value_codes(vals)
        k = len(self.keys)
        self.occ = np.bincount(codes, minlength=k)
        self.order = np.argsort(codes, kind="stable")
        self.ends = np.cumsum(self.occ)
        self.pos = pos
        if len(np.unique(pos)) == len(pos):
            self.distinct = self.occ
        else:
            # a row holding a value twice counts once
            span = int(pos.max()) + 1
            pairs = np.unique(codes * span + pos)
            self.distinct = np.bincount(pairs // span, minlength=k)

    def rows_of(self, j: int) -> np.ndarray:
        lo = int(self.ends[j] - self.occ[j])
        return np.unique(self.pos[self.order[lo:int(self.ends[j])]])


def _terms(ctx, rows, spec, sub_aggs, recurse, kind="terms") -> dict:
    """terms and rare_terms (the terms of at most `max_doc_count` docs,
    rarest first)."""
    field = spec.get("field")
    size = int(spec.get("size", 10))
    tname = getattr(ctx.mapper_service.get(field), "type_name", None) \
        if field else None
    # an unmapped field aggregates under the caller's value_type
    tname = tname or spec.get("value_type")
    pos, vals = value_arrays(ctx, rows, field)
    missing_val = spec.get("missing")
    if missing_val is not None:
        mv = _coerce_missing(missing_val, tname)
        lack = np.setdiff1d(np.arange(len(rows), dtype=np.int64), pos)
        pos = np.concatenate([pos, lack])
        vals = vals + [mv] * len(lack)
    groups = TermGroups(pos, vals)
    # (key, group index or None for a term of no row)
    items: List[Tuple[Any, Optional[int]]] = list(zip(
        groups.keys, range(len(groups.keys))))
    inc, exc = spec.get("include"), spec.get("exclude")
    if isinstance(inc, dict):
        if exc is not None:
            raise IllegalArgumentError(
                "Cannot specify any excludes when using a partition-based "
                "include")
        part = int(inc.get("partition", 0))
        n_part = int(inc.get("num_partitions", 1))

        def _in_partition(k):
            if isinstance(k, bool):
                h = _mix64(1 if k else 0)
            elif isinstance(k, (int, float)):
                h = _mix64(int(k))
            else:
                h = _murmur3_x86_32(str(k).encode("utf-8"), 31)
            return h % n_part == part
        items = [kv for kv in items if _in_partition(kv[0])]
        inc = None
    if inc is not None or exc is not None:
        def _coerce_list(entries):
            # list entries compare in the field's keyspace: date strings
            # parse to millis
            out = set()
            for x in entries:
                if tname in ("date", "date_nanos"):
                    try:
                        out.add(str(parse_date_millis(x)))
                        continue
                    except Exception:
                        pass
                out.add(str(x))
            return out
        inc_set = _coerce_list(inc) if isinstance(inc, list) else None
        exc_set = _coerce_list(exc) if isinstance(exc, list) else None

        def _passes(k):
            ks = str(_fmt_ip(k) if tname == "ip" else k)
            if isinstance(k, float) and k == int(k):
                ks = str(int(k))
            if inc_set is not None and ks not in inc_set:
                return False
            if isinstance(inc, str) and not re.fullmatch(inc, ks):
                return False
            if exc_set is not None and ks in exc_set:
                return False
            if isinstance(exc, str) and re.fullmatch(exc, ks):
                return False
            return True
        items = [kv for kv in items if _passes(kv[0])]
    if kind == "terms" and int(spec.get("min_doc_count", 1)) == 0:
        # zero-count terms come from the whole index
        if field == "_index":
            universe = {getattr(ctx, "index_name", "index")}
        else:
            universe = {_hashable(v) for v in
                        value_arrays(ctx, ctx.all_rows(), field)[1]}
        kept = {k for k, _ in items}
        for t in universe:
            if t not in kept:
                kept.add(t)
                items.append((t, None))
    # under a nested scope, a field of the path counts each value
    # occurrence (one a nested document), while the sub-aggregations run
    # over the unique parent rows
    scope = getattr(ctx, "nested_path", None)
    counts = groups.occ if scope and isinstance(field, str) \
        and field.startswith(scope + ".") else groups.distinct

    def cnt(kv) -> int:
        return 0 if kv[1] is None else int(counts[kv[1]])

    def rows_of(kv) -> np.ndarray:
        return rows[:0] if kv[1] is None else rows[groups.rows_of(kv[1])]
    order_spec = spec.get("order")
    if kind == "rare_terms":
        max_count = int(spec.get("max_doc_count", 1))
        items = [kv for kv in items if cnt(kv) <= max_count]
        items.sort(key=lambda kv: (cnt(kv), _sort_key(kv[0])))
    elif order_spec and isinstance(order_spec, dict):
        ((okey, odir),) = order_spec.items()
        reverse = odir == "desc"
        if okey == "_key":
            items.sort(key=lambda kv: _sort_key(kv[0]), reverse=reverse)
        elif okey == "_count":
            items.sort(key=lambda kv: (cnt(kv),), reverse=reverse)
        else:
            def metric_val(kv):
                node = recurse(ctx, rows_of(kv), sub_aggs)
                for part in okey.split("."):
                    node = node[part] if isinstance(node, dict) else None
                return node if isinstance(node, (int, float)) \
                    else (node or {}).get("value", 0)
            items.sort(key=metric_val, reverse=reverse)
    else:
        items.sort(key=lambda kv: (-cnt(kv), _sort_key(kv[0])))
    total_other = sum(cnt(kv) for kv in items[size:])
    _check_max_buckets(ctx, min(len(items), size))
    buckets = _bucketize(ctx, sub_aggs,
                         [(kv[0], rows_of(kv)) for kv in items[:size]],
                         recurse)
    for b, kv in zip(buckets, items[:size]):
        b["doc_count"] = cnt(kv)
    format_terms_keys(buckets, tname)
    return {"doc_count_error_upper_bound": 0,
            "sum_other_doc_count": int(total_other), "buckets": buckets}


def _ranges(ctx, rows, kind, spec, sub_aggs, recurse) -> dict:
    field = spec.get("field")
    vals, present = numeric_values(ctx, rows, field, spec.get("missing"))
    mapper = ctx.mapper_service.get(field) if field else None
    date_fmt = mapper.params.get("format", "") if mapper is not None else ""
    if kind == "date_range":
        def conv(x):
            if x is None:
                return None
            if "epoch_second" in str(date_fmt):
                # bounds parse with the field's format: numbers are seconds
                try:
                    return float(x) * 1000.0
                except (TypeError, ValueError):
                    pass
            return float(parse_date_millis(x))
    elif kind == "ip_range":
        def conv(x):
            return float(IpFieldMapper.parse_ip(x)) if x is not None \
                else None
    else:
        def conv(x):
            return float(x) if x is not None else None

    def render_bound(x, numeric):
        # ips as addresses, dates keep the caller's raw bound, numbers as
        # doubles
        if kind == "ip_range":
            return IpFieldMapper.format_value(int(numeric))
        if kind == "date_range":
            return numeric
        return float(numeric)

    buckets = []
    for r in spec.get("ranges", []):
        cidr = r.get("mask")
        if cidr is not None and kind == "ip_range":
            net = ipaddress.ip_network(cidr, strict=False)
            lo = net.network_address
            if lo.version == 4:
                lo = ipaddress.IPv6Address("::ffff:" + str(lo))
            frm = float(int(lo))
            to = frm + float(net.num_addresses)
        else:
            frm = conv(r.get("from"))
            to = conv(r.get("to"))
        mask = present.copy()
        if frm is not None:
            mask &= vals >= frm
        if to is not None:
            mask &= vals < to
        brows = rows[mask]
        key = r.get("key")
        if key is None and cidr is not None:
            key = cidr
        if key is None:
            lo_s = "*" if frm is None else \
                (str(r.get("from")) if kind == "date_range"
                 else render_bound(r.get("from"), frm))
            hi_s = "*" if to is None else \
                (str(r.get("to")) if kind == "date_range"
                 else render_bound(r.get("to"), to))
            key = f"{lo_s}-{hi_s}"
        b = {"key": key, "doc_count": int(len(brows))}
        if frm is not None:
            b["from"] = render_bound(r.get("from"), frm)
        if to is not None:
            b["to"] = render_bound(r.get("to"), to)
        if sub_aggs:
            b.update(recurse(ctx, brows, sub_aggs))
        b["_sort"] = (frm if frm is not None else -np.inf,
                      to if to is not None else np.inf)
        buckets.append(b)
    # ordered by (from, to), not as the caller listed them
    buckets.sort(key=lambda b: b.pop("_sort"))
    return {"buckets": buckets}


def _compute_bucket(ctx: SearchContext, rows: np.ndarray, kind: str,
                    spec: dict, sub_aggs: dict, recurse=None) -> dict:
    """One bucket agg. `recurse` computes sub-agg trees over bucket rows:
    `compute_aggs` for final output, or the partial walker
    (`agg_partials.compute_partial_aggs`)."""
    recurse = recurse or compute_aggs
    field = spec.get("field")
    if kind != "nested":
        # a composite nests under `nested` only
        for sspec in (sub_aggs or {}).values():
            if isinstance(sspec, dict) and "composite" in sspec:
                raise IllegalArgumentError(
                    f"[composite] aggregation cannot be used with a parent "
                    f"aggregation of type: [{kind}]")
    if kind in ("geohash_grid", "geotile_grid"):
        return _geo_grid(ctx, rows, kind, spec, sub_aggs, recurse)
    if kind in ("significant_terms", "significant_text"):
        return _significant(ctx, rows, kind, spec, sub_aggs, recurse)
    if kind == "rare_terms":
        return _terms(ctx, rows, spec, sub_aggs, recurse, kind="rare_terms")
    if kind == "auto_date_histogram":
        return _auto_date_histogram(ctx, rows, spec, sub_aggs, recurse)
    if kind == "sampler":
        return _one_bucket(ctx, rows[:int(spec.get("shard_size", 100))],
                           sub_aggs, recurse)
    if kind == "composite":
        return _composite(ctx, rows, spec, sub_aggs, recurse)
    if kind == "adjacency_matrix":
        return _adjacency_matrix(ctx, rows, spec, sub_aggs, recurse)
    if kind == "filter":
        match = parse_query(spec).execute(ctx).rows
        return _one_bucket(ctx, rows[np.isin(rows, match)], sub_aggs,
                           recurse)
    if kind == "filters":
        filters = spec.get("filters", {})
        if not filters:
            raise IllegalArgumentError("[filters] cannot be empty")
        named = isinstance(filters, dict)
        buckets = {} if named else []
        for key, qspec in (filters.items() if named else enumerate(filters)):
            match = parse_query(qspec).execute(ctx).rows
            b = _one_bucket(ctx, rows[np.isin(rows, match)], sub_aggs,
                            recurse)
            if named:
                buckets[key] = b
            else:
                buckets.append(b)
        return {"buckets": buckets}
    if kind == "global":
        return _one_bucket(ctx, ctx.all_rows(), sub_aggs, recurse)
    if kind == "missing":
        if spec.get("missing") is not None:
            brows = rows[:0]    # a substitute means no doc is missing
        else:
            brows = rows[np.asarray(
                [v is None for v in raw_values(ctx, rows, field).tolist()],
                dtype=bool)]
        return _one_bucket(ctx, brows, sub_aggs, recurse)
    if kind == "terms":
        return _terms(ctx, rows, spec, sub_aggs, recurse)
    if kind == "histogram":
        interval = float(spec["interval"])
        offset = float(spec.get("offset", 0.0))
        vals, present = numeric_values(ctx, rows, field, spec.get("missing"))
        keys = np.floor((vals - offset) / interval) * interval + offset
        out = _histo_buckets(ctx, rows, sub_aggs, keys, present,
                             int(spec.get("min_doc_count", 0)),
                             spec.get("extended_bounds"), interval,
                             recurse=recurse)
        fmt = spec.get("format")
        if fmt:
            for b in out["buckets"]:
                b["key_as_string"] = _decimal_format(b["key"], fmt)
        return out
    if kind == "date_histogram":
        interval_ms, calendar = _date_interval(spec)
        mapper = ctx.mapper_service.get(field)
        if isinstance(mapper, RangeFieldMapperBase):
            return _range_field_histo(ctx, rows, sub_aggs, spec, field,
                                      recurse)
        vals, present = numeric_values(ctx, rows, field)
        if getattr(mapper, "type_name", None) == "date_nanos":
            vals = vals / 1e6  # stored nanos; buckets in millis
        offset_ms = _date_offset_ms(spec.get("offset"))
        tz = _resolve_tz(spec.get("time_zone"))
        if calendar:
            keys = calendar_keys(vals, present, offset_ms, calendar, tz)
        else:
            keys = np.floor((vals - offset_ms) / interval_ms) * interval_ms \
                + offset_ms
        return _histo_buckets(ctx, rows, sub_aggs, keys, present,
                              int(spec.get("min_doc_count", 0)), None,
                              interval_ms, date=True, recurse=recurse,
                              fmt=spec.get("format"), tz=tz)
    if kind in ("range", "date_range", "ip_range"):
        return _ranges(ctx, rows, kind, spec, sub_aggs, recurse)
    if kind == "nested":
        # the rows stay the parents' (nested objects are stored in their
        # parent); doc_count counts the nested objects
        path = spec.get("path")
        b = {"doc_count": count_nested_docs(ctx, rows, path)}
        if sub_aggs:
            prev = getattr(ctx, "nested_path", None)
            ctx.nested_path = path
            try:
                b.update(recurse(ctx, rows, sub_aggs))
            finally:
                ctx.nested_path = prev
        return b
    if kind == "reverse_nested":
        cur = getattr(ctx, "nested_path", None)
        if cur is None:
            raise ParsingError(
                "Reverse nested aggregation must be used inside a [nested] "
                "aggregation")
        target = spec.get("path")
        if target is not None and not cur.startswith(target + "."):
            raise ParsingError(
                f"Invalid path [{target}] for reverse_nested aggregation: "
                f"not an ancestor of the current nested scope [{cur}]")
        b = {"doc_count": int(len(rows))} if target is None else \
            {"doc_count": count_nested_docs(ctx, rows, target)}
        if sub_aggs:
            ctx.nested_path = target
            try:
                b.update(recurse(ctx, rows, sub_aggs))
            finally:
                ctx.nested_path = cur
        return b
    raise ParsingError(f"unknown bucket aggregation [{kind}]")


# ------------------------------------------------------------------- geo

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash_encode(lat: float, lon: float, precision: int) -> str:
    """The base-32 geohash of a point: alternate longitude / latitude
    bisections, five bits a character."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits: List[int] = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    return "".join(_BASE32[int("".join(map(str, bits[i:i + 5])), 2)]
                   for i in range(0, len(bits), 5))


def geotile_encode(lat: float, lon: float, precision: int) -> str:
    """The z/x/y web-map tile of a point (latitudes clamped to the
    Mercator range)."""
    n = 2 ** precision
    x = int((lon + 180.0) / 360.0 * n)
    lat_r = math.radians(max(min(lat, 85.05112878), -85.05112878))
    y = int((1.0 - math.log(math.tan(lat_r) + 1 / math.cos(lat_r))
             / math.pi) / 2.0 * n)
    return f"{precision}/{min(max(x, 0), n - 1)}/{min(max(y, 0), n - 1)}"


def _point_cells(lats: np.ndarray, lons: np.ndarray, encode,
                 precision: int) -> Tuple[List[str], np.ndarray]:
    """(the distinct cell keys, each point's index into them): each
    distinct point encoded once."""
    if not len(lats):
        return [], np.zeros(0, dtype=np.int64)
    ulat, ilat = np.unique(lats, return_inverse=True)
    ulon, ilon = np.unique(lons, return_inverse=True)
    pair = ilat.reshape(-1).astype(np.int64) * len(ulon) \
        + ilon.reshape(-1)
    upair, ipair = np.unique(pair, return_inverse=True)
    index: Dict[str, int] = {}
    cell = np.asarray([index.setdefault(encode(float(ulat[p // len(ulon)]),
                                               float(ulon[p % len(ulon)]),
                                               precision), len(index))
                       for p in upair.tolist()], dtype=np.int64)
    return list(index), cell[ipair.reshape(-1)]


def encode_points(lats: np.ndarray, lons: np.ndarray, encode,
                  precision: int) -> List[str]:
    """Each point's cell key."""
    keys, cell = _point_cells(lats, lons, encode, precision)
    return [keys[c] for c in cell.tolist()]


def _geo_grid(ctx, rows, kind, spec, sub_aggs, recurse) -> dict:
    """geohash_grid / geotile_grid: the cells of the points, most points
    first, then by key; a cell's bucket holds its distinct rows."""
    precision = int(spec.get("precision",
                             5 if kind == "geohash_grid" else 7))
    encode = geohash_encode if kind == "geohash_grid" else geotile_encode
    pos, lats, lons = geo_point_values(ctx, rows, spec.get("field"))
    keys, cell = _point_cells(lats, lons, encode, precision)
    points = np.bincount(cell, minlength=len(keys))
    order = np.argsort(cell, kind="stable")
    ends = np.cumsum(points)
    size = int(spec.get("size", 10000))
    buckets = []
    for c in sorted(range(len(keys)),
                    key=lambda c: (-int(points[c]), keys[c]))[:size]:
        at = pos[order[int(ends[c] - points[c]):int(ends[c])]]
        brows = np.unique(rows[at])
        b = {"key": keys[c], "doc_count": int(len(brows))}
        if sub_aggs:
            b.update(recurse(ctx, brows, sub_aggs))
        buckets.append(b)
    return {"buckets": buckets}


# ---------------------------------------------------------- significant

SIG_KNOWN_FIELDS = ["field", "size", "shard_size", "min_doc_count",
                    "shard_min_doc_count", "background_filter", "include",
                    "exclude", "execution_hint", "jlh", "gnd", "chi_square",
                    "mutual_information", "percentage", "script_heuristic",
                    "filter_duplicate_text", "source_fields", "missing"]


def _terms_per_doc(ctx, doc_rows: np.ndarray, field, mapper,
                   use_dedup: bool = False) -> List[set]:
    """Each row's set of terms, its source text analysed (a 6-gram seen in
    an earlier document dropped when `filter_duplicate_text`)."""
    seen: set = set()
    out = []
    for row in doc_rows.tolist():
        node = ctx.reader.get_source(int(row)) or {}
        for part in str(field).split("."):
            node = node.get(part) if isinstance(node, dict) else None
        tokens: List[str] = []
        for v in (node if isinstance(node, list) else [node]):
            if v is None:
                continue
            if mapper is not None and hasattr(mapper, "analyze"):
                tokens.extend(mapper.analyze(str(v)))
            else:
                tokens.extend(str(v).lower().split())
        if use_dedup and len(tokens) >= 6:
            dup = [False] * len(tokens)
            for p in range(len(tokens) - 5):
                if tuple(tokens[p:p + 6]) in seen:
                    for q in range(p, p + 6):
                        dup[q] = True
            for p in range(len(tokens) - 5):
                seen.add(tuple(tokens[p:p + 6]))
            tokens = [t for t, d in zip(tokens, dup) if not d]
        out.append(set(tokens))
    return out


def _doc_term_counts(ctx, doc_rows: np.ndarray, field, mapper,
                     analyzed: bool, use_dedup: bool = False):
    """({term: the docs holding it}, term -> those docs' rows ascending)
    over doc_rows; doc values group with `TermGroups`."""
    if not analyzed:
        groups = TermGroups(*value_arrays(ctx, doc_rows, field))
        where = {k: j for j, k in enumerate(groups.keys)}
        return (dict(zip(groups.keys, groups.distinct.tolist())),
                lambda t: np.unique(doc_rows[groups.rows_of(where[t])]))
    count: Dict[Any, int] = {}
    rows_by_term: Dict[Any, List[int]] = {}
    for row, terms in zip(doc_rows.tolist(), _terms_per_doc(
            ctx, doc_rows, field, mapper, use_dedup)):
        for t in terms:
            count[t] = count.get(t, 0) + 1
            rows_by_term.setdefault(t, []).append(row)
    return count, lambda t: np.asarray(sorted(set(rows_by_term[t])),
                                       dtype=np.int64)


def jlh(fg: int, fg_total: int, bg: int, bg_total: int) -> Optional[float]:
    """The JLH score of a term, None when it is not more frequent in the
    foreground than in the background."""
    fg_freq = fg / fg_total if fg_total else 0.0
    bg_freq = bg / bg_total if bg_total else 0.0
    if fg_freq <= bg_freq or bg_freq == 0:
        return None
    return (fg_freq - bg_freq) * (fg_freq / bg_freq)


def _significant(ctx, rows, kind, spec, sub_aggs, recurse) -> dict:
    """significant_terms / significant_text: the foreground's terms scored
    by JLH against their counts over the whole index (kept on the
    context for the request)."""
    field = spec.get("field")
    size = int(spec.get("size", 10))
    min_count = int(spec.get("min_doc_count", 3))
    mapper = ctx.mapper_service.get(field)
    tname = getattr(mapper, "type_name", None)
    analyzed = kind == "significant_text" or tname == "text"
    fg_count, fg_rows = _doc_term_counts(
        ctx, rows, field, mapper, analyzed,
        bool(spec.get("filter_duplicate_text")))
    fg_total = len(rows)
    bg_cache = ctx.__dict__.setdefault("_sig_bg_cache", {})
    bg_key = (str(field), analyzed)
    if bg_key not in bg_cache:
        bg_rows = ctx.all_rows()
        bg_cache[bg_key] = (_doc_term_counts(ctx, bg_rows, field, mapper,
                                             analyzed)[0], len(bg_rows))
    bg_count, bg_total = bg_cache[bg_key]
    scored = []
    for t, fg in fg_count.items():
        if fg < min_count:
            continue
        bg = bg_count.get(t, fg)
        score = jlh(fg, fg_total, bg, bg_total)
        if score is not None:
            scored.append((score, t, fg, bg))
    scored.sort(key=lambda x: (-x[0], _sort_key(x[1])))
    inc, exc = spec.get("include"), spec.get("exclude")
    buckets = []
    for score, t, fg, bg in scored:
        if len(buckets) >= size:
            break
        key = t
        if tname == "ip" and isinstance(t, (int, float)):
            key = IpFieldMapper.format_value(int(t))
        ks = str(key)
        if isinstance(inc, list) and ks not in {str(x) for x in inc}:
            continue
        if isinstance(exc, list) and ks in {str(x) for x in exc}:
            continue
        if isinstance(inc, str) and not re.fullmatch(inc, ks):
            continue
        if isinstance(exc, str) and re.fullmatch(exc, ks):
            continue
        b = {"key": key, "doc_count": fg, "score": score, "bg_count": bg}
        if tname == "date" and isinstance(t, (int, float)):
            b["key_as_string"] = _millis_to_iso(int(t))
        if sub_aggs:
            b.update(recurse(ctx, fg_rows(t), sub_aggs))
        buckets.append(b)
    return {"doc_count": fg_total, "bg_count": bg_total, "buckets": buckets}


# ---------------------------------------------------- other bucket kinds

AUTO_UNITS = (1, 1000, 60_000, 3_600_000, 86_400_000, 2_592_000_000,
              31_536_000_000)


def _auto_date_histogram(ctx, rows, spec, sub_aggs, recurse) -> dict:
    """A date histogram whose interval is the first unit at least the
    span over the target bucket count."""
    target = int(spec.get("buckets", 10))
    vals, present = numeric_values(ctx, rows, spec.get("field"))
    v = vals[present]
    if len(v) == 0:
        return {"buckets": [], "interval": "1ms"}
    interval_ms = max(max(v.max() - v.min(), 1.0) / target, 1.0)
    for unit in AUTO_UNITS:
        if interval_ms <= unit:
            interval_ms = unit
            break
    keys = np.floor(vals / interval_ms) * interval_ms
    out = _histo_buckets(ctx, rows, sub_aggs, keys, present, 0, None,
                         interval_ms, date=True, recurse=recurse)
    out["interval"] = f"{int(interval_ms)}ms"
    return out


def _adjacency_matrix(ctx, rows, spec, sub_aggs, recurse) -> dict:
    """Each filter's bucket and each pair's intersection, by name; empty
    ones left out."""
    matches = {name: parse_query(q).execute(ctx).rows
               for name, q in spec.get("filters", {}).items()}
    names = sorted(matches)
    buckets = []
    for i, a in enumerate(names):
        ra = rows[np.isin(rows, matches[a])]
        if len(ra):
            buckets.append({"key": a, **_one_bucket(ctx, ra, sub_aggs,
                                                    recurse)})
        for bname in names[i + 1:]:
            rb = ra[np.isin(ra, matches[bname])]
            if len(rb):
                buckets.append({"key": f"{a}&{bname}",
                                **_one_bucket(ctx, rb, sub_aggs, recurse)})
    return {"buckets": buckets}


# ------------------------------------------------------------ composite

class _Source:
    """One composite source over the rows: a value code a row (-1 for
    none) into its distinct `values`, or for a source holding several
    values a row, `lists` (row -> its values); its date `format` and
    type."""

    def __init__(self, stype: str, n: int):
        self.stype = stype
        self.codes = np.full(n, -1, dtype=np.int64)
        self.values: List[Any] = []
        self.lists: Optional[Dict[int, list]] = None
        self.fmt = None

    def set_values(self, pos: np.ndarray, vals: List[Any]) -> None:
        """Row positions and their values: codes when each row holds one,
        else lists."""
        if len(np.unique(pos)) < len(pos):
            self.lists = {}
            for p, v in zip(pos.tolist(), vals):
                self.lists.setdefault(p, []).append(v)
            return
        self.codes[pos], self.values = value_codes(vals)

    def add_missing(self) -> None:
        """`missing_bucket`: a row without a value holds None."""
        if self.lists is not None:
            for i in range(len(self.codes)):
                self.lists.setdefault(i, [None])
            return
        lack = self.codes < 0
        if lack.any():
            self.codes[lack] = len(self.values)
            self.values.append(None)

    def row_values(self, i: int) -> list:
        if self.lists is not None:
            return self.lists.get(i) or []
        c = int(self.codes[i])
        return [] if c < 0 else [self.values[c]]


def _composite_source(ctx, rows, stype, sspec, pos: int,
                      tzs: dict) -> _Source:
    src = _Source(stype, len(rows))
    if stype == "terms":
        field = sspec["field"]
        at, vals = value_arrays(ctx, rows, field)
        src.set_values(at, vals)
        if getattr(ctx.mapper_service.get(field), "type_name",
                   None) == "ip":
            def text(v):
                return IpFieldMapper.format_value(int(v)) \
                    if isinstance(v, (int, float)) else v
            if src.lists is not None:
                src.lists = {i: [text(v) for v in vl]
                             for i, vl in src.lists.items()}
            else:
                src.values = [text(v) for v in src.values]
        return src
    if stype in ("histogram", "date_histogram"):
        vals, present = numeric_values(ctx, rows, sspec["field"])
        if stype == "histogram":
            interval = float(sspec["interval"])
            keys = np.floor(vals / interval) * interval
        else:
            if getattr(ctx.mapper_service.get(sspec["field"]), "type_name",
                       None) == "date_nanos":
                vals = vals / 1e6
            ims, cal = _date_interval(sspec)
            off = _date_offset_ms(sspec.get("offset"))
            src.fmt = sspec.get("format")
            tz = _resolve_tz(sspec.get("time_zone"))
            if tz is not None:
                tzs[pos] = tz
            ints = np.trunc(np.where(present, vals, 0.0))
            if cal:
                keys = np.zeros(len(rows))
                if present.any():
                    uniq, inverse = np.unique(ints[present],
                                              return_inverse=True)
                    floors = np.asarray(
                        [_calendar_floor(int(u) - off, cal, tz) + off
                         for u in uniq.tolist()], dtype=np.float64)
                    keys[present] = floors[inverse.reshape(-1)]
            else:
                keys = np.floor((ints - off) / ims) * ims + off
        if present.any():
            uniq, inverse = np.unique(keys[present], return_inverse=True)
            src.codes[present] = inverse.reshape(-1)
            src.values = uniq.tolist()
        return src
    if stype == "geotile_grid":
        ppos, lats, lons = geo_point_values(ctx, rows, sspec["field"])
        src.set_values(ppos, encode_points(
            lats, lons, geotile_encode, int(sspec.get("precision", 7))))
        return src
    raise IllegalArgumentError(f"unknown composite source type [{stype}]")


def _composite_after(after: dict, names, formats, tzs) -> list:
    """The `after` key's values in the sources' domains: a formatted date
    parses back to millis, a local one read in the source's time zone."""
    out = []
    for p, n in enumerate(names):
        v = after.get(n)
        if formats[p] and isinstance(v, str):
            try:
                raw = v
                v = float(parse_date_millis(v))
                tz = tzs.get(p)
                has_offset = raw.endswith("Z") or bool(
                    re.search(r"[+-]\d\d:?\d\d$", raw))
                if tz is not None and not has_offset:
                    at = dt.datetime.fromtimestamp(v / 1000.0,
                                                   dt.timezone.utc)
                    v -= tz.utcoffset(at).total_seconds() * 1000.0
            except Exception:
                pass
        out.append(v)
    return out


def _value_order(s: _Source, pos: int, rank_one) -> List[int]:
    """A source's value codes ordered by their sort keys: strings by
    their text, numbers by their value, with numpy; others by
    `rank_one`."""
    vals = s.values
    if s.stype != "geotile_grid" and vals:
        if all(type(v) is str for v in vals):
            return np.argsort(np.asarray(vals), kind="stable").tolist()
        if all(type(v) in (int, float) for v in vals):
            arr = np.asarray(vals, dtype=np.float64)
            if not np.isnan(arr).any() and np.abs(arr).max() < 2.0 ** 53:
                return np.argsort(arr, kind="stable").tolist()
    return sorted(range(len(vals)), key=lambda c: rank_one(vals[c], pos))


def _composite_groups(srcs: List[_Source], n: int, rank, rank_one):
    """The combinations the rows hold in the order of `rank`, as (their
    count, key(i), rows(i)): grouped with numpy when each source holds
    one value a row (the combinations first ordered by first
    occurrence, as a dict fills), else row by row over the product of the
    values."""
    if any(s.lists is not None for s in srcs):
        keyed: Dict[tuple, List[int]] = {}
        for i in range(n):
            value_lists = [s.row_values(i) for s in srcs]
            if any(not vl for vl in value_lists):
                continue
            for key in itertools.product(*value_lists):
                keyed.setdefault(key, []).append(i)
        items = sorted(keyed.items(), key=lambda kv: rank(kv[0]))
        return (len(items), lambda i: items[i][0],
                lambda i: np.asarray(sorted(set(items[i][1])),
                                     dtype=np.int64))
    codes = np.stack([s.codes for s in srcs], axis=1)
    at = np.nonzero((codes >= 0).all(axis=1))[0]
    if not len(at):
        return 0, None, None
    codes = codes[at]
    radix = [max(len(s.values), 1) for s in srcs]
    if math.prod(radix) < 2 ** 62:
        flat = np.zeros(len(at), dtype=np.int64)
        for p, r in enumerate(radix):
            flat = flat * r + codes[:, p]
        _, first, inverse = np.unique(flat, return_index=True,
                                      return_inverse=True)
        uniq = codes[first]
    else:
        uniq, first, inverse = np.unique(codes, axis=0, return_index=True,
                                         return_inverse=True)
    inverse = inverse.reshape(-1)
    base = np.argsort(first, kind="stable")
    # each source's value order by its sort key, then the combinations
    # by their sources' orders
    ranks = []
    for p, s in enumerate(srcs):
        r = np.empty(len(s.values), dtype=np.int64)
        r[np.asarray(_value_order(s, p, rank_one), dtype=np.int64)] = \
            np.arange(len(s.values))
        ranks.append(r[uniq[base, p]])
    order = base[np.lexsort(ranks[::-1])]
    counts = np.bincount(inverse, minlength=len(uniq))
    grouped = at[np.argsort(inverse, kind="stable")]
    ends = np.cumsum(counts)

    def key(i):
        return tuple(s.values[c]
                     for s, c in zip(srcs, uniq[order[i]].tolist()))

    def rows_of(i):
        j = order[i]
        return grouped[int(ends[j] - counts[j]):int(ends[j])]
    return len(order), key, rows_of


def _composite(ctx, rows, spec, sub_aggs, recurse) -> dict:
    """composite: the buckets of every combination of its sources' values
    (a multi-valued doc in each of its combinations), in the sources'
    order, `size` a page after the `after` key."""
    sources = spec.get("sources", [])
    if not sources:
        raise IllegalArgumentError(
            "Required [sources]: Composite [sources] cannot be null or "
            "empty")
    size = int(spec.get("size", 10))
    max_b = getattr(ctx, "max_buckets", None) or MAX_BUCKETS
    if size > max_b:
        raise TooManyBucketsError(
            f"Trying to create too many buckets. Must be less than or "
            f"equal to: [{max_b}] but was [{size}]. This limit can be set "
            f"by changing the [search.max_buckets] cluster level setting.")
    names: List[str] = []
    tzs: Dict[int, Any] = {}
    srcs: List[_Source] = []
    for src in sources:
        ((sname, sdef),) = src.items()
        if sname in names:
            raise IllegalArgumentError(
                f"Composite source names must be unique, found "
                f"duplicates: [{sname}]")
        names.append(sname)
        ((stype, sspec),) = sdef.items()
        s = _composite_source(ctx, rows, stype, sspec, len(names) - 1, tzs)
        if sspec.get("missing_bucket"):
            s.add_missing()
        srcs.append(s)
    formats = [s.fmt for s in srcs]

    def rank_one(value, pos):
        # a geotile "z/x/y" orders by its coordinates
        if srcs[pos].stype == "geotile_grid" and isinstance(value, str):
            try:
                return (0,) + tuple(int(p) for p in value.split("/"))
            except ValueError:
                pass
        return _sort_key(value)

    def rank(key):
        return tuple(rank_one(k, p) for p, k in enumerate(key))
    count, key_of, rows_of = _composite_groups(srcs, len(rows), rank,
                                               rank_one)
    after = spec.get("after")
    start = 0
    if after is not None:
        after_rank = rank(_composite_after(after, names, formats, tzs))
        start = bisect.bisect_right(range(count), after_rank,
                                    key=lambda i: rank(key_of(i)))
    items = [(key_of(i), rows_of(i))
             for i in range(start, min(start + size, count))]

    def render(key):
        out_key = {}
        for p, (nm, k, fmt) in enumerate(zip(names, key, formats)):
            if fmt and isinstance(k, (int, float)):
                out_key[nm] = _format_date_key(int(k), fmt, tz=tzs.get(p))
            elif isinstance(k, float) and k.is_integer():
                out_key[nm] = int(k)
            else:
                out_key[nm] = k
        return out_key

    buckets = []
    for key, at in items:
        b = {"key": render(key), "doc_count": int(len(at))}
        if sub_aggs:
            b.update(recurse(ctx, rows[at], sub_aggs))
        buckets.append(b)
    out: Dict[str, Any] = {"buckets": buckets}
    if buckets:
        out["after_key"] = buckets[-1]["key"]
    return out


# -------------------------------------------------------------- top_hits

def _walk(obj, path: str):
    cur = obj
    for p in path.split("."):
        cur = cur.get(p) if isinstance(cur, dict) else None
    return cur


def _sorted_entries(entries: list, reverse: bool) -> list:
    """Entries with a sort value first (numbers before strings, in the
    order asked), those without after them in their order."""
    present = [e for e in entries if e[0] is not None]
    absent = [e for e in entries if e[0] is None]
    present.sort(key=lambda e: (isinstance(e[0], str), e[0]),
                 reverse=reverse)
    return present + absent


def _numeric_order(dvs: list, reverse: bool):
    """(the stable order, the first values) of sort values that are all
    numbers exact in f64, the order `_sorted_entries` gives them; None
    for any other values."""
    firsts = [v[0] if isinstance(v, list) and v else v for v in dvs]
    if not all(type(x) in (int, float) for x in firsts):
        return None
    arr = np.asarray(firsts, dtype=np.float64)
    if len(arr) and (np.isnan(arr).any() or np.abs(arr).max() >= 2.0 ** 53):
        return None
    return np.argsort(-arr if reverse else arr, kind="stable"), firsts


def _nested_entries(ctx, rows, path: str, rel: str) -> list:
    """(sort value, row, offset, object) of every object at a nested path
    of the rows: a top-level path from the segment's cached objects
    (`queries_ext._nested_objects`), a dotted one walked in each
    source."""
    entries = []
    if "." in path:
        for row in rows.tolist():
            items = _walk(ctx.reader.get_source(int(row)) or {}, path)
            if isinstance(items, dict):
                items = [items]
            for off, item in enumerate(items or []):
                if isinstance(item, dict):
                    entries.append((_walk(item, rel), int(row), off, item))
        return entries
    from elasticsearch_tpu_torch.search.queries_ext import _nested_objects
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows):
        return entries
    vi, local = ctx.reader.locate_many(rows)
    for row, v, loc in zip(rows.tolist(), vi.tolist(), local.tolist()):
        seg = ctx.reader.views[v].segment
        objs = _nested_objects(seg, path)
        lo, hi = np.searchsorted(objs.locals_, [loc, loc + 1])
        for off, j in enumerate(range(int(lo), int(hi))):
            item = objs.objs[j]
            entries.append((_walk(item, rel), int(row), off, item))
    return entries


def top_hits(ctx: SearchContext, rows: np.ndarray, spec: dict) -> dict:
    """The bucket's first `size` documents by the sort (a nested sort
    path takes each document's least, or greatest, nested value), with
    `_seq_no` / `_primary_term` when asked. Directly under a `nested`
    aggregation and sorted by a field under its path, the hits are the
    nested objects, each with its parent's `_id` and a `_nested`
    locator."""
    size = int(spec.get("size", 3))
    index_name = getattr(ctx, "index_name", "index")
    nested_ctx = getattr(ctx, "nested_path", None)

    def parse_sort(ss):
        if isinstance(ss, str):
            return ss, "asc", None
        if isinstance(ss, list) and ss:
            return parse_sort(ss[0])
        if isinstance(ss, dict) and ss:
            ((f, o),) = list(ss.items())[:1]
            if isinstance(o, dict):
                return f, o.get("order", "asc"), \
                    (o.get("nested") or {}).get("path")
            return f, str(o), None
        return None, "asc", None

    sfield, sorder, sort_nested = parse_sort(spec.get("sort"))
    if sfield and sfield.endswith(".keyword"):
        sfield = sfield[: -len(".keyword")]
    reverse = sorder == "desc"
    if nested_ctx and sfield and sfield.startswith(nested_ctx + "."):
        entries = _sorted_entries(_nested_entries(
            ctx, rows, nested_ctx, sfield[len(nested_ctx) + 1:]), reverse)
        hits = [{"_index": index_name, "_id": ctx.reader.get_id(row),
                 "_nested": {"field": nested_ctx, "offset": off},
                 "_source": item, "_score": None, "sort": [val]}
                for val, row, off, item in entries[:size]]
        return {"hits": {"total": {"value": len(entries), "relation": "eq"},
                         "max_score": None, "hits": hits}}
    entries = []
    dvs = raw_values(ctx, rows, sfield).tolist() \
        if sfield and not sort_nested else None
    fast = _numeric_order(dvs, reverse) if dvs is not None else None
    if fast is not None:
        order, firsts = fast
        entries = [(firsts[i], int(rows[i])) for i in order[:size].tolist()]
    for i, row in enumerate(rows.tolist() if fast is None else ()):
        key = None
        if sfield:
            if dvs is not None and dvs[i] is not None:
                dv = dvs[i]
                entries.append((dv[0] if isinstance(dv, list) and dv
                                else dv, int(row)))
                continue
            src = ctx.reader.get_source(int(row)) or {}
            if sort_nested and sfield.startswith(sort_nested + "."):
                items = _walk(src, sort_nested)
                if isinstance(items, dict):
                    items = [items]
                vals = [_walk(it, sfield[len(sort_nested) + 1:])
                        for it in items or [] if isinstance(it, dict)]
                vals = [v for v in vals if v is not None]
                key = (max(vals) if reverse else min(vals)) if vals \
                    else None
            else:
                key = _walk(src, sfield)
                if isinstance(key, list):
                    key = key[0] if key else None
        entries.append((key, int(row)))
    if sfield and fast is None:
        entries = _sorted_entries(entries, reverse)
    hits = []
    for key, row in entries[:size]:
        h = {"_index": index_name, "_id": ctx.reader.get_id(row),
             "_source": ctx.reader.get_source(row), "_score": None}
        if sfield:
            h["sort"] = [key]
        if spec.get("seq_no_primary_term"):
            sq = ctx.reader.get_seq_no(row)
            h["_seq_no"] = int(sq) if sq is not None else 0
            h["_primary_term"] = 1
        hits.append(h)
    return {"hits": {"total": {"value": len(rows), "relation": "eq"},
                     "max_score": None, "hits": hits}}


def _nested_counts(seg, path: str) -> np.ndarray:
    """The values (not None) at `path` in each document of a segment,
    list-aware at every level, read from the sources once and kept with
    the segment."""
    key = ("nested_count", path)
    got = seg.derived.get(key)
    if got is None:
        from elasticsearch_tpu_torch.search.queries_ext import _values_at
        whole = path in seg.vectors or path in seg.tokens
        got = np.zeros(seg.num_docs, dtype=np.int64)
        for local in range(seg.num_docs):
            src = seg.source(local) if whole else (seg.sources[local] or {})
            got[local] = sum(1 for it in _values_at(src, path)
                             if it is not None)
        seg.derived[key] = got
    return got


def count_nested_docs(ctx: SearchContext, rows: np.ndarray,
                      path: Optional[str]) -> int:
    """The nested documents at `path` over rows: the values at the path
    in each row's source (`comments.replies` counts the replies of every
    comment); the rows themselves when there is no path."""
    if not path:
        return int(len(rows))
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows):
        return 0
    total = 0
    vi, local = ctx.reader.locate_many(rows)
    for v in np.unique(vi).tolist():
        counts = _nested_counts(ctx.reader.views[v].segment, path)
        total += int(counts[local[vi == v]].sum())
    return total


def calendar_keys(vals, present, offset_ms, unit, tz) -> np.ndarray:
    """Each present value's calendar bucket key, `_calendar_floor` of its
    offset-shifted millis truncated toward zero (NaN when absent). The
    floor runs once a distinct millisecond."""
    keys = np.full(len(vals), np.nan, dtype=np.float64)
    if not present.any():
        return keys
    shifted = np.trunc(vals[present] - offset_ms)
    uniq, inverse = np.unique(shifted, return_inverse=True)
    floors = np.asarray([_calendar_floor(int(u), unit, tz) + offset_ms
                         for u in uniq.tolist()], dtype=np.float64)
    keys[present] = floors[inverse.reshape(-1)]
    return keys


def _range_field_histo(ctx, rows, sub_aggs, spec, field, recurse) -> dict:
    """date_histogram over a date_range field: a doc counts in every bucket
    its range overlaps."""
    interval_ms, calendar = _date_interval(spec)
    offset_ms = _date_offset_ms(spec.get("offset"))
    tz = _resolve_tz(spec.get("time_zone"))
    fmt = spec.get("format")
    groups: Dict[float, List[int]] = {}

    def floor_of(ms):
        if calendar:
            return _calendar_floor(int(ms - offset_ms), calendar) + offset_ms
        return float(np.floor((ms - offset_ms) / interval_ms) * interval_ms
                     + offset_ms)

    for row, v in zip(rows.tolist(), raw_values(ctx, rows, field).tolist()):
        if isinstance(v, list):
            v = v[0] if v else None
        if not isinstance(v, dict):
            continue
        lo = float(v.get("gte", np.nan))
        hi = float(v.get("lte", np.nan))
        if not (np.isfinite(lo) and np.isfinite(hi)):
            continue
        cur = floor_of(lo)
        end = floor_of(hi)
        guard = 0
        while cur <= end and guard < 100_000:
            groups.setdefault(float(cur), []).append(int(row))
            guard += 1
            if calendar:
                # calendar units vary in length: probe until the floor moves
                step = cur + interval_ms / 2
                while floor_of(step) <= cur and guard < 100_000:
                    step += 86_400_000
                    guard += 1
                cur = floor_of(step)
            else:
                cur += interval_ms
    _check_max_buckets(ctx, len(groups))
    buckets = []
    for key in sorted(groups):
        brows = np.asarray(sorted(set(groups[key])), dtype=np.int64)
        b = {"key": int(key), "doc_count": int(len(brows)),
             "key_as_string": _format_date_key(int(key), fmt, tz) if fmt
             else _millis_to_iso_tz(int(key), tz)}
        if sub_aggs:
            b.update(recurse(ctx, brows, sub_aggs))
        buckets.append(b)
    return {"buckets": buckets}


def _decimal_format(value, pattern: str) -> str:
    """Minimal Java DecimalFormat: a literal prefix and suffix around a #/0
    run with optional fraction digits ("Value is ##0.0" -> "Value is
    51.0")."""
    m = re.search(r"[#0][#0,.]*", pattern)
    if not m:
        return pattern
    num = m.group(0)
    prefix, suffix = pattern[:m.start()], pattern[m.end():]
    if "." in num:
        frac = num.split(".", 1)[1]
        min_frac, max_frac = frac.count("0"), len(frac)
    else:
        min_frac = max_frac = 0
    v = float(value)
    if max_frac == 0:
        s = str(int(round(v)))
    else:
        s = f"{v:.{max_frac}f}"
        int_part, frac_part = s.split(".")
        frac_part = frac_part.rstrip("0").ljust(min_frac, "0")
        s = int_part + ("." + frac_part if frac_part else "")
    return prefix + s + suffix


def _check_max_buckets(ctx, n: int) -> None:
    """search.max_buckets (None: no limit but the histogram span's)."""
    mx = getattr(ctx, "max_buckets", None)
    if mx is not None and n > mx:
        raise TooManyBucketsError(
            f"Trying to create too many buckets. Must be less than or "
            f"equal to: [{mx}] but was [{n}]. This limit can be set by "
            f"changing the [search.max_buckets] cluster level setting.")


def _guard_span(lo_key, hi_key, interval) -> None:
    if interval and (hi_key - lo_key) / interval > MAX_BUCKETS:
        raise IllegalArgumentError(
            f"Trying to create too many buckets. Must be less than or "
            f"equal to: [{MAX_BUCKETS}].")


def fill_histo_keys(all_keys: list, extended_bounds, interval,
                    min_count: int) -> list:
    """The bucket keys a histogram renders: the keys that hold rows, then
    every interval step between them when `min_doc_count` is 0, or over
    `extended_bounds`."""
    if extended_bounds and interval:
        lo = float(extended_bounds.get("min", np.inf))
        hi = float(extended_bounds.get("max", -np.inf))
        k = min([lo] + all_keys) if all_keys or lo != np.inf else lo
        top = max([hi] + all_keys) if all_keys or hi != -np.inf else hi
    elif min_count == 0 and all_keys and interval:
        k, top = all_keys[0], all_keys[-1]
    else:
        return all_keys
    _guard_span(k, top, interval)
    full = []
    cur = k
    while cur <= top + 1e-9:
        full.append(round(cur, 10))
        cur += interval
    return full


def histo_bucket(key, count: int, date: bool, fmt, tz) -> dict:
    b = {"key": int(key) if date else key, "doc_count": count}
    if date:
        b["key_as_string"] = _format_date_key(int(key), fmt, tz) if fmt \
            else _millis_to_iso_tz(int(key), tz)
    return b


def _histo_buckets(ctx, rows, sub_aggs, keys, present, min_count,
                   extended_bounds, interval, date=False, recurse=None,
                   fmt=None, tz=None) -> dict:
    recurse = recurse or compute_aggs
    valid = present & ~np.isnan(keys)
    vk, vr = keys[valid], rows[valid]
    uniq, inverse = np.unique(vk, return_inverse=True)
    # one stable sort groups the rows of every key, each run ascending
    order = np.argsort(inverse.reshape(-1), kind="stable")
    ends = np.cumsum(np.bincount(inverse.reshape(-1), minlength=len(uniq)))
    groups: Dict[float, np.ndarray] = {}
    start = 0
    for key, end in zip(uniq.tolist(), ends.tolist()):
        groups[float(key)] = vr[order[start:end]]
        start = end
    all_keys = fill_histo_keys(sorted(groups), extended_bounds, interval,
                               min_count)
    _check_max_buckets(ctx, len(all_keys))
    buckets = []
    empty = np.zeros(0, dtype=np.int64)
    for key in all_keys:
        brows = groups.get(key, empty)
        if len(brows) < min_count and min_count > 0:
            continue
        b = histo_bucket(key, int(len(brows)), date, fmt, tz)
        if sub_aggs:
            b.update(recurse(ctx, brows, sub_aggs))
        buckets.append(b)
    return {"buckets": buckets}


# ----------------------------------------------------------------- dates

_CAL_UNITS = {"minute": "T", "1m": "T", "hour": "H", "1h": "H", "day": "D",
              "1d": "D", "week": "W", "1w": "W", "month": "M", "1M": "M",
              "quarter": "Q", "1q": "Q", "year": "Y", "1y": "Y"}
_FIXED_RE = re.compile(r"^(\d+)(ms|s|m|h|d)$")
_FIXED_FACTORS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
                  "d": 86_400_000}


def _date_interval(spec: dict) -> Tuple[float, Optional[str]]:
    """(fixed interval millis, None) or (0.0, calendar unit code)."""
    cal = spec.get("calendar_interval")
    if cal:
        unit = _CAL_UNITS.get(cal)
        if unit is None:
            raise ParsingError(f"unknown calendar interval [{cal}]")
        return 0.0, unit
    fixed = spec.get("fixed_interval") or spec.get("interval")
    if fixed is None:
        raise ParsingError(
            "date_histogram requires calendar_interval or fixed_interval")
    if isinstance(fixed, (int, float)):
        return float(fixed), None
    m = _FIXED_RE.match(str(fixed))
    if m:
        return float(int(m.group(1)) * _FIXED_FACTORS[m.group(2)]), None
    unit = _CAL_UNITS.get(str(fixed))
    if unit:
        return 0.0, unit
    raise ParsingError(f"unknown interval [{fixed}]")


def _resolve_tz(tz_spec):
    """`time_zone` -> tzinfo: a fixed offset ("-07:00") or an IANA name."""
    if not tz_spec:
        return None
    s = str(tz_spec)
    m = re.fullmatch(r"([+-])(\d{2}):?(\d{2})", s)
    if m:
        sign = 1 if m.group(1) == "+" else -1
        return dt.timezone(sign * dt.timedelta(hours=int(m.group(2)),
                                               minutes=int(m.group(3))))
    try:
        import zoneinfo
        return zoneinfo.ZoneInfo(s)
    except Exception:
        return None


def _millis_to_iso_tz(millis: int, tz) -> str:
    """ISO rendering in a zone with its offset ("...-07:00"); UTC as Z."""
    if tz is None:
        return _millis_to_iso(millis)
    d = dt.datetime.fromtimestamp(millis / 1000.0, tz=tz)
    base = d.strftime("%Y-%m-%dT%H:%M:%S") + f".{d.microsecond // 1000:03d}"
    off = d.utcoffset() or dt.timedelta(0)
    if off == dt.timedelta(0):
        return base + "Z"
    total = int(off.total_seconds())
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    return base + f"{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"


def _format_date_key(millis: int, fmt: str, tz=None) -> str:
    """Joda-pattern-lite rendering of a key ("yyyy-MM-dd", "iso8601",
    "strict_date_time", "epoch_millis", "e" for the day of the week)."""
    if fmt in ("iso8601", "strict_date_time", "date_time"):
        return _millis_to_iso_tz(millis, tz) if tz else _millis_to_iso(millis)
    if fmt == "epoch_millis":
        return str(millis)
    try:
        d = dt.datetime.fromtimestamp(millis / 1000.0,
                                      tz=tz or dt.timezone.utc)
    except (OverflowError, OSError, ValueError):
        return str(millis)
    if fmt == "e":
        return str(d.isoweekday())
    strf = (fmt.replace("yyyy", "%Y").replace("MM", "%m")
            .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
            .replace("ss", "%S"))
    out = d.strftime(strf)
    if "SSS" in out:
        out = out.replace("SSS", f"{d.microsecond // 1000:03d}")
    return out


def _date_offset_ms(offset) -> float:
    """A date_histogram `offset` ("+6h", "-1d") in millis."""
    if not offset:
        return 0.0
    s = str(offset)
    sign = -1.0 if s.startswith("-") else 1.0
    s = s.lstrip("+-")
    for suffix in ("ms", "s", "m", "h", "d"):
        if s.endswith(suffix):
            return sign * float(s[:-len(suffix)]) * _FIXED_FACTORS[suffix]
    try:
        return sign * float(s)
    except ValueError:
        return 0.0


def _calendar_floor(millis: int, unit: str, tz=None) -> float:
    """Floor to a calendar unit in `tz`'s wall time when given (buckets
    align to local midnights and month starts)."""
    d = dt.datetime.fromtimestamp(millis / 1000.0, tz=tz or dt.timezone.utc)
    if unit == "T":
        d = d.replace(second=0, microsecond=0)
    elif unit == "H":
        d = d.replace(minute=0, second=0, microsecond=0)
    elif unit == "D":
        d = d.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit == "W":
        d = (d - dt.timedelta(days=d.weekday())).replace(
            hour=0, minute=0, second=0, microsecond=0)
    elif unit == "M":
        d = d.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "Q":
        d = d.replace(month=((d.month - 1) // 3) * 3 + 1, day=1, hour=0,
                      minute=0, second=0, microsecond=0)
    elif unit == "Y":
        d = d.replace(month=1, day=1, hour=0, minute=0, second=0,
                      microsecond=0)
    return float(int(d.timestamp() * 1000))


def _millis_to_iso(millis: int) -> str:
    try:
        d = dt.datetime.fromtimestamp(millis / 1000.0, tz=dt.timezone.utc)
    except (OverflowError, OSError, ValueError):
        return str(millis)   # out of range: the raw number
    return d.strftime("%Y-%m-%dT%H:%M:%S.") + f"{d.microsecond // 1000:03d}Z"


def has_global_agg(aggs) -> bool:
    """Whether an aggregation needs every index: a `global` one or a
    bucket aggregation with `min_doc_count: 0` (these turn the can_match
    skip off)."""
    for spec in (aggs or {}).values():
        if not isinstance(spec, dict):
            continue
        if "global" in spec:
            return True
        for kind, body in spec.items():
            if kind not in _STRUCTURAL and isinstance(body, dict) \
                    and str(body.get("min_doc_count")) == "0":
                return True
        if has_global_agg(sub_aggs_of(spec)):
            return True
    return False
