"""Aggregations over a query's rows: the host framework (port of the
metric and bucket kinds of `elasticsearch_tpu/search/aggregations.py`).

Every aggregation reduces vectorised over the matched row set, and each
bucket carries its rows, so sub-aggregations recurse to any depth
(`compute_aggs`). Values come from the doc-values columns: numbers
through `search/service.py::numeric_values` (a multi-valued doc's first
value, a boolean as 1.0 or 0.0), raw values through `all_values` (every
value of a multi-valued doc).

Ported kinds. Metrics: `avg`, `sum`, `min`, `max`, `stats`,
`extended_stats`, `value_count`, `cardinality` (exact here: a set of the
values; the shard partials of `search/agg_partials.py` carry an HLL) and
`percentiles` (t-digest singleton interpolation). Buckets: `terms`
(`size`, `order`, `missing`, `min_doc_count`, `include` / `exclude`,
`value_type`), `histogram`, `date_histogram` (calendar and fixed
intervals, `offset`, `time_zone`, `format`, `extended_bounds`), `range`,
`date_range`, `ip_range`, `filter`, `filters`, `missing`, `global`,
`nested` (its `doc_count` the nested objects of its rows; inside it a
`terms` bucket on a field under the path counts each value occurrence,
while its sub-aggregations run over the unique parent rows) and
`reverse_nested` (back to the parents, or to an outer nested `path`).
`search.max_buckets` (`ctx.max_buckets`) bounds each bucket list.

Left out, each a 400 that names it (`validate_aggs`, `LEFT_OUT`): the
pipeline aggregations, `composite`, `significant_terms`,
`significant_text`, `rare_terms`, `sampler`, `auto_date_histogram`,
`adjacency_matrix`, the geo aggregations, `top_hits`, `top_metrics`,
`weighted_avg`, `median_absolute_deviation`, `boxplot`,
`percentile_ranks`, `string_stats`, `matrix_stats`, `scripted_metric`,
HDR percentiles and `script` on any aggregation.
"""

from __future__ import annotations

import datetime as dt
import ipaddress
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.cluster.routing import murmur3_x86_32_many
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError, TooManyBucketsError,
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
               "nested", "reverse_nested"}
METRIC_AGGS = {"avg", "sum", "min", "max", "stats", "extended_stats",
               "value_count", "cardinality", "percentiles"}
PIPELINE_AGGS = {"avg_bucket", "max_bucket", "min_bucket", "sum_bucket",
                 "stats_bucket", "extended_stats_bucket",
                 "percentiles_bucket", "derivative", "cumulative_sum",
                 "bucket_script", "bucket_selector", "bucket_sort",
                 "serial_diff", "moving_fn"}
# the kinds the reference serves that this build leaves out, and why
LEFT_OUT = {
    **{k: "pipeline aggregations are not ported (ROADMAP.md queue 1 "
          "item 7)" for k in PIPELINE_AGGS},
    **{k: "this bucket aggregation is not ported (ROADMAP.md queue 1 "
          "item 7)"
       for k in ("composite", "significant_terms", "significant_text",
                 "rare_terms", "sampler", "auto_date_histogram",
                 "adjacency_matrix")},
    **{k: "the geo aggregations are not ported (ROADMAP.md queue 1 "
          "item 7)"
       for k in ("geohash_grid", "geotile_grid", "geo_bounds",
                 "geo_centroid")},
    **{k: "this metric aggregation is not ported (ROADMAP.md queue 1 "
          "item 7)"
       for k in ("top_hits", "top_metrics", "weighted_avg",
                 "median_absolute_deviation", "boxplot", "percentile_ranks",
                 "string_stats", "matrix_stats")},
    "scripted_metric": "scripted metrics are not ported (ROADMAP.md "
                       "queue 1 item 7)",
}
_NUMERIC_ONLY_METRICS = {"sum", "avg", "min", "max", "stats",
                         "extended_stats", "percentiles"}
_STRUCTURAL = ("aggs", "aggregations", "meta")


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


def all_values(ctx: SearchContext, rows: np.ndarray,
               field: str) -> List[Tuple[int, Any]]:
    """[(row position, value)] expanded over multi-valued fields."""
    if field == "_index":
        name = getattr(ctx, "index_name", "index")
        return [(i, name) for i in range(len(rows))]
    out: List[Tuple[int, Any]] = []
    for i, v in enumerate(raw_values(ctx, rows, field).tolist()):
        if v is None:
            continue
        if isinstance(v, list):
            out.extend((i, item) for item in v if item is not None)
        else:
            out.append((i, v))
    return out


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

    if kind == "value_count":
        if field is None:
            return {"value": len(rows)}
        values = all_values(ctx, rows, field)
        count = len(values)
        if missing is not None:
            count += len(rows) - len({i for i, _ in values})
        return {"value": count}

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

    vals, present = numeric_values(ctx, rows, field, missing)
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
    if kind == "percentiles":
        pcts = spec.get("percents", [1, 5, 25, 50, 75, 95, 99])
        tdigest = spec.get("tdigest")
        if tdigest is not None and "compression" in tdigest:
            comp = float(tdigest["compression"] or 0)
            if comp < 0:
                raise IllegalArgumentError(
                    f"[compression] must be greater than or equal to 0. "
                    f"Found [{comp}] in [{name}]")
        v = np.sort(v)
        if spec.get("keyed", True) is False:
            return {"values": [{"key": float(p),
                                "value": _es_percentile(v, float(p))}
                               for p in pcts]}
        return {"values": {f"{float(p)}": _es_percentile(v, float(p))
                           for p in pcts}}
    raise ParsingError(f"unknown metric aggregation [{kind}]")


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


def check_ported(aggs_spec: dict) -> None:
    """A 400 naming the first left-out kind, `script`, or HDR percentiles
    anywhere in the tree."""
    for name, spec in (aggs_spec or {}).items():
        if not isinstance(spec, dict):
            continue
        for kind, body in spec.items():
            if kind in _STRUCTURAL:
                continue
            if kind in LEFT_OUT:
                raise not_ported(kind, LEFT_OUT[kind])
            if isinstance(body, dict) and body.get("script") is not None:
                raise not_ported("script", "scripts in aggregations are "
                                           "not ported (ROADMAP.md queue 1 "
                                           "item 7)")
            if kind == "percentiles" and isinstance(body, dict) \
                    and body.get("hdr") is not None:
                raise not_ported("hdr", "HDR percentiles are not ported "
                                        "(ROADMAP.md queue 1 item 7)")
        check_ported(sub_aggs_of(spec))


def validate_aggs(aggs_spec: dict, field_type=None) -> None:
    """Parse-time checks before any shard runs (the reference validates
    each aggregation as it parses it, so errors surface for zero-shard
    searches too), after the left-out kinds' 400s. `field_type(field) -> type name
    or None` enables the mapping-aware checks."""
    check_ported(aggs_spec)
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
            if kind == "filters" and not body.get("filters"):
                raise IllegalArgumentError("[filters] cannot be empty")
            if kind == "terms":
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
    """An aggregation tree over candidate rows, final form."""
    out: Dict[str, Any] = {}
    for name, spec in (aggs_spec or {}).items():
        kind = agg_kind(name, spec)
        if kind in LEFT_OUT:
            raise not_ported(kind, LEFT_OUT[kind])
        if kind in METRIC_AGGS:
            out[name] = compute_metric(ctx, rows, kind, spec[kind], name=name)
        elif kind in BUCKET_AGGS:
            out[name] = _compute_bucket(ctx, rows, kind, spec[kind],
                                        sub_aggs_of(spec))
        else:
            raise ParsingError(f"unknown aggregation type [{kind}]")
        if isinstance(spec.get("meta"), dict) \
                and isinstance(out.get(name), dict):
            out[name]["meta"] = spec["meta"]
    return out


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


def _terms(ctx, rows, spec, sub_aggs, recurse) -> dict:
    field = spec.get("field")
    size = int(spec.get("size", 10))
    tname = getattr(ctx.mapper_service.get(field), "type_name", None) \
        if field else None
    # an unmapped field aggregates under the caller's value_type
    tname = tname or spec.get("value_type")
    values = all_values(ctx, rows, field)
    missing_val = spec.get("missing")
    if missing_val is not None:
        mv = _coerce_missing(missing_val, tname)
        have = {i for i, _ in values}
        values = values + [(i, mv) for i in range(len(rows))
                           if i not in have]
    groups: Dict[Any, List[int]] = {}
    for idx, v in values:
        groups.setdefault(_hashable(v), []).append(idx)
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
        groups = {k: i for k, i in groups.items() if _in_partition(k)}
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
        groups = {k: i for k, i in groups.items() if _passes(k)}
    if int(spec.get("min_doc_count", 1)) == 0:
        # zero-count terms come from the whole index
        if field == "_index":
            universe = {getattr(ctx, "index_name", "index")}
        else:
            universe = {_hashable(v) for _, v in
                        all_values(ctx, ctx.all_rows(), field)}
        for t in universe:
            groups.setdefault(t, [])
    # under a nested scope, a field of the path counts each value
    # occurrence (one a nested document), while the sub-aggregations run
    # over the unique parent rows
    scope = getattr(ctx, "nested_path", None)
    occ = None
    if scope and isinstance(field, str) and field.startswith(scope + "."):
        occ = {k: len(i_list) for k, i_list in groups.items()}
    items = [(k, np.asarray(sorted(set(i_list)), dtype=np.int64))
             for k, i_list in groups.items()]

    def cnt(kv) -> int:
        return occ[kv[0]] if occ is not None else len(kv[1])
    order_spec = spec.get("order")
    if order_spec and isinstance(order_spec, dict):
        ((okey, odir),) = order_spec.items()
        reverse = odir == "desc"
        if okey == "_key":
            items.sort(key=lambda kv: _sort_key(kv[0]), reverse=reverse)
        elif okey == "_count":
            items.sort(key=lambda kv: (cnt(kv),), reverse=reverse)
        else:
            def metric_val(kv):
                node = recurse(ctx, rows[kv[1]], sub_aggs)
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
                         [(k, rows[i]) for k, i in items[:size]], recurse)
    if occ is not None:
        for b, kv in zip(buckets, items[:size]):
            b["doc_count"] = int(occ[kv[0]])
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
