"""Mergeable partial aggregation states for searches over several indices
(port of `elasticsearch_tpu/search/agg_partials.py`).

Each index's query phase ships partial states instead of final JSON
(sum / count pairs, an HLL sketch for `cardinality`, a t-digest for
`percentiles`, `percentile_ranks`, `median_absolute_deviation` and
`boxplot`, power sums for `matrix_stats`, character counts for
`string_stats`, the combined states of `scripted_metric`, bucket lists
with their sub-agg states and, for `significant_*`, background counts),
the coordinator merges them associatively and finalizes once, running
the pipelines over the final outputs:

  compute_partial_aggs(ctx, rows, spec)  - one index, partial states
  merge_partial_aggs(a, b, spec)         - the associative merge
  finalize_aggs(partial, spec)           - the final JSON and pipelines

States are plain JSON-safe dicts tagged with "$p". The device rung
(`search/agg_plan.py`) emits the same states.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import ParsingError
from elasticsearch_tpu_torch.search import agg_pipelines as P
from elasticsearch_tpu_torch.search import aggregations as A
from elasticsearch_tpu_torch.search.aggregations import (
    BUCKET_AGGS, METRIC_AGGS, PIPELINE_AGGS, _hashable, _sort_key,
    all_values,
)
from elasticsearch_tpu_torch.search.queries import SearchContext

# single-bucket aggs: one {doc_count, subs...} object, no bucket list
SINGLE_BUCKET = {"filter", "global", "missing", "sampler", "nested",
                 "reverse_nested"}

# HyperLogLog (cardinality): p = 12 (4096 registers, ~1.6% standard
# error), sparse below 512 occupied registers
HLL_P = 12
HLL_M = 1 << HLL_P
_HLL_ALPHA = 0.7213 / (1 + 1.079 / HLL_M)
_HLL_SPARSE_MAX = 512


def hll_hash(v) -> int:
    """The 64-bit register hash of a value: blake2b of its repr (numbers
    as floats, booleans apart)."""
    if isinstance(v, bool):
        b = b"b1" if v else b"b0"
    elif isinstance(v, (int, float)):
        b = repr(float(v)).encode()
    else:
        b = repr(v).encode()
    return int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(), "big")


def hll_register(h: int):
    """(register index, rank) of a hash."""
    return h & (HLL_M - 1), (64 - HLL_P) - (h >> HLL_P).bit_length() + 1


def _hll_from_values(values) -> dict:
    regs: Dict[int, int] = {}
    for v in values:
        idx, rank = hll_register(hll_hash(v))
        if rank > regs.get(idx, 0):
            regs[idx] = rank
    return hll_pack(regs)


def hll_pack(regs: Dict[int, int]) -> dict:
    if len(regs) <= _HLL_SPARSE_MAX:
        return {"$p": "hll", "sparse": {str(k): v for k, v in regs.items()}}
    dense = [0] * HLL_M
    for k, v in regs.items():
        dense[k] = v
    return {"$p": "hll", "dense": dense}


def _hll_regs(state: dict) -> Dict[int, int]:
    if "sparse" in state:
        return {int(k): v for k, v in state["sparse"].items()}
    return {i: v for i, v in enumerate(state["dense"]) if v}


def _hll_merge(a: dict, b: dict) -> dict:
    regs = _hll_regs(a)
    for k, v in _hll_regs(b).items():
        if v > regs.get(k, 0):
            regs[k] = v
    return hll_pack(regs)


def _hll_estimate(state: dict) -> int:
    regs = _hll_regs(state)
    zeros = HLL_M - len(regs)
    inv_sum = zeros + sum(2.0 ** -r for r in regs.values())
    raw = _HLL_ALPHA * HLL_M * HLL_M / inv_sum
    if raw <= 2.5 * HLL_M and zeros:
        raw = HLL_M * math.log(HLL_M / zeros)
    return int(round(raw))


# t-digest (percentiles): merging digest, centroid weights bounded by
# 4·W·q(1−q)/δ, so with at most δ values the sketch is exact
_TD_COMPRESSION = 200


def _td_compress(cents: List[List[float]]) -> List[List[float]]:
    if not cents:
        return []
    cents = sorted(cents)
    return _td_fold([float(m) for m, _ in cents], [float(w) for _, w in cents],
                    sum(w for _, w in cents))


def _td_fold(means: List[float], weights: List[float],
             total: float) -> List[List[float]]:
    """Sorted centroids merged left to right while the merged weight stays
    under 4·W·q(1−q)/δ at the open centroid's midpoint q."""
    out: List[List[float]] = []
    cum = 0.0
    m0 = w0 = None
    for mean, w in zip(means, weights):
        if w0 is not None:
            q = (cum + w0 / 2) / total
            limit = max(1.0, 4.0 * total * q * (1 - q) / _TD_COMPRESSION)
            if w0 + w <= limit:
                m0, w0 = (m0 * w0 + mean * w) / (w0 + w), w0 + w
                continue
            out.append([m0, w0])
            cum += w0
        m0, w0 = mean, w
    out.append([m0, w0])
    return out


def _td_from_values(vals: np.ndarray) -> dict:
    n = len(vals)
    return {"$p": "tdigest",
            "c": _td_fold(np.sort(vals).astype(np.float64).tolist(),
                          [1.0] * n, float(n)) if n else [],
            "min": float(vals.min()) if len(vals) else None,
            "max": float(vals.max()) if len(vals) else None,
            "n": int(len(vals))}


def _td_merge(a: dict, b: dict) -> dict:
    mins = [x for x in (a.get("min"), b.get("min")) if x is not None]
    maxs = [x for x in (a.get("max"), b.get("max")) if x is not None]
    return {"$p": "tdigest",
            "c": _td_compress([list(c) for c in a["c"]]
                              + [list(c) for c in b["c"]]),
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "n": a.get("n", 0) + b.get("n", 0)}


def _td_quantile(state: dict, q: float) -> Optional[float]:
    cents = state["c"]
    if not cents:
        return None
    total = sum(w for _, w in cents)
    if total == 1 or len(cents) == 1:
        return cents[0][0] if len(cents) == 1 else None
    target = q * total
    # centroid i's mass is centred at cum + w / 2
    cum = 0.0
    prev_mean, prev_mid = state["min"], 0.0
    for mean, w in cents:
        mid = cum + w / 2.0
        if target <= mid:
            if mid == prev_mid:
                return float(mean)
            t = (target - prev_mid) / (mid - prev_mid)
            return float(prev_mean + t * (mean - prev_mean))
        prev_mean, prev_mid = mean, mid
        cum += w
    return float(state["max"])


def _td_cdf(state: dict, x: float) -> float:
    """The share of the digest's mass below x, interpolated between
    centroid midpoints."""
    cents = state["c"]
    if not cents:
        return 0.0
    total = sum(w for _, w in cents)
    if state["min"] is not None and x < state["min"]:
        return 0.0
    if state["max"] is not None and x >= state["max"]:
        return 1.0
    cum = 0.0
    prev_mean, prev_mid = state["min"], 0.0
    for mean, w in cents:
        mid = cum + w / 2.0
        if x < mean:
            if mean == prev_mean:
                return prev_mid / total
            t = (x - prev_mean) / (mean - prev_mean)
            return (prev_mid + t * (mid - prev_mid)) / total
        prev_mean, prev_mid = mean, mid
        cum += w
    return 1.0


# ---------------------------------------------------------------- partials

def compute_partial_aggs(ctx: SearchContext, rows: np.ndarray,
                         aggs_spec: dict) -> dict:
    """One index's partial agg tree; the pipelines wait for finalize."""
    out: Dict[str, Any] = {}
    for name, spec in (aggs_spec or {}).items():
        kind = A.agg_kind(name, spec)
        if kind in PIPELINE_AGGS:
            continue
        if kind in METRIC_AGGS:
            out[name] = metric_partial(ctx, rows, kind, spec[kind])
        elif kind in BUCKET_AGGS:
            out[name] = A._compute_bucket(
                ctx, rows, kind, partial_spec(kind, spec[kind]),
                A.split_pipelines(A.sub_aggs_of(spec))[0],
                recurse=compute_partial_aggs)
        else:
            raise ParsingError(f"unknown aggregation type [{kind}]")
    return out


def partial_spec(kind: str, spec: dict) -> dict:
    """An index's spec: ordering, pruning and thresholds move to the
    coordinator, and the candidates are bounded by `shard_size` (terms,
    significant and grid buckets: default size * 1.5 + 10; rare_terms:
    default 1,000, its `max_doc_count` applied after the merge); a
    histogram neither prunes nor zero-fills (min_doc_count -1), the
    coordinator does both after the merge."""
    size = int(spec.get("size", 10))
    if kind == "terms":
        s = {k: v for k, v in spec.items() if k != "order"}
        s["size"] = int(spec.get("shard_size") or (size * 3 // 2 + 10))
        return s
    if kind in ("significant_terms", "significant_text"):
        return {**spec, "min_doc_count": 1,
                "size": int(spec.get("shard_size") or (size * 3 // 2 + 10))}
    if kind == "rare_terms":
        return {**spec, "max_doc_count": 1 << 60,
                "size": int(spec.get("shard_size", 1000))}
    if kind in ("geohash_grid", "geotile_grid"):
        size = int(spec.get("size", 10000))
        return {**spec,
                "size": int(spec.get("shard_size") or (size * 3 // 2 + 10))}
    if kind in ("histogram", "date_histogram"):
        return {**spec, "min_doc_count": -1}
    return spec


def metric_partial(ctx: SearchContext, rows: np.ndarray, kind: str,
                   spec: dict) -> dict:
    field = spec.get("field")
    if kind == "scripted_metric":
        # the combined state; reduce_script runs once at the coordinator
        return {"$p": "scripted_metric",
                "states": [A.scripted_metric_map_combine(ctx, rows, spec)]}
    if kind == "value_count":
        n = len(rows) if field is None else len(all_values(ctx, rows, field))
        return {"$p": "value_count", "n": int(n)}
    if kind == "cardinality":
        return _hll_from_values(
            _hashable(v) for _, v in all_values(ctx, rows, field))
    if kind == "top_hits":
        final = A.top_hits(ctx, rows, spec)
        return {"$p": "top_hits", "size": int(spec.get("size", 3)),
                "total": final["hits"]["total"]["value"],
                "hits": final["hits"]["hits"]}
    if kind == "top_metrics":
        return {"$p": "top_metrics",
                "top": A.compute_top_metrics(ctx, rows, spec)["top"]}
    if kind == "string_stats":
        return {"$p": "string_stats",
                **A.string_stats_state(ctx, rows, field)}
    if kind == "matrix_stats":
        return _matrix_partial(ctx, rows, spec)
    if kind in ("geo_bounds", "geo_centroid"):
        _, lats, lons = A.geo_point_values(ctx, rows, field)
        lats, lons = lats.tolist(), lons.tolist()
        if kind == "geo_centroid":
            return {"$p": "geo_centroid", "n": len(lats),
                    "lat_sum": sum(lats), "lon_sum": sum(lons)}
        if not lats:
            return {"$p": "geo_bounds", "n": 0}
        return {"$p": "geo_bounds", "n": len(lats),
                "minlat": min(lats), "maxlat": max(lats),
                "minlon": min(lons), "maxlon": max(lons)}
    if kind == "weighted_avg":
        vv, wv = A.weighted_avg_parts(ctx, rows, spec)
        return {"$p": "weighted_avg", "vw": float((vv * wv).sum()),
                "w": float(wv.sum())}
    vals, present = A.metric_numeric(ctx, rows, spec)
    v = vals[present]
    if kind in ("percentiles", "percentile_ranks",
                "median_absolute_deviation", "boxplot"):
        return _td_from_values(v)
    if kind == "avg":
        return {"$p": "avg", "sum": float(v.sum()), "n": int(len(v))}
    if kind == "sum":
        return {"$p": "sum", "sum": float(v.sum())}
    if kind == "min":
        return {"$p": "min", "v": float(v.min()) if len(v) else None}
    if kind == "max":
        return {"$p": "max", "v": float(v.max()) if len(v) else None}
    if kind == "stats":
        return {"$p": "stats", "n": int(len(v)), "sum": float(v.sum()),
                "min": float(v.min()) if len(v) else None,
                "max": float(v.max()) if len(v) else None}
    if kind == "extended_stats":
        return {"$p": "extended_stats", "n": int(len(v)),
                "sum": float(v.sum()), "ss": float((v ** 2).sum()),
                "min": float(v.min()) if len(v) else None,
                "max": float(v.max()) if len(v) else None}
    raise ParsingError(f"unknown metric aggregation [{kind}]")


def _matrix_partial(ctx, rows, spec) -> dict:
    """Power sums 1..4 of each field and the pairwise product sums over
    the rows holding every field: they merge by addition."""
    fields = spec.get("fields", [])
    cols, mask = A.matrix_columns(ctx, rows, fields)
    s = {f: [float((cols[f] ** k).sum()) for k in (1, 2, 3, 4)]
         for f in fields}
    sxy = {}
    for i, f in enumerate(fields):
        for g in fields[i + 1:]:
            sxy[f + "|" + g] = float((cols[f] * cols[g]).sum())
    return {"$p": "matrix_stats", "n": int(mask.sum()), "fields": list(fields),
            "s": s, "sxy": sxy}


# ------------------------------------------------------------------ merge

def merge_partial_aggs(a: dict, b: dict, aggs_spec: dict) -> dict:
    out = dict(a)
    for name, spec in (aggs_spec or {}).items():
        kinds = [k for k in spec if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1 or kinds[0] in PIPELINE_AGGS or name not in b:
            continue
        kind = kinds[0]
        if name not in out:
            out[name] = b[name]
        elif kind in METRIC_AGGS:
            out[name] = _merge_metric(out[name], b[name])
        else:
            out[name] = _merge_bucket_agg(
                kind, out[name], b[name],
                A.split_pipelines(A.sub_aggs_of(spec))[0])
    return out


def _opt(fn, *vals):
    vs = [v for v in vals if v is not None]
    return fn(vs) if vs else None


def _merge_metric(a: dict, b: dict) -> dict:
    tag = a.get("$p")
    if tag != b.get("$p"):
        raise ParsingError(f"partial agg mismatch: {tag} vs {b.get('$p')}")
    if tag == "hll":
        return _hll_merge(a, b)
    if tag == "tdigest":
        return _td_merge(a, b)
    if tag == "value_count":
        return {"$p": tag, "n": a["n"] + b["n"]}
    if tag == "scripted_metric":
        return {"$p": tag, "states": a["states"] + b["states"]}
    if tag == "avg":
        return {"$p": tag, "sum": a["sum"] + b["sum"], "n": a["n"] + b["n"]}
    if tag == "sum":
        return {"$p": tag, "sum": a["sum"] + b["sum"]}
    if tag in ("min", "max"):
        return {"$p": tag, "v": _opt(min if tag == "min" else max,
                                     a["v"], b["v"])}
    if tag in ("stats", "extended_stats"):
        out = {"$p": tag, "n": a["n"] + b["n"], "sum": a["sum"] + b["sum"]}
        if tag == "extended_stats":
            out["ss"] = a["ss"] + b["ss"]
        out["min"] = _opt(min, a["min"], b["min"])
        out["max"] = _opt(max, a["max"], b["max"])
        return out
    if tag == "weighted_avg":
        return {"$p": tag, "vw": a["vw"] + b["vw"], "w": a["w"] + b["w"]}
    if tag == "geo_bounds":
        if not a["n"]:
            return b
        if not b["n"]:
            return a
        return {"$p": tag, "n": a["n"] + b["n"],
                "minlat": min(a["minlat"], b["minlat"]),
                "maxlat": max(a["maxlat"], b["maxlat"]),
                "minlon": min(a["minlon"], b["minlon"]),
                "maxlon": max(a["maxlon"], b["maxlon"])}
    if tag == "geo_centroid":
        return {"$p": tag, "n": a["n"] + b["n"],
                "lat_sum": a["lat_sum"] + b["lat_sum"],
                "lon_sum": a["lon_sum"] + b["lon_sum"]}
    if tag == "top_hits":
        return {"$p": tag, "size": a["size"], "total": a["total"] + b["total"],
                "hits": (a["hits"] + b["hits"])[:a["size"]]}
    if tag == "top_metrics":
        return {"$p": tag, "top": a["top"] + b["top"]}
    if tag == "string_stats":
        freq = dict(a["freq"])
        for ch, c in b["freq"].items():
            freq[ch] = freq.get(ch, 0) + c
        return {"$p": tag, "n": a["n"] + b["n"],
                "len_sum": a["len_sum"] + b["len_sum"],
                "min_len": _opt(min, a["min_len"], b["min_len"]),
                "max_len": _opt(max, a["max_len"], b["max_len"]),
                "freq": freq}
    if tag == "matrix_stats":
        return {"$p": tag, "n": a["n"] + b["n"], "fields": a["fields"],
                "s": {f: [x + y for x, y in zip(a["s"][f], b["s"][f])]
                      for f in a["fields"]},
                "sxy": {k: a["sxy"][k] + b["sxy"][k] for k in a["sxy"]}}
    raise ParsingError(f"unmergeable partial state [{tag}]")


def _bucket_key(bucket: dict):
    key = bucket.get("key")
    if isinstance(key, dict):   # a composite key
        return tuple(sorted(key.items()))
    return _hashable(key)


def _merge_buckets(a_bucket: dict, b_bucket: dict, sub_spec: dict) -> dict:
    m = dict(a_bucket)
    m["doc_count"] = a_bucket.get("doc_count", 0) \
        + b_bucket.get("doc_count", 0)
    if "bg_count" in a_bucket or "bg_count" in b_bucket:
        # significant buckets: the background counts add up, the score is
        # recomputed at finalize
        m["bg_count"] = a_bucket.get("bg_count", 0) \
            + b_bucket.get("bg_count", 0)
    a_subs = {n: a_bucket[n] for n in (sub_spec or {}) if n in a_bucket}
    b_subs = {n: b_bucket[n] for n in (sub_spec or {}) if n in b_bucket}
    m.update(merge_partial_aggs(a_subs, b_subs, sub_spec))
    return m


def _merge_keyed(a_buckets: list, b_buckets: list, sub_spec: dict) -> list:
    index: Dict[Any, int] = {}
    merged: List[dict] = []
    for bucket in a_buckets:
        index[_bucket_key(bucket)] = len(merged)
        merged.append(bucket)
    for bucket in b_buckets:
        k = _bucket_key(bucket)
        if k in index:
            merged[index[k]] = _merge_buckets(merged[index[k]], bucket,
                                              sub_spec)
        else:
            index[k] = len(merged)
            merged.append(bucket)
    return merged


def _rebucket(buckets: list, interval: int, sub_spec: dict) -> list:
    """Date buckets floored onto a coarser interval, the sub-agg partials
    of the buckets that collapse merged (auto_date_histogram)."""
    out: Dict[float, dict] = {}
    for bucket in buckets:
        key = float(np.floor(float(bucket["key"]) / interval) * interval)
        if key in out:
            out[key] = _merge_buckets(out[key], {**bucket, "key": key},
                                      sub_spec)
        else:
            out[key] = {**bucket, "key": int(key),
                        "key_as_string": A._millis_to_iso(int(key))}
    return [out[k] for k in sorted(out)]


def _interval_ms(node: dict) -> int:
    return int(str(node.get("interval", "1ms")).rstrip("ms") or 1)


def _merge_bucket_agg(kind: str, a, b, sub_spec: dict):
    if kind in SINGLE_BUCKET:
        return _merge_buckets(a, b, sub_spec)
    if kind == "filters":
        if isinstance(a.get("buckets"), dict):
            merged = dict(a["buckets"])
            for bname, bb in b.get("buckets", {}).items():
                merged[bname] = (_merge_buckets(merged[bname], bb, sub_spec)
                                 if bname in merged else bb)
            return {**a, "buckets": merged}
        merged_list = []
        bl = b.get("buckets", [])
        for i, ab in enumerate(a.get("buckets", [])):
            merged_list.append(_merge_buckets(ab, bl[i], sub_spec)
                               if i < len(bl) else ab)
        merged_list.extend(bl[len(merged_list):])
        return {**a, "buckets": merged_list}
    if kind == "auto_date_histogram":
        interval = max(_interval_ms(a), _interval_ms(b))
        return {"buckets": _merge_keyed(
            _rebucket(a.get("buckets", []), interval, sub_spec),
            _rebucket(b.get("buckets", []), interval, sub_spec), sub_spec),
            "interval": f"{interval}ms"}
    # keyed bucket lists: terms, histograms, ranges, grids, composite,
    # adjacency
    out = {**a, "buckets": _merge_keyed(a.get("buckets", []),
                                        b.get("buckets", []), sub_spec)}
    out.pop("after_key", None)  # recomputed at finalize (composite)
    if "sum_other_doc_count" in out:
        out["sum_other_doc_count"] = (a.get("sum_other_doc_count", 0)
                                      + b.get("sum_other_doc_count", 0))
    for k in ("doc_count", "bg_count"):   # significant_* totals
        if k in a or k in b:
            out[k] = a.get(k, 0) + b.get(k, 0)
    return out


# --------------------------------------------------------------- finalize

def finalize_aggs(partial: dict, aggs_spec: dict) -> dict:
    """The final JSON of merged partial states; each bucket
    aggregation's pipeline sub-aggregations run over its final bucket
    list, the top level's pipelines over the final outputs."""
    out: Dict[str, Any] = {}
    pipelines: List[Tuple[str, str, dict]] = []
    for name, spec in (aggs_spec or {}).items():
        kind = [k for k in spec if k not in ("aggs", "aggregations",
                                             "meta")][0]
        if kind in PIPELINE_AGGS:
            pipelines.append((name, kind, spec[kind]))
            continue
        if name not in partial:
            continue
        if kind in METRIC_AGGS:
            out[name] = _finalize_metric(kind, spec[kind], partial[name])
            continue
        normal, pipes = A.split_pipelines(A.sub_aggs_of(spec))
        out[name] = _finalize_bucket_agg(kind, spec[kind], partial[name],
                                         normal)
        P.run_parent_pipelines(out[name], pipes)
    P.run_sibling_pipelines(out, pipelines)
    return out


def _finalize_metric(kind: str, spec: dict, state: dict):
    if kind == "value_count":
        return {"value": state["n"]}
    if kind == "scripted_metric":
        return {"value": A.scripted_metric_reduce(spec, state["states"])}
    if kind == "cardinality":
        return {"value": _hll_estimate(state)}
    if kind == "avg":
        return {"value": state["sum"] / state["n"] if state["n"] else None}
    if kind == "sum":
        return {"value": state["sum"]}
    if kind in ("min", "max"):
        return {"value": state["v"]}
    if kind in ("stats", "extended_stats"):
        n = state["n"]
        base = {"count": n, "min": state["min"], "max": state["max"],
                "avg": state["sum"] / n if n else None, "sum": state["sum"]}
        if kind == "stats":
            return base
        if n == 0:
            base.update({"sum_of_squares": None, "variance": None,
                         "std_deviation": None,
                         "std_deviation_bounds": {"upper": None,
                                                  "lower": None}})
            return base
        mean = state["sum"] / n
        var = max(state["ss"] / n - mean * mean, 0.0)
        std = math.sqrt(var)
        sigma = float(spec.get("sigma", 2.0))
        base.update({
            "sum_of_squares": state["ss"], "variance": var,
            "variance_population": var,
            "variance_sampling": (max(state["ss"] - n * mean * mean, 0.0)
                                  / (n - 1)) if n > 1 else 0.0,
            "std_deviation": std,
            "std_deviation_bounds": {"upper": mean + sigma * std,
                                     "lower": mean - sigma * std},
        })
        return base
    if kind == "weighted_avg":
        return {"value": state["vw"] / state["w"] if state["w"] else None}
    if kind == "percentiles":
        pcts = spec.get("percents", [1, 5, 25, 50, 75, 95, 99])
        return {"values": {f"{float(p)}": _td_quantile(state, p / 100.0)
                           for p in pcts}}
    if kind == "percentile_ranks":
        empty = not state["c"]
        return {"values": {
            f"{float(t)}": None if empty else 100.0 * _td_cdf(state,
                                                              float(t))
            for t in spec.get("values", [])}}
    if kind == "median_absolute_deviation":
        return {"value": _td_mad(state)}
    if kind == "boxplot":
        return _finalize_boxplot(state)
    if kind == "geo_bounds":
        if not state["n"]:
            return {"bounds": None}
        return {"bounds": {
            "top_left": {"lat": state["maxlat"], "lon": state["minlon"]},
            "bottom_right": {"lat": state["minlat"], "lon": state["maxlon"]}}}
    if kind == "geo_centroid":
        if not state["n"]:
            return {"count": 0}
        return {"location": {"lat": state["lat_sum"] / state["n"],
                             "lon": state["lon_sum"] / state["n"]},
                "count": state["n"]}
    if kind == "top_hits":
        return {"hits": {"total": {"value": state["total"], "relation": "eq"},
                         "hits": state["hits"][:state["size"]]}}
    if kind == "top_metrics":
        order = A.top_metrics_sort(spec)[1]
        top = sorted(state["top"], key=lambda t: t["sort"][0],
                     reverse=(order == "desc"))
        return {"top": top[:int(spec.get("size", 1))]}
    if kind == "string_stats":
        return A.finalize_string_stats(spec, state)
    if kind == "matrix_stats":
        return _finalize_matrix(state)
    raise ParsingError(f"unknown metric aggregation [{kind}]")


def _td_mad(state: dict):
    """The median absolute deviation of a digest: the half-width around
    its median holding half the mass, by bisection."""
    if not state["c"]:
        return None
    med = _td_quantile(state, 0.5)
    lo, hi = 0.0, max(state["max"] - state["min"], 0.0)
    if hi == 0.0:
        return 0.0
    for _ in range(50):
        mid = (lo + hi) / 2
        if _td_cdf(state, med + mid) - _td_cdf(state, med - mid) >= 0.5:
            hi = mid
        else:
            lo = mid
    return hi


def _finalize_boxplot(state: dict):
    if not state["c"]:
        return {"min": None, "max": None, "q1": None, "q2": None,
                "q3": None, "lower": None, "upper": None}
    q1, q2, q3 = (_td_quantile(state, q) for q in (0.25, 0.5, 0.75))
    iqr = q3 - q1
    inside = [m for m, _ in state["c"]
              if q1 - 1.5 * iqr <= m <= q3 + 1.5 * iqr]
    return {"min": state["min"], "max": state["max"],
            "q1": q1, "q2": q2, "q3": q3,
            "lower": min(inside) if inside else q1,
            "upper": max(inside) if inside else q3}


def _finalize_matrix(state: dict):
    n = state["n"]
    fields = state["fields"]
    if n == 0:
        return {"doc_count": 0, "fields": []}
    mean = {f: state["s"][f][0] / n for f in fields}
    var = {f: max((state["s"][f][1] - n * mean[f] ** 2) / (n - 1), 0.0)
           if n > 1 else 0.0 for f in fields}
    sd = {f: math.sqrt(var[f]) for f in fields}

    def comoment(f, g):
        if f == g:
            return state["s"][f][1] - n * mean[f] ** 2
        k = f + "|" + g if f + "|" + g in state["sxy"] else g + "|" + f
        return state["sxy"][k] - n * mean[f] * mean[g]

    out_fields = []
    for f in fields:
        s1, s2, s3, s4 = state["s"][f]
        skew = kurt = 0.0
        if sd[f]:
            m = mean[f]
            # central power sums from the raw ones
            c3 = s3 - 3 * m * s2 + 2 * n * m ** 3
            c4 = s4 - 4 * m * s3 + 6 * m * m * s2 - 3 * n * m ** 4
            psd = math.sqrt(max(s2 / n - m * m, 0.0))
            skew = (c3 / n) / psd ** 3 if psd else 0.0
            kurt = (c4 / n) / psd ** 4 if psd else 0.0
        cov, corr = {}, {}
        for g in fields:
            c = comoment(f, g) / (n - 1) if n > 1 else 0.0
            cov[g] = c
            corr[g] = (c / (sd[f] * sd[g])) if sd[f] and sd[g] else (
                1.0 if f == g else 0.0)
        out_fields.append({"name": f, "count": n, "mean": mean[f],
                           "variance": var[f], "skewness": skew,
                           "kurtosis": kurt, "covariance": cov,
                           "correlation": corr})
    return {"doc_count": n, "fields": out_fields}


def _finalize_one_bucket(bucket: dict, sub_spec: dict) -> dict:
    out = {k: v for k, v in bucket.items() if k not in (sub_spec or {})}
    if sub_spec:
        out.update(finalize_aggs(
            {n: bucket[n] for n in sub_spec if n in bucket}, sub_spec))
    return out


def _fill_gaps(buckets: List[dict], interval: float,
               date: bool) -> List[dict]:
    """Zero-fill the gaps between indices' buckets (min_doc_count 0)."""
    if not buckets or interval <= 0:
        return buckets
    out = []
    cur = float(buckets[0]["key"])
    by_key = {float(b["key"]): b for b in buckets}
    last = float(buckets[-1]["key"])
    guard = 0
    while cur <= last + 1e-9 and guard < 100_000:
        b = by_key.get(round(cur, 10)) or by_key.get(cur)
        if b is None:
            b = {"key": int(cur) if date else round(cur, 10), "doc_count": 0}
            if date:
                b["key_as_string"] = A._millis_to_iso(int(cur))
        out.append(b)
        cur += interval
        guard += 1
    return out if guard < 100_000 else buckets


def _finalize_bucket_agg(kind: str, spec: dict, node, sub_spec: dict):
    if kind in SINGLE_BUCKET:
        return _finalize_one_bucket(node, sub_spec)
    if kind == "filters":
        if isinstance(node.get("buckets"), dict):
            return {"buckets": {n: _finalize_one_bucket(b, sub_spec)
                                for n, b in node["buckets"].items()}}
        return {"buckets": [_finalize_one_bucket(b, sub_spec)
                            for b in node.get("buckets", [])]}
    if kind == "auto_date_histogram":
        # coarsen the raw buckets (their sub-agg states still merge) until
        # at most the target count remain, then finalize once
        target = int(spec.get("buckets", 10))
        interval = _interval_ms(node)
        raw = node.get("buckets", [])
        while len(raw) > target:
            interval = next((u for u in A.AUTO_UNITS if u > interval),
                            interval * 2)
            raw = _rebucket(raw, interval, sub_spec)
        buckets = [_finalize_one_bucket(b, sub_spec) for b in raw]
        buckets.sort(key=lambda b: float(b["key"]))
        return {"buckets": buckets, "interval": f"{interval}ms"}
    buckets = [_finalize_one_bucket(b, sub_spec)
               for b in node.get("buckets", [])]
    if kind in ("significant_terms", "significant_text"):
        size = int(spec.get("size", 10))
        min_count = int(spec.get("min_doc_count", 3))
        fg_total = int(node.get("doc_count", 0))
        bg_total = int(node.get("bg_count", 0)) or fg_total
        rescored = []
        for b in buckets:
            fg, bg = b.get("doc_count", 0), b.get("bg_count", 0)
            if fg < min_count or bg == 0:
                continue
            score = A.jlh(fg, fg_total, bg, bg_total)
            if score is not None:
                rescored.append({**b, "score": score})
        rescored.sort(key=lambda b: (-b["score"], _sort_key(b["key"])))
        return {"doc_count": fg_total, "bg_count": bg_total,
                "buckets": rescored[:size]}
    if kind == "terms":
        size = int(spec.get("size", 10))
        order_spec = spec.get("order")
        if order_spec and isinstance(order_spec, dict):
            ((okey, odir),) = order_spec.items()
            reverse = odir == "desc"
            if okey == "_key":
                buckets.sort(key=lambda b: _sort_key(b["key"]),
                             reverse=reverse)
            elif okey == "_count":
                buckets.sort(key=lambda b: b["doc_count"], reverse=reverse)
            else:
                def metric_val(b, path=okey):
                    v = b
                    for part in path.split("."):
                        v = v.get(part) if isinstance(v, dict) else None
                    if isinstance(v, (int, float)):
                        return v
                    return (v or {}).get("value", 0) \
                        if isinstance(v, dict) else 0
                buckets.sort(key=metric_val, reverse=reverse)
        else:
            buckets.sort(key=lambda b: (-b["doc_count"], _sort_key(b["key"])))
        other = sum(b["doc_count"] for b in buckets[size:])
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": int(other), "buckets": buckets[:size]}
    if kind == "rare_terms":
        max_count = int(spec.get("max_doc_count", 1))
        buckets = [b for b in buckets if b["doc_count"] <= max_count]
        buckets.sort(key=lambda b: (b["doc_count"], _sort_key(b["key"])))
        return {"doc_count_error_upper_bound": 0, "sum_other_doc_count": 0,
                "buckets": buckets}
    if kind in ("histogram", "date_histogram"):
        min_count = int(spec.get("min_doc_count", 0))
        buckets.sort(key=lambda b: float(b["key"]))
        if min_count > 0:
            buckets = [b for b in buckets if b["doc_count"] >= min_count]
        elif buckets and kind == "histogram" and spec.get("interval"):
            buckets = _fill_gaps(buckets, float(spec["interval"]), date=False)
        elif buckets and kind == "date_histogram":
            interval_ms, calendar = A._date_interval(spec)
            if not calendar:
                buckets = _fill_gaps(buckets, interval_ms, date=True)
        return {"buckets": buckets}
    if kind in ("geohash_grid", "geotile_grid"):
        buckets.sort(key=lambda b: (-b["doc_count"], b["key"]))
        return {"buckets": buckets[:int(spec.get("size", 10000))]}
    if kind == "composite":
        names = [next(iter(src)) for src in spec.get("sources", [])]
        buckets.sort(key=lambda b: tuple(_sort_key(b["key"].get(n))
                                         for n in names))
        buckets = buckets[:int(spec.get("size", 10))]
        out: Dict[str, Any] = {"buckets": buckets}
        if buckets:
            out["after_key"] = buckets[-1]["key"]
        return out
    if kind == "adjacency_matrix":
        buckets.sort(key=lambda b: b["key"])
        return {"buckets": buckets}
    # range / date_range / ip_range: the first index's order
    return {**{k: v for k, v in node.items() if k != "buckets"},
            "buckets": buckets}
