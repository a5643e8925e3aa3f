"""Mergeable partial aggregation states for searches over several indices
(port of the ported kinds of `elasticsearch_tpu/search/agg_partials.py`).

Each index's query phase ships partial states instead of final JSON
(sum / count pairs, an HLL sketch for `cardinality`, a t-digest for
`percentiles`, bucket lists with their sub-agg states), the coordinator
merges them associatively and finalizes once:

  compute_partial_aggs(ctx, rows, spec)  - one index, partial states
  merge_partial_aggs(a, b, spec)         - the associative merge
  finalize_aggs(partial, spec)           - the final JSON

States are plain JSON-safe dicts tagged with "$p". The device rung
(`search/agg_plan.py`) emits the same states.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import ParsingError
from elasticsearch_tpu_torch.search import aggregations as A
from elasticsearch_tpu_torch.search.aggregations import (
    BUCKET_AGGS, METRIC_AGGS, _hashable, _sort_key, all_values,
    numeric_values,
)
from elasticsearch_tpu_torch.search.queries import SearchContext

# single-bucket aggs: one {doc_count, subs...} object, no bucket list
SINGLE_BUCKET = {"filter", "global", "missing", "nested", "reverse_nested"}

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
    total = sum(w for _, w in cents)
    out: List[List[float]] = []
    cum = 0.0
    for mean, w in cents:
        if out:
            q = (cum + out[-1][1] / 2) / total
            limit = max(1.0, 4.0 * total * q * (1 - q) / _TD_COMPRESSION)
            if out[-1][1] + w <= limit:
                m0, w0 = out[-1]
                out[-1] = [(m0 * w0 + mean * w) / (w0 + w), w0 + w]
                continue
            cum += out[-1][1]
        out.append([float(mean), float(w)])
    return out


def _td_from_values(vals: np.ndarray) -> dict:
    return {"$p": "tdigest",
            "c": _td_compress([[float(v), 1.0] for v in vals]),
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


# ---------------------------------------------------------------- partials

def compute_partial_aggs(ctx: SearchContext, rows: np.ndarray,
                         aggs_spec: dict) -> dict:
    """One index's partial agg tree."""
    out: Dict[str, Any] = {}
    for name, spec in (aggs_spec or {}).items():
        kind = A.agg_kind(name, spec)
        if kind in A.LEFT_OUT:
            raise A.not_ported(kind, A.LEFT_OUT[kind])
        if kind in METRIC_AGGS:
            out[name] = metric_partial(ctx, rows, kind, spec[kind])
        elif kind in BUCKET_AGGS:
            out[name] = A._compute_bucket(
                ctx, rows, kind, partial_spec(kind, spec[kind]),
                A.sub_aggs_of(spec), recurse=compute_partial_aggs)
        else:
            raise ParsingError(f"unknown aggregation type [{kind}]")
    return out


def partial_spec(kind: str, spec: dict) -> dict:
    """An index's spec: ordering moves to the coordinator and the terms
    candidates are bounded by `shard_size` (default size * 1.5 + 10); a
    histogram neither prunes nor zero-fills (min_doc_count -1), the
    coordinator does both after the merge."""
    if kind == "terms":
        s = {k: v for k, v in spec.items() if k != "order"}
        size = int(spec.get("size", 10))
        s["size"] = int(spec.get("shard_size") or (size * 3 // 2 + 10))
        return s
    if kind in ("histogram", "date_histogram"):
        return {**spec, "min_doc_count": -1}
    return spec


def metric_partial(ctx: SearchContext, rows: np.ndarray, kind: str,
                   spec: dict) -> dict:
    field = spec.get("field")
    if kind == "value_count":
        n = len(rows) if field is None else len(all_values(ctx, rows, field))
        return {"$p": "value_count", "n": int(n)}
    if kind == "cardinality":
        return _hll_from_values(
            _hashable(v) for _, v in all_values(ctx, rows, field))
    vals, present = numeric_values(ctx, rows, field, spec.get("missing"))
    v = vals[present]
    if kind == "percentiles":
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


# ------------------------------------------------------------------ merge

def merge_partial_aggs(a: dict, b: dict, aggs_spec: dict) -> dict:
    out = dict(a)
    for name, spec in (aggs_spec or {}).items():
        kinds = [k for k in spec if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1 or name not in b:
            continue
        kind = kinds[0]
        if name not in out:
            out[name] = b[name]
        elif kind in METRIC_AGGS:
            out[name] = _merge_metric(out[name], b[name])
        else:
            out[name] = _merge_bucket_agg(kind, out[name], b[name],
                                          A.sub_aggs_of(spec))
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
    if tag == "avg":
        return {"$p": tag, "sum": a["sum"] + b["sum"], "n": a["n"] + b["n"]}
    if tag == "sum":
        return {"$p": tag, "sum": a["sum"] + b["sum"]}
    if tag in ("min", "max"):
        return {"$p": tag, "v": _opt(min if tag == "min" else max,
                                     a["v"], b["v"])}
    if tag in ("stats", "extended_stats"):
        out = {"$p": tag, "n": a["n"] + b["n"], "sum": a["sum"] + b["sum"],
               "min": _opt(min, a["min"], b["min"]),
               "max": _opt(max, a["max"], b["max"])}
        if tag == "extended_stats":
            out["ss"] = a["ss"] + b["ss"]
        return out
    raise ParsingError(f"unmergeable partial state [{tag}]")


def _merge_buckets(a_bucket: dict, b_bucket: dict, sub_spec: dict) -> dict:
    m = dict(a_bucket)
    m["doc_count"] = a_bucket.get("doc_count", 0) \
        + b_bucket.get("doc_count", 0)
    a_subs = {n: a_bucket[n] for n in (sub_spec or {}) if n in a_bucket}
    b_subs = {n: b_bucket[n] for n in (sub_spec or {}) if n in b_bucket}
    m.update(merge_partial_aggs(a_subs, b_subs, sub_spec))
    return m


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
    # keyed bucket lists: terms, histograms, ranges
    index: Dict[Any, int] = {}
    merged: List[dict] = []
    for bucket in a.get("buckets", []):
        index[_hashable(bucket.get("key"))] = len(merged)
        merged.append(bucket)
    for bucket in b.get("buckets", []):
        k = _hashable(bucket.get("key"))
        if k in index:
            merged[index[k]] = _merge_buckets(merged[index[k]], bucket,
                                              sub_spec)
        else:
            index[k] = len(merged)
            merged.append(bucket)
    out = {**a, "buckets": merged}
    if "sum_other_doc_count" in out:
        out["sum_other_doc_count"] = (a.get("sum_other_doc_count", 0)
                                      + b.get("sum_other_doc_count", 0))
    return out


# --------------------------------------------------------------- finalize

def finalize_aggs(partial: dict, aggs_spec: dict) -> dict:
    out: Dict[str, Any] = {}
    for name, spec in (aggs_spec or {}).items():
        kind = [k for k in spec if k not in ("aggs", "aggregations",
                                             "meta")][0]
        if name not in partial:
            continue
        if kind in METRIC_AGGS:
            out[name] = _finalize_metric(kind, spec[kind], partial[name])
        else:
            out[name] = _finalize_bucket_agg(kind, spec[kind], partial[name],
                                             A.sub_aggs_of(spec))
    return out


def _finalize_metric(kind: str, spec: dict, state: dict):
    if kind == "value_count":
        return {"value": state["n"]}
    if kind == "cardinality":
        return {"value": _hll_estimate(state)}
    if kind == "avg":
        return {"value": state["sum"] / state["n"] if state["n"] else None}
    if kind == "sum":
        return {"value": state["sum"]}
    if kind in ("min", "max"):
        return {"value": state["v"]}
    n = state.get("n", 0)
    if kind in ("stats", "extended_stats"):
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
    if kind == "percentiles":
        pcts = spec.get("percents", [1, 5, 25, 50, 75, 95, 99])
        return {"values": {f"{float(p)}": _td_quantile(state, p / 100.0)
                           for p in pcts}}
    raise ParsingError(f"unknown metric aggregation [{kind}]")


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
    buckets = [_finalize_one_bucket(b, sub_spec)
               for b in node.get("buckets", [])]
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
    # range / date_range / ip_range: the first index's order
    return {**{k: v for k, v in node.items() if k != "buckets"},
            "buckets": buckets}
