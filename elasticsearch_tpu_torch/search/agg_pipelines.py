"""Pipeline aggregations: post-processing over computed aggregation outputs
(port of the pipelines of `elasticsearch_tpu/search/aggregations.py`).

A sibling pipeline (`avg_bucket`, `sum_bucket`, `max_bucket`,
`min_bucket`, `stats_bucket`, `extended_stats_bucket`,
`percentiles_bucket`) reads one value a bucket of another aggregation
through its `buckets_path` ("agg>metric", "agg>metric.value", "_count")
and answers as an aggregation of its own. A parent pipeline
(`derivative`, `cumulative_sum`, `serial_diff`, `moving_fn`,
`bucket_script`, `bucket_selector`, `bucket_sort`) writes into, filters or
reorders the buckets it reads and answers nothing. Declared as a
sub-aggregation of a bucket aggregation, a pipeline runs over that
aggregation's own bucket list (`run_parent_pipelines`); declared at the
top level, over the outputs of its siblings (`run_sibling_pipelines`),
which on the device rung are the boards' assembled outputs. A pipeline
declared under a bucket whose answer is not applied in place (a sibling
kind) lands under `__pipeline_results__` of that aggregation, as in the
reference.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)

_PARENT = "__parent__"
_PERCENTS = [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0]


def resolve_buckets_path(outputs: dict, path: str):
    """(node, buckets, one value a bucket) of "agg>metric" over outputs.
    A sibling pipeline steps into one multi-bucket aggregation only; a
    second one on the path, or a multi-value metric named without its
    value, is the reference's error."""
    agg_path, _, metric = path.partition(">")
    node = outputs.get(agg_path)
    if node is None:
        raise ParsingError(
            f"buckets_path [{path}] references unknown aggregation")
    buckets = node.get("buckets")
    if buckets is None:
        raise ParsingError(f"buckets_path [{path}] target has no buckets")
    bucket_list = list(buckets.values()) if isinstance(buckets, dict) \
        else buckets
    head = metric.split(">", 1)[0].split(".")[0] if metric else ""
    sample = bucket_list[0] if bucket_list else None
    if head and isinstance(sample, dict):
        inner = sample.get(head)
        if isinstance(inner, dict) and "buckets" in inner:
            got = "Object[]" if ">" in metric else "LongTerms"
            raise IllegalArgumentError(
                f"buckets_path must reference either a number value or a "
                f"single value numeric metric aggregation, got: [{got}] at "
                f"aggregation [{head}]")
        if isinstance(inner, dict) and "values" in inner \
                and "." not in metric:
            raise IllegalArgumentError(
                f"buckets_path must reference either a number value or a "
                f"single value numeric metric aggregation, but [{head}] "
                f"contains multiple values. Please specify which to use.")
    values: List[Optional[float]] = []
    for b in bucket_list:
        if not metric or metric == "_count":
            values.append(float(b["doc_count"]))
            continue
        m = b
        for part in metric.split("."):
            m = m.get(part) if isinstance(m, dict) else None
        if isinstance(m, dict):
            m = m.get("value")
        values.append(float(m) if m is not None else None)
    return node, buckets, values


def _extended_stats(present: List[float], sigma: float) -> dict:
    from elasticsearch_tpu_torch.search.aggregations import _extended_stats
    arr = np.asarray(present, dtype=np.float64)
    return _extended_stats(arr, np.ones(len(arr), dtype=bool), sigma)


def compute_pipeline(outputs: dict, kind: str, spec: dict,
                     name: str = "") -> Any:
    """One pipeline over outputs: a sibling kind's answer, or
    {"_applied": ...} for a kind that works on the buckets in place."""
    if kind in ("bucket_script", "bucket_selector", "bucket_sort"):
        return _bucket_pipeline(outputs, kind, spec)
    _, buckets, values = resolve_buckets_path(outputs,
                                              spec.get("buckets_path"))
    present = [v for v in values if v is not None]
    if kind == "avg_bucket":
        return {"value": sum(present) / len(present) if present else None}
    if kind == "sum_bucket":
        return {"value": sum(present) if present else 0.0}
    if kind in ("max_bucket", "min_bucket"):
        if not present:
            return {"value": None, "keys": []}
        best = (max if kind == "max_bucket" else min)(present)
        return {"value": best,
                "keys": [str(b.get("key")) for b, v in zip(buckets, values)
                         if v == best]}
    if kind == "stats_bucket":
        if not present:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        return {"count": len(present), "min": min(present),
                "max": max(present), "avg": sum(present) / len(present),
                "sum": sum(present)}
    if kind == "extended_stats_bucket":
        return _extended_stats(present, float(spec.get("sigma", 2.0)))
    if kind == "percentiles_bucket":
        arr = np.asarray(present, dtype=np.float64)
        return {"values": {
            f"{float(p)}": (float(np.percentile(arr, p)) if len(arr)
                            else None)
            for p in spec.get("percents", _PERCENTS)}}
    if kind == "cumulative_sum":
        total = 0.0
        for b, v in zip(buckets, values):
            total += v or 0.0
            b.setdefault(name, {})["value"] = total
        return {"_applied": True}
    if kind == "derivative":
        prev = None
        for b, v in zip(buckets, values):
            if prev is not None and v is not None:
                b.setdefault(name, {})["value"] = v - prev
            prev = v
        return {"_applied": True}
    if kind == "serial_diff":
        lag = int(spec.get("lag", 1))
        for i, b in enumerate(buckets):
            if i >= lag and values[i] is not None \
                    and values[i - lag] is not None:
                b.setdefault(name, {})["value"] = values[i] - values[i - lag]
        return {"_applied": True}
    if kind == "moving_fn":
        window = int(spec.get("window", 5))
        if window <= 0:
            raise IllegalArgumentError(
                "[window] must be a positive, non-zero integer.")
        for i, b in enumerate(buckets):
            win = [v for v in values[max(0, i - window):i] if v is not None]
            b.setdefault(name, {})["value"] = (sum(win) / len(win)) if win \
                else None
        return {"_applied": True}
    raise ParsingError(f"unknown pipeline aggregation [{kind}]")


_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b}
_CMPOPS = {ast.Gt: lambda a, b: a > b, ast.GtE: lambda a, b: a >= b,
           ast.Lt: lambda a, b: a < b, ast.LtE: lambda a, b: a <= b,
           ast.Eq: lambda a, b: a == b, ast.NotEq: lambda a, b: a != b}


def _eval_script(source: str, env: dict):
    """A bucket script's arithmetic or comparison over its variables
    (`params.x` read as `x`)."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            raise ParsingError(
                f"unknown variable [{node.id}] in bucket script")
        if isinstance(node, ast.BinOp):
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.Compare):
            return _CMPOPS[type(node.ops[0])](ev(node.left),
                                              ev(node.comparators[0]))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        raise ParsingError("unsupported bucket script construct")
    return ev(ast.parse(source.replace("params.", ""), mode="eval"))


def _bucket_pipeline(outputs: dict, kind: str, spec: dict) -> Any:
    """bucket_script (its value under the name `bucket_script`),
    bucket_selector and bucket_sort over the buckets their paths reach;
    a keyed bucket set (named filters) is read but not rewritten."""
    series: Dict[str, List[Optional[float]]] = {}
    buckets_ref = None
    for var, path in (spec.get("buckets_path", {}) or {}).items():
        _, buckets_ref, series[var] = resolve_buckets_path(outputs, path)
    if buckets_ref is None:
        return {"_applied": False}
    script = spec.get("script", "")
    source = script["source"] if isinstance(script, dict) else script

    def eval_for(i: int):
        env = {var: vals[i] for var, vals in series.items()}
        if any(v is None for v in env.values()):
            return None
        return _eval_script(source, env)

    bl = buckets_ref if isinstance(buckets_ref, list) \
        else list(buckets_ref.values())
    if kind == "bucket_script":
        name = spec.get("_name", "bucket_script")
        for i, b in enumerate(bl):
            v = eval_for(i)
            if v is not None:
                b.setdefault(name, {})["value"] = float(v)
        return {"_applied": True}
    if kind == "bucket_selector":
        keep = [bool(eval_for(i)) for i in range(len(bl))]
        bl[:] = [b for b, k in zip(bl, keep) if k]
        return {"_applied": True}
    if kind == "bucket_sort":
        for s in reversed(spec.get("sort", [])):
            if not isinstance(s, dict):
                continue
            ((path, order),) = s.items()
            direction = order.get("order", "asc") \
                if isinstance(order, dict) else order

            def keyfn(b, p=path):
                node = b
                for part in p.split("."):
                    node = node.get(part) if isinstance(node, dict) \
                        else None
                if isinstance(node, dict):
                    node = node.get("value")
                return node if node is not None else -math.inf
            bl.sort(key=keyfn, reverse=direction == "desc")
        frm = int(spec.get("from", 0))
        size = spec.get("size")
        bl[:] = bl[frm:frm + size if size is not None else None]
        return {"_applied": True}
    return {"_applied": False}


def run_parent_pipelines(out: dict, pipes: List[Tuple[str, str, dict]]
                         ) -> None:
    """A bucket aggregation's pipeline sub-aggregations over its own
    bucket list, in order."""
    for pname, pkind, pspec in pipes:
        pspec = dict(pspec)
        bp = pspec.get("buckets_path")
        if isinstance(bp, str):
            pspec["buckets_path"] = f"{_PARENT}>{bp}"
        elif isinstance(bp, dict):
            pspec["buckets_path"] = {k: f"{_PARENT}>{v}"
                                     for k, v in bp.items()}
        res = compute_pipeline({_PARENT: out}, pkind, pspec, pname)
        if not (isinstance(res, dict) and "_applied" in res):
            out.setdefault("__pipeline_results__", {})[pname] = res


def run_sibling_pipelines(out: dict, pipes: List[Tuple[str, str, dict]]
                          ) -> None:
    """The top level's pipelines over its outputs, in order: each answer
    joins the outputs (a later pipeline may read it)."""
    for name, kind, spec in pipes:
        res = compute_pipeline(out, kind, spec, name)
        if not (isinstance(res, dict) and "_applied" in res):
            out[name] = res
