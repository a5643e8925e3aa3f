"""The device rung of aggregations: plans of torch boards on the card (port
of `elasticsearch_tpu/search/agg_plan.py`, single device).

An aggregation body compiles into an `AggPlan` (`compile_plan`): each
top-level node is classified as device-eligible or host, with the host
node's reason. `AggEngine.compute` runs each eligible node as a few
`ops/aggs.py` calls over the index's resident columns (the matched rows
as a bool mask over the padded rows, bucket ids from the key columns,
boards of `n_buckets + 1` lanes), assembles the boards into the same JSON
the host path gives (`compute_aggs`, final mode) or the same `$p`
partial states (`compute_partial_aggs`, partial mode, so several indices
merge through `merge_partial_aggs` unchanged), and runs every other node
on the host path, node by node.

On the device: `terms` (keyword, numeric, boolean, date and ip fields;
`size`, `shard_size`, `missing`, `min_doc_count` 0, `order` by `_key` or
`_count`), `histogram` (`interval`, `offset`, `missing`,
`min_doc_count`, `extended_bounds`, `format`), `date_histogram` (fixed
and calendar intervals, `offset`, `format`, `time_zone`), `range`,
the metrics `avg`, `sum`, `min`, `max`, `stats`, `value_count` and
`cardinality` (exact in final mode, an HLL board in partial mode), and
bucket nodes nested up to TREE_MAX_DEPTH levels (one composite board a
path). A sum-bearing metric (`avg`, `sum`, `stats`) runs on the device
only over an integral column (`AggColumn.integral_exact`), where the
unordered f64 atomics of the card sum exactly; any other column takes
the host path (`non_integral_sum`).

A pipeline node (`host_reason="pipeline"`) is set aside: in final mode
the top-level pipelines run over the combined outputs of the pass, the
device nodes' assembled boards among them (`search/agg_pipelines.py`),
in partial mode at the coordinator's finalize. A bucket with a pipeline
sub-aggregation, and every kind the boards do not hold (`composite`,
the geo, significant and rare kinds, `top_hits`, the other metrics), is
a host node (`unsupported_sub_agg`, `unsupported_agg`), as in the
reference's plan.

No fallback hides the card: a node leaves the device only for a reason
the plan or the bind names (`_Fallback`, counted in
`stats["fallback_reasons"]`) or when the `CostRouter` (node setting
`search.aggs.cost_router`, default on) routes it; an error of a torch op
fails the request.

Left out: the JAX package's plan cache (`plan_cache_key`), its dispatch
warm-up and closed grid, which exist for compiled programs (eager PyTorch
plans each body, a few microseconds); the row-sharded mesh programs,
which wait for the multi-device path; the router's file persistence (the
port's node keeps no data path).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index.mapping import RangeFieldMapperBase
from elasticsearch_tpu_torch.ops import aggs as ops
from elasticsearch_tpu_torch.search import agg_partials as AP
from elasticsearch_tpu_torch.search import agg_pipelines as P
from elasticsearch_tpu_torch.search import aggregations as A

SUPPORTED_METRICS = ("avg", "sum", "min", "max", "stats", "value_count")
SUM_KINDS = ("avg", "sum", "stats")

# mapped types whose doc values the f64 column holds faithfully
_NUMERIC_TNAMES = ("long", "integer", "short", "byte", "double", "float",
                   "half_float", "scaled_float", "date", "date_nanos",
                   "boolean", "ip")
_TERMS_ALLOWED_KEYS = {"field", "size", "shard_size", "missing",
                       "min_doc_count", "order", "value_type"}
_HISTO_ALLOWED_KEYS = {"field", "interval", "offset", "min_doc_count",
                       "missing", "extended_bounds", "format"}
_DATE_HISTO_ALLOWED_KEYS = {"field", "interval", "fixed_interval",
                            "calendar_interval", "offset", "min_doc_count",
                            "format", "time_zone"}
_RANGE_ALLOWED_KEYS = {"field", "ranges", "keyed"}
_CARD_ALLOWED_KEYS = {"field", "precision_threshold", "missing"}
MAX_TREE_DEPTH = ops.TREE_MAX_DEPTH

# nominal calendar-unit lengths in millis: probe steps for the boundary
# walk, not bucket widths (`_calendar_floor` gives those)
_CAL_NOMINAL = {"T": 60_000, "H": 3_600_000, "D": 86_400_000,
                "W": 604_800_000, "M": 28 * 86_400_000,
                "Q": 90 * 86_400_000, "Y": 365 * 86_400_000}


class _Fallback(Exception):
    """A node the device cannot serve: run it on the host. `observed`
    carries the quantity off the ladder (an ordinal count)."""

    def __init__(self, reason: str, observed: Optional[int] = None):
        super().__init__(reason)
        self.reason = reason
        self.observed = observed


class _SubMetric:
    __slots__ = ("name", "kind", "field")

    def __init__(self, name, kind, field):
        self.name = name
        self.kind = kind
        self.field = field


class _Node:
    """One aggregation's classification. mode: 'host' | 'metric' |
    'cardinality' | 'terms' | 'histogram' | 'date_histogram' | 'range'.
    A bucket node carries metric leaves (`subs`), cardinality leaves
    (`cards`) and nested bucket nodes (`children`)."""

    __slots__ = ("name", "mode", "kind", "field", "subs", "host_reason",
                 "children", "cards")

    def __init__(self, name, mode, kind=None, field=None, subs=(),
                 host_reason=None, children=(), cards=()):
        self.name = name
        self.mode = mode
        self.kind = kind
        self.field = field
        self.subs = list(subs)
        self.host_reason = host_reason
        self.children = list(children)
        self.cards = list(cards)


class AggPlan:
    __slots__ = ("nodes", "device_count")

    def __init__(self, nodes: Dict[str, _Node]):
        self.nodes = nodes
        self.device_count = sum(1 for n in nodes.values()
                                if n.mode != "host")


# ---------------------------------------------------------------- compile

def _classify_metric(kind: str, body, mapper_service) -> Optional[str]:
    """None when device-eligible, else the host path's reason."""
    if not isinstance(body, dict):
        return "malformed"
    if body.get("script") is not None:
        return "script"
    field = body.get("field")
    if not isinstance(field, str):
        return "no_field"
    tname = getattr(mapper_service.get(field), "type_name", None)
    if tname is None:
        return "unmapped_field"
    if tname not in _NUMERIC_TNAMES:
        return "non_numeric_field"
    return None


def _classify_cardinality(body, mapper_service) -> Optional[str]:
    if not isinstance(body, dict):
        return "malformed"
    if not set(body) <= _CARD_ALLOWED_KEYS:
        return "unsupported_param"
    field = body.get("field")
    if not isinstance(field, str):
        return "no_field"
    tname = getattr(mapper_service.get(field), "type_name", None)
    if tname is None:
        return "unmapped_field"
    if tname not in _NUMERIC_TNAMES + ("keyword",):
        return "unsupported_field_type"
    return None


def _classify_bucket(kind: str, body: dict, mapper_service) -> str:
    field = body.get("field")
    if not isinstance(field, str) or field == "_index":
        return "no_field"
    if body.get("script") is not None:
        return "script"
    if kind == "terms":
        if not set(body) <= _TERMS_ALLOWED_KEYS:
            return "unsupported_param"
        order = body.get("order")
        if order is not None:
            if not (isinstance(order, dict) and len(order) == 1
                    and next(iter(order)) in ("_key", "_count")):
                return "order_by_metric"
            if next(iter(order)) == "_count" \
                    and int(body.get("min_doc_count", 1)) == 0:
                # zero-count buckets tie, and the host breaks the tie by
                # its term set's iteration order
                return "order_count_zero_buckets"
        return ""
    if kind == "histogram":
        return "" if set(body) <= _HISTO_ALLOWED_KEYS \
            else "unsupported_param"
    if kind == "date_histogram":
        if not set(body) <= _DATE_HISTO_ALLOWED_KEYS:
            return "unsupported_param"
        if isinstance(mapper_service.get(field), RangeFieldMapperBase):
            return "range_field"
        return ""
    if kind == "range":
        if not set(body) <= _RANGE_ALLOWED_KEYS:
            return "unsupported_param"
        ranges = body.get("ranges")
        if not isinstance(ranges, list) or not ranges or any(
                not isinstance(r, dict) or "mask" in r for r in ranges):
            return "unsupported_ranges"
        return ""
    return "unsupported_agg"


def _classify_subs(sub_spec: dict, mapper_service, depth: int = 1,
                   allow_buckets: bool = True):
    """A bucket node's sub-aggs -> (metric leaves, cardinality leaves,
    bucket children, reason). Children nest up to MAX_TREE_DEPTH; a range
    parent takes none (ranges overlap, so their rows do not partition
    into composite ids)."""
    subs: List[_SubMetric] = []
    cards: List[_SubMetric] = []
    children: List[_Node] = []
    for sname, sspec in (sub_spec or {}).items():
        if not isinstance(sspec, dict):
            return [], [], [], "malformed_sub"
        skinds = [k for k in sspec if k not in ("aggs", "aggregations",
                                                "meta")]
        if len(skinds) != 1:
            return [], [], [], "unsupported_sub_agg"
        skind = skinds[0]
        inner = A.sub_aggs_of(sspec)
        if skind in SUPPORTED_METRICS or skind == "cardinality":
            if inner:
                return [], [], [], "sub_sub_aggs"
            reason = (_classify_cardinality(sspec[skind], mapper_service)
                      if skind == "cardinality" else
                      _classify_metric(skind, sspec[skind], mapper_service))
            if reason is not None:
                return [], [], [], f"sub_{reason}"
            leaf = _SubMetric(sname, skind, sspec[skind]["field"])
            (cards if skind == "cardinality" else subs).append(leaf)
            continue
        if skind in ("terms", "histogram", "date_histogram") \
                and isinstance(sspec[skind], dict):
            if not allow_buckets:
                return [], [], [], "unsupported_sub_agg"
            if depth >= MAX_TREE_DEPTH:
                return [], [], [], "tree_too_deep"
            body = sspec[skind]
            reason = _classify_bucket(skind, body, mapper_service)
            if reason:
                return [], [], [], f"sub_{reason}"
            if skind == "terms" and isinstance(body.get("order"), dict) \
                    and next(iter(body["order"])) == "_count":
                # an explicit _count order below the root would need the
                # first occurrence inside every parent bucket
                return [], [], [], "order_count_in_subtree"
            csubs, ccards, cchildren, creason = _classify_subs(
                inner, mapper_service, depth + 1)
            if creason:
                return [], [], [], creason
            children.append(_Node(sname, skind, kind=skind,
                                  field=body.get("field"), subs=csubs,
                                  cards=ccards, children=cchildren))
            continue
        return [], [], [], "unsupported_sub_agg"
    return subs, cards, children, ""


def compile_plan(aggs_spec: dict, mapper_service) -> AggPlan:
    nodes: Dict[str, _Node] = {}
    for name, spec in (aggs_spec or {}).items():
        if not isinstance(spec, dict):
            nodes[name] = _Node(name, "host", host_reason="malformed")
            continue
        kinds = [k for k in spec if k not in ("aggs", "aggregations",
                                              "meta")]
        if len(kinds) != 1:
            nodes[name] = _Node(name, "host", host_reason="malformed")
            continue
        kind = kinds[0]
        body = spec[kind]
        sub_spec = A.sub_aggs_of(spec)
        if kind in A.PIPELINE_AGGS:
            nodes[name] = _Node(name, "host", kind=kind,
                                host_reason="pipeline")
            continue
        if kind in SUPPORTED_METRICS and not sub_spec:
            reason = _classify_metric(kind, body, mapper_service)
            nodes[name] = (_Node(name, "metric", kind=kind,
                                 field=body["field"]) if reason is None
                           else _Node(name, "host", kind=kind,
                                      host_reason=reason))
            continue
        if kind == "cardinality" and not sub_spec:
            reason = _classify_cardinality(body, mapper_service)
            nodes[name] = (_Node(name, "cardinality", kind=kind,
                                 field=body["field"]) if reason is None
                           else _Node(name, "host", kind=kind,
                                      host_reason=reason))
            continue
        if kind in ("terms", "histogram", "date_histogram", "range") \
                and isinstance(body, dict):
            reason = _classify_bucket(kind, body, mapper_service)
            subs, cards, children = [], [], []
            if not reason:
                subs, cards, children, reason = _classify_subs(
                    sub_spec, mapper_service, allow_buckets=kind != "range")
            if not reason and kind == "range" and cards:
                reason = "unsupported_sub_agg"
            nodes[name] = (_Node(name, kind, kind=kind,
                                 field=body.get("field"), subs=subs,
                                 cards=cards, children=children)
                           if not reason else
                           _Node(name, "host", kind=kind, host_reason=reason))
            continue
        nodes[name] = _Node(name, "host", kind=kind,
                            host_reason="unsupported_agg")
    return AggPlan(nodes)


# ----------------------------------------------------------------- router

class CostRouter:
    """Device-or-host choice a node family from live timings: a device
    run records its nanos (dispatch and assembly), a host run its nanos a
    matched doc, each as an EWMA. A node takes the device when the device
    estimate beats the host's with MARGIN; every REPROBE-th host decision
    probes the device to keep the estimate live. The priors, before any
    timing, are the JAX package's and favour the device; the port has not
    measured its own."""

    EWMA = 0.25
    MARGIN = 1.25
    REPROBE = 32
    DEV_PRIOR_BASE = 250_000.0      # ns a call
    DEV_PRIOR_PER_ROW = 0.5         # ns a padded row
    HOST_PRIOR_BASE = 30_000.0
    HOST_PRIOR_PER_DOC = 400.0      # ns a matched doc

    def __init__(self):
        self._lock = threading.Lock()
        self._dev: Dict[str, float] = {}
        self._host: Dict[str, float] = {}
        self._miss: Dict[str, int] = {}
        self.decisions: Dict[str, int] = {"device": 0, "probe": 0,
                                          "host": 0}

    def est_device(self, fam: str, r_pad: int) -> float:
        with self._lock:
            d = self._dev.get(fam)
        return d if d is not None else (
            self.DEV_PRIOR_BASE + self.DEV_PRIOR_PER_ROW * r_pad)

    def est_host(self, fam: str, n_docs: int) -> float:
        with self._lock:
            rate = self._host.get(fam, self.HOST_PRIOR_PER_DOC)
        return self.HOST_PRIOR_BASE + rate * max(n_docs, 1)

    def decide(self, fam: str, n_docs: int, r_pad: int) -> str:
        """'device' | 'probe' | 'host'."""
        if self.est_host(fam, n_docs) * self.MARGIN \
                >= self.est_device(fam, r_pad):
            route = "device"
            with self._lock:
                self._miss.pop(fam, None)
        else:
            with self._lock:
                streak = self._miss.get(fam, 0) + 1
                route = "probe" if streak >= self.REPROBE else "host"
                self._miss[fam] = 0 if route == "probe" else streak
        with self._lock:
            self.decisions[route] += 1
        return route

    def _ewma(self, table: Dict[str, float], fam: str, x: float) -> None:
        with self._lock:
            prev = table.get(fam)
            table[fam] = x if prev is None else prev + self.EWMA * (x - prev)

    def observe_device(self, fam: str, nanos: int) -> None:
        self._ewma(self._dev, fam, float(nanos))

    def observe_host(self, fam: str, nanos: int, n_docs: int) -> None:
        self._ewma(self._host, fam, float(nanos) / max(n_docs, 1))

    def snapshot(self) -> dict:
        with self._lock:
            return {"device_ns": dict(self._dev),
                    "host_ns_per_doc": dict(self._host),
                    "decisions": dict(self.decisions)}


def _family(node: _Node) -> str:
    """The router's family: the mode, `_tree` for composite boards."""
    return node.mode + ("_tree" if node.children or node.cards else "")


def _sub_spec(spec: dict, name: str) -> dict:
    return A.sub_aggs_of(spec).get(name) or {}


def _sub_body(spec: dict, name: str) -> dict:
    for k, v in _sub_spec(spec, name).items():
        if k not in ("aggs", "aggregations", "meta"):
            return v if isinstance(v, dict) else {}
    return {}


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _np_board(board) -> tuple:
    return tuple(_np(x) for x in board)


# ----------------------------------------------------------------- engine

class AggEngine:
    """One index's device aggregations: its column store, the router, and
    the node-by-node split between the device and the host path.
    `compute` returns (aggregations, profile), final JSON or `$p` partial
    states, or None when no node is device-eligible (the caller runs the
    host path)."""

    def __init__(self, mapper_service, device, cost_router=None):
        self.mapper_service = mapper_service
        self.device = torch.device(device)
        self.store = ops.AggFieldStore()
        self.cost_router: Optional[CostRouter] = cost_router
        self._lock = threading.Lock()
        self._cal_cache: Dict[tuple, tuple] = {}
        self._zeros: Dict[int, torch.Tensor] = {}
        self.stats = {
            "searches": 0, "device_nodes": 0, "host_nodes": 0,
            "device_nanos": 0, "assemble_nanos": 0, "host_nanos": 0,
            "router_host_routed": 0, "router_probes": 0,
            "fallback_reasons": {},
        }

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def _reason(self, reason: str, docs: int = 0,
                observed: Optional[int] = None) -> None:
        """fallback_reasons: {reason: {count, docs[, observed_max]}}."""
        with self._lock:
            ent = self.stats["fallback_reasons"].setdefault(
                reason, {"count": 0, "docs": 0})
            ent["count"] += 1
            ent["docs"] += int(docs)
            if observed is not None:
                ent["observed_max"] = max(int(observed),
                                          ent.get("observed_max", 0))

    # -------------------------------------------------------------- compute
    def compute(self, ctx, rows: np.ndarray, aggs_spec: dict,
                partial: bool = False) -> Optional[Tuple[dict, dict]]:
        if getattr(ctx, "nested_path", None):
            # under a nested scope a bucket counts value occurrences,
            # which the device boards do not
            return None
        plan = compile_plan(aggs_spec, self.mapper_service)
        if plan.device_count == 0:
            for node in plan.nodes.values():
                if node.host_reason != "pipeline":
                    self._reason(node.host_reason, docs=len(rows))
                    self._count("host_nodes")
            return None
        self._count("searches")
        # one row-space snapshot for the whole pass
        box: Dict[str, Any] = {"snap": self.store.snapshot(ctx.reader)}
        out: Dict[str, Any] = {}
        pipelines: List[Tuple[str, str, dict]] = []
        prof_nodes: List[dict] = []
        nanos = {"device": 0, "assemble": 0, "host": 0}
        for name, spec in aggs_spec.items():
            kind = A.agg_kind(name, spec)
            if kind in A.PIPELINE_AGGS:
                # over the combined outputs below (partial mode: at the
                # coordinator's finalize)
                if not partial:
                    pipelines.append((name, kind, spec[kind]))
                continue
            node = plan.nodes[name]
            res = None
            engine, fam = "host", None
            reason = node.host_reason
            if node.mode != "host":
                fam = _family(node)
                route = "device"
                if self.cost_router is not None:
                    route = self.cost_router.decide(fam, len(rows),
                                                    box["snap"].r_pad)
                if route == "host":
                    reason = "routed_host_cheaper"
                    self._reason(reason, docs=len(rows))
                    self._count("router_host_routed")
                else:
                    if route == "probe":
                        self._count("router_probes")
                    try:
                        t0 = time.perf_counter_ns()
                        boards = self._run_device_node(ctx, node, spec,
                                                       rows, box, partial)
                        t1 = time.perf_counter_ns()
                        res = self._assemble_node(ctx, node, spec, boards,
                                                  partial)
                        t2 = time.perf_counter_ns()
                        nanos["device"] += t1 - t0
                        nanos["assemble"] += t2 - t1
                        engine = "device"
                        self._count("device_nodes")
                        if self.cost_router is not None:
                            self.cost_router.observe_device(fam, t2 - t0)
                    except _Fallback as fb:
                        reason = fb.reason
                        self._reason(fb.reason, docs=len(rows),
                                     observed=fb.observed)
            elif reason:
                self._reason(reason, docs=len(rows))
            if res is None:
                sub = {name: spec}
                th0 = time.perf_counter_ns()
                res = (AP.compute_partial_aggs(ctx, rows, sub) if partial
                       else A.compute_aggs(ctx, rows, sub))[name]
                th1 = time.perf_counter_ns()
                nanos["host"] += th1 - th0
                self._count("host_nodes")
                if self.cost_router is not None and fam is not None:
                    self.cost_router.observe_host(fam, th1 - th0, len(rows))
            elif not partial:
                _with_meta(res, spec)
            out[name] = res
            prof_nodes.append({"name": name, "engine": engine,
                               **({"fallback_reason": reason}
                                  if engine == "host" and reason else {})})
        P.run_sibling_pipelines(out, pipelines)
        with self._lock:
            self.stats["device_nanos"] += nanos["device"]
            self.stats["assemble_nanos"] += nanos["assemble"]
            self.stats["host_nanos"] += nanos["host"]
        profile = {"nodes": prof_nodes, "device_nanos": nanos["device"],
                   "assemble_nanos": nanos["assemble"]}
        if self.store.columnar_refresh:
            # each column's last build, for `profile.shards[].columnar`
            profile["columnar"] = {f: dict(v) for f, v in
                                   self.store.columnar_refresh.items()}
        return out, profile

    # ------------------------------------------------------------- binding
    def _mask(self, rows, box) -> torch.Tensor:
        if "mask_t" not in box:
            box["mask"] = box["snap"].filter_mask(rows)
            box["mask_t"] = torch.from_numpy(box["mask"]).to(self.device)
        return box["mask_t"]

    def _zero_ords(self, r_pad: int) -> torch.Tensor:
        z = self._zeros.get(r_pad)
        if z is None:
            self._zeros.clear()
            z = self._zeros[r_pad] = torch.zeros(
                r_pad, dtype=torch.int32, device=self.device)
        return z

    def _arrays(self, col) -> tuple:
        return col.device_arrays(self.device)

    @staticmethod
    def _check_metric_col(kind: str, col) -> None:
        if kind in SUM_KINDS and not col.integral_exact:
            raise _Fallback("non_integral_sum")
        if kind == "value_count" and col.multi_valued:
            # value_count counts every value; the column keeps a doc's first
            raise _Fallback("multi_valued_field")

    def _metric_cols(self, ctx, node, snap) -> dict:
        cols = {}
        for m in node.subs:
            col = self.store.column(ctx.reader, m.field, snap=snap)
            self._check_metric_col(m.kind, col)
            cols[m.name] = (m, col)
        return cols

    @staticmethod
    def _missing(mspec: dict) -> Optional[float]:
        missing = mspec.get("missing")
        if missing is None:
            return None
        try:
            return float(missing)
        except (TypeError, ValueError):
            raise _Fallback("bad_missing_value")

    def _metric_boards(self, mcols, spec, call) -> dict:
        out = {}
        for mname, (_m, mc) in mcols.items():
            mv, mp = self._arrays(mc)[:2]
            out[mname] = _np_board(call(self._missing(_sub_body(spec, mname)),
                                        mv, mp))
        return out

    def _run_device_node(self, ctx, node, spec, rows, box, partial) -> dict:
        if node.mode == "cardinality" or node.children or node.cards:
            return self._run_tree_node(ctx, node, spec, rows, box, partial)
        store, reader, snap = self.store, ctx.reader, box["snap"]
        body = spec[node.kind]
        boards: Dict[str, Any] = {}
        if node.mode == "terms":
            col = store.column(reader, node.field, want_ords=True, snap=snap)
            if col.multi_valued:
                raise _Fallback("multi_valued_field")
            b = ops.bucket_count(max(len(col.ord_keys), 1))
            if b is None:
                raise _Fallback("cardinality_off_grid",
                                observed=len(col.ord_keys))
            mcols = self._metric_cols(ctx, node, snap)
            mask = self._mask(rows, box)
            ords = self._arrays(col)[2]
            counts = ops.ord_counts(ords, mask, b)
            boards["metrics"] = self._metric_boards(
                mcols, spec, lambda miss, mv, mp: ops.ord_metric(
                    ords, mask, miss, mv, mp, b))
            boards.update(counts=_np(counts), col=col, mask=box["mask"])
        elif node.mode in ("histogram", "date_histogram"):
            col = store.column(reader, node.field, snap=snap)
            hp, meta = self._hist_params(node, body, col)
            boards["hist_meta"] = meta
            b = meta["n_buckets"]
            mcols = self._metric_cols(ctx, node, snap)
            if b == 0:
                # nothing present and no missing substitute
                boards.update(counts=np.zeros(1, dtype=np.int64), metrics={
                    n: (np.zeros(1, np.int64), np.zeros(1, np.float64),
                        np.full(1, np.inf), np.full(1, -np.inf))
                    for n in mcols})
                return boards
            mask = self._mask(rows, box)
            keys, kp = self._arrays(col)[:2]
            cal = meta.get("cal_args")
            if cal is not None:
                cb = torch.from_numpy(cal[0]).to(self.device)
                counts = ops.cal_counts(keys, kp, mask, cb, cal[1], b)
                boards["metrics"] = self._metric_boards(
                    mcols, spec, lambda miss, mv, mp: ops.cal_metric(
                        keys, kp, mask, cb, cal[1], miss, mv, mp, b))
            else:
                counts = ops.hist_counts(keys, kp, mask, hp, b)
                boards["metrics"] = self._metric_boards(
                    mcols, spec, lambda miss, mv, mp: ops.hist_metric(
                        keys, kp, mask, hp, miss, mv, mp, b))
            boards["counts"] = _np(counts)
        elif node.mode == "range":
            col = store.column(reader, node.field, snap=snap)
            bounds, frm_to = self._range_bounds(body)
            boards["frm_to"] = frm_to
            kmiss = self._missing(body)
            mcols = self._metric_cols(ctx, node, snap)
            mask = self._mask(rows, box)
            keys, kp = self._arrays(col)[:2]
            bt = torch.from_numpy(bounds).to(self.device)
            counts = ops.range_counts(keys, kp, mask, bt, kmiss)
            boards["metrics"] = self._metric_boards(
                mcols, spec, lambda miss, mv, mp: ops.range_metric(
                    keys, kp, mask, bt, kmiss, miss, mv, mp))
            boards["counts"] = _np(counts)
        elif node.mode == "metric":
            col = store.column(reader, node.field, snap=snap)
            self._check_metric_col(node.kind, col)
            mask = self._mask(rows, box)
            mv, mp = self._arrays(col)[:2]
            boards["metric"] = _np_board(ops.ord_metric(
                self._zero_ords(snap.r_pad), mask, self._missing(body), mv,
                mp, ops.AGG_B_LADDER[0]))
        return boards

    # ------------------------------------------------------------ trees
    def _run_tree_node(self, ctx, node, spec, rows, box, partial) -> dict:
        """Composite boards: each bucket level along a path binds its id
        source (ordinals, histogram floor, calendar table) and every tree
        node gets one flat board a counts, metric or cardinality leaf,
        whose lane is `parent_id * k_child + child_id` over its chain. A
        top-level `cardinality` is the case with no level."""
        store, reader, snap = self.store, ctx.reader, box["snap"]
        mask = self._mask(rows, box)
        boards: Dict[str, Any] = {"mask": box["mask"]}

        def bind_level(child, body):
            if child.kind == "terms":
                col = store.column(reader, child.field, want_ords=True,
                                   snap=snap)
                if col.multi_valued:
                    raise _Fallback("multi_valued_field")
                miss = body.get("missing") is not None
                k = ops.bucket_count(max(len(col.ord_keys), 1)
                                     + (1 if miss else 0))
                if k is None:
                    raise _Fallback("cardinality_off_grid",
                                    observed=len(col.ord_keys))
                return {"kind": "ord", "k": k,
                        "args": (self._arrays(col)[2], miss),
                        "col": col, "meta": None}
            col = store.column(reader, child.field, snap=snap)
            hp, meta = self._hist_params(child, body, col)
            k = meta["n_buckets"]
            if k == 0:
                # no key and no substitute: the subtree's boards are zero
                return {"kind": "empty", "k": 0, "args": (), "col": col,
                        "meta": meta}
            keys, kp = self._arrays(col)[:2]
            cal = meta.get("cal_args")
            if cal is not None:
                cb = torch.from_numpy(cal[0]).to(self.device)
                return {"kind": "cal", "k": k, "args": (keys, kp, cb, cal[1]),
                        "col": col, "meta": meta}
            return {"kind": "hist", "k": k, "args": (keys, kp, hp),
                    "col": col, "meta": meta}

        def levels_of(chain):
            return [(lv["kind"], lv["k"], lv["args"]) for lv in chain]

        def bind_card(body, chain, total, empty):
            field = body.get("field")
            if partial:
                # the host's HLL walker ignores `missing`; so does this
                col = store.column(reader, field, want_hll=True, snap=snap)
                if col.multi_valued:
                    raise _Fallback("multi_valued_field")
                if total > ops.HLL_MAX_LANES:
                    raise _Fallback("hll_off_grid")
                if empty:
                    return {"partial": True, "board": None, "body": body}
                arr = self._arrays(col)
                return {"partial": True, "body": body, "board": _np(
                    ops.hll_board(mask, arr[3], arr[4], levels_of(chain)))}
            # final mode is exact (the host counts a set): the field rides
            # one more ordinal level of a counts board
            col = store.column(reader, field, want_ords=True, snap=snap)
            if col.multi_valued:
                raise _Fallback("multi_valued_field")
            miss = body.get("missing") is not None
            k_card = ops.bucket_count(max(len(col.ord_keys), 1)
                                      + (1 if miss else 0))
            if k_card is None:
                raise _Fallback("cardinality_off_grid",
                                observed=len(col.ord_keys))
            if total * k_card > ops.TREE_MAX_LANES:
                raise _Fallback("tree_off_grid")
            rec = {"partial": False, "board": None, "k": k_card, "col": col,
                   "miss": miss, "body": body}
            if not empty:
                rec["board"] = _np(ops.tree_counts(
                    mask, levels_of(chain)
                    + [("ord", k_card, (self._arrays(col)[2], miss))]))
            return rec

        def run_node(node_, spec_node, chain):
            ks = tuple(lv["k"] for lv in chain)
            empty = any(lv["kind"] == "empty" for lv in chain)
            total = int(np.prod(ks)) if ks else 1
            if not empty and total > ops.TREE_MAX_LANES:
                raise _Fallback("tree_off_grid")
            levels = levels_of(chain)
            tnode: Dict[str, Any] = {"node": node_, "chain": chain,
                                     "ks": ks, "mask": box["mask"]}
            tnode["counts"] = None if empty else _np(
                ops.tree_counts(mask, levels))
            metrics = {}
            for m in node_.subs:
                mcol = store.column(reader, m.field, snap=snap)
                self._check_metric_col(m.kind, mcol)
                if empty:
                    metrics[m.name] = None
                    continue
                mv, mp = self._arrays(mcol)[:2]
                metrics[m.name] = _np_board(ops.tree_metric(
                    mask, self._missing(_sub_body(spec_node, m.name)), mv,
                    mp, levels))
            tnode["metrics"] = metrics
            tnode["cards"] = {c.name: bind_card(_sub_body(spec_node, c.name),
                                                chain, total, empty)
                              for c in node_.cards}
            children = {}
            sub_spec = A.sub_aggs_of(spec_node)
            for ch in node_.children:
                ch_spec = sub_spec[ch.name]
                children[ch.name] = run_node(
                    ch, ch_spec, chain + [bind_level(ch, ch_spec[ch.kind])])
            tnode["children"] = children
            return tnode

        if node.mode == "cardinality":
            boards["tree"] = {
                "node": node, "chain": [], "ks": (), "counts": None,
                "metrics": {}, "children": {},
                "cards": {node.name: bind_card(spec[node.kind], [], 1,
                                               False)}}
        else:
            boards["tree"] = run_node(
                node, spec, [bind_level(node, spec[node.kind])])
        return boards

    def _calendar_bounds(self, field, col, unit, tz_spec, offset, div):
        """The sorted `_calendar_floor` boundaries over the column's
        [vmin, vmax] for one (unit, time zone), cached a column version:
        walked boundary to boundary by a nominal step corrected with the
        true floor, so DST days and months of any length land where the
        host puts them."""
        key = (field, col.version, unit, str(tz_spec), offset, div)
        cached = self._cal_cache.get(key)
        if cached is not None:
            return cached
        tz = A._resolve_tz(tz_spec)
        lo = math.trunc(col.vmin / div - offset)
        hi = math.trunc(col.vmax / div - offset)
        nominal = _CAL_NOMINAL[unit]
        if (hi - lo) / nominal + 2 > ops.CAL_MAX_BUCKETS:
            raise _Fallback("span_off_grid")
        cur = A._calendar_floor(int(lo), unit, tz)
        bounds = [cur]
        while True:
            # probe past the boundary, longer if a short step stays inside
            step = nominal
            nxt = A._calendar_floor(int(cur + step), unit, tz)
            while nxt <= cur:
                step += 3_600_000
                nxt = A._calendar_floor(int(cur + step), unit, tz)
            # back up if the probe overshot a boundary (DST-short days)
            back = A._calendar_floor(int(nxt - 1), unit, tz)
            while back > cur:
                nxt = back
                back = A._calendar_floor(int(nxt - 1), unit, tz)
            if nxt > hi:
                break
            bounds.append(nxt)
            cur = nxt
            if len(bounds) > ops.CAL_MAX_BUCKETS + 2:
                raise _Fallback("span_off_grid")
        if len(self._cal_cache) >= 64:
            self._cal_cache.clear()
        entry = self._cal_cache[key] = (tuple(bounds), tz)
        return entry

    def _hist_params(self, node, body, col):
        """(hp, meta) of a histogram level: hp = (interval, offset, base,
        div, key missing or None) for `_hist_ids`; meta what assembly
        reads (n_buckets 0 when no key is present)."""
        date = node.mode == "date_histogram"
        missing = None
        div = 1.0
        if date:
            interval, calendar = A._date_interval(body)
            offset = A._date_offset_ms(body.get("offset"))
            if getattr(self.mapper_service.get(node.field), "type_name",
                       None) == "date_nanos":
                div = 1e6
            if calendar:
                meta = {"interval": 0.0, "offset": offset, "base": 0.0,
                        "date": True, "fmt": body.get("format"),
                        "tz": A._resolve_tz(body.get("time_zone"))}
                if col.vmin is None:
                    return None, {**meta, "n_buckets": 0, "cal_bounds": ()}
                if not (math.isfinite(col.vmin) and math.isfinite(col.vmax)):
                    raise _Fallback("non_finite_keys")
                real, tz = self._calendar_bounds(
                    node.field, col, calendar, body.get("time_zone"),
                    offset, div)
                b = ops.bucket_count(len(real))
                if b is None:
                    raise _Fallback("span_off_grid")
                cbounds = np.full(b, np.inf, dtype=np.float64)
                cbounds[: len(real)] = real
                return None, {**meta, "tz": tz, "n_buckets": b,
                              "cal_bounds": real,
                              "cal_args": (cbounds, (div, offset))}
        else:
            try:
                interval = float(body["interval"])
            except (KeyError, TypeError, ValueError):
                raise _Fallback("bad_interval")
            offset = float(body.get("offset", 0.0))
            missing = body.get("missing")
        if not (interval > 0) or not math.isfinite(interval):
            raise _Fallback("bad_interval")
        vmin, vmax = col.vmin, col.vmax
        if div != 1.0 and vmin is not None:
            vmin, vmax = vmin / div, vmax / div
        kmiss = None
        if missing is not None:
            try:
                kmiss = float(missing)
            except (TypeError, ValueError):
                raise _Fallback("bad_missing_value")
            if vmin is None:
                vmin = vmax = kmiss
            elif not bool(col.present[: col.n_rows].all()):
                vmin, vmax = min(vmin, kmiss), max(vmax, kmiss)
        if vmin is None:
            base, n_buckets = 0.0, 0
        elif not (math.isfinite(vmin) and math.isfinite(vmax)):
            raise _Fallback("non_finite_keys")
        else:
            base = math.floor((vmin - offset) / interval)
            top = math.floor((vmax - offset) / interval)
            n_buckets = ops.bucket_count(int(top - base) + 1)
            if n_buckets is None:
                raise _Fallback("span_off_grid")
        meta = {"interval": interval, "offset": offset, "base": base,
                "date": date, "n_buckets": n_buckets,
                "fmt": body.get("format"),
                "tz": A._resolve_tz(body.get("time_zone")) if date
                else None}
        return (interval, offset, float(base), div, kmiss), meta

    @staticmethod
    def _range_bounds(body):
        ranges = body.get("ranges", [])
        b = ops.bucket_count(len(ranges))
        if b is None:
            raise _Fallback("ranges_off_grid")
        bounds = np.full((b, 2), np.inf, dtype=np.float64)
        frm_to = []
        for i, r in enumerate(ranges):
            try:
                frm = float(r["from"]) if r.get("from") is not None else None
                to = float(r["to"]) if r.get("to") is not None else None
            except (TypeError, ValueError):
                raise _Fallback("bad_range_bound")
            bounds[i, 0] = -np.inf if frm is None else frm
            bounds[i, 1] = np.inf if to is None else to
            frm_to.append((frm, to))
        return bounds, frm_to

    # ------------------------------------------------------------ assembly
    def _assemble_node(self, ctx, node, spec, boards, partial):
        if "tree" in boards:
            if node.mode == "cardinality":
                return self._card_out(boards["tree"]["cards"][node.name],
                                      [0], partial, node.name)
            return self._assemble_tree(ctx, boards["tree"], spec, [0],
                                       partial)
        body = spec[node.kind]
        if node.mode == "metric":
            cnt, s, mn, mx = boards["metric"]
            return self._metric_out(node.kind, int(cnt[0]), float(s[0]),
                                    float(mn[0]), float(mx[0]), node.field,
                                    partial)
        if node.mode == "terms":
            return self._assemble_terms(ctx, node, body, spec, boards,
                                        partial)
        if node.mode in ("histogram", "date_histogram"):
            return self._assemble_histo(ctx, body, spec, boards, partial)
        return self._assemble_range(body, spec, boards, partial)

    def _metric_out(self, kind, cnt, s, mn, mx, field, partial):
        if partial:
            if kind == "value_count":
                return {"$p": "value_count", "n": int(cnt)}
            if kind == "avg":
                return {"$p": "avg", "sum": float(s), "n": int(cnt)}
            if kind == "sum":
                return {"$p": "sum", "sum": float(s)}
            if kind in ("min", "max"):
                return {"$p": kind,
                        "v": float(mn if kind == "min" else mx)
                        if cnt else None}
            return {"$p": "stats", "n": int(cnt), "sum": float(s),
                    "min": float(mn) if cnt else None,
                    "max": float(mx) if cnt else None}
        if kind == "value_count":
            return {"value": int(cnt)}
        if kind == "avg":
            out = {"value": s / cnt if cnt else None}
            tname = getattr(self.mapper_service.get(field), "type_name",
                            None) if field else None
            if out["value"] is not None and tname in ("date", "date_nanos"):
                ms = out["value"] / 1e6 if tname == "date_nanos" \
                    else out["value"]
                out["value_as_string"] = A._millis_to_iso(int(round(ms)))
            return out
        if kind == "sum":
            return {"value": float(s)}
        if kind in ("min", "max"):
            return {"value": float(mn if kind == "min" else mx)
                    if cnt else None}
        if cnt == 0:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        return {"count": int(cnt), "min": float(mn), "max": float(mx),
                "avg": s / cnt, "sum": float(s)}

    def _leaf_out(self, spec, mname, c, ss, m1, m2, partial):
        sspec = _sub_spec(spec, mname)
        kind = A.agg_kind(mname, sspec)
        out = self._metric_out(kind, c, ss, m1, m2,
                               sspec[kind].get("field"), partial)
        return out if partial else _with_meta(out, sspec)

    def _sub_outputs(self, b, lane, metrics, spec, partial, merge_lane=None):
        for mname, (cnt, s, mn, mx) in metrics.items():
            c, ss, m1, m2 = (int(cnt[lane]), float(s[lane]),
                             float(mn[lane]), float(mx[lane]))
            if merge_lane is not None:
                c += int(cnt[merge_lane])
                ss += float(s[merge_lane])
                m1 = min(m1, float(mn[merge_lane]))
                m2 = max(m2, float(mx[merge_lane]))
            b[mname] = self._leaf_out(spec, mname, c, ss, m1, m2, partial)

    def _empty_sub_outputs(self, b, metrics, spec, partial):
        # a gap-filled bucket has no rows, whatever `missing` says
        for mname in metrics:
            b[mname] = self._leaf_out(spec, mname, 0, 0.0, float("inf"),
                                      float("-inf"), partial)

    def _terms_items(self, ctx, col, body, counts, trash_lane, partial,
                     mask=None):
        """(items [key, count, lane, merge lane] sorted and cut, the other
        docs' count, the field's type name) of one terms level."""
        tname = getattr(self.mapper_service.get(body["field"]),
                        "type_name", None) or body.get("value_type")
        size = int(body.get("size", 10))
        if partial:
            size = int(body.get("shard_size") or (size * 3 // 2 + 10))
        key_index = {A._hashable(k): i for i, k in enumerate(col.ord_keys)}
        items = [[A._hashable(k), int(counts[i]), i, None]
                 for i, k in enumerate(col.ord_keys)]
        if body.get("missing") is not None:
            mv = A._coerce_missing(body["missing"], tname)
            miss_cnt = int(counts[trash_lane])
            ki = key_index.get(A._hashable(mv))
            if ki is not None:
                items[ki][1] += miss_cnt
                items[ki][3] = trash_lane
            elif miss_cnt > 0:
                items.append([A._hashable(mv), miss_cnt, trash_lane, None])
        if int(body.get("min_doc_count", 1)) != 0:
            items = [it for it in items if it[1] > 0]
        order = body.get("order")
        if not partial and order and isinstance(order, dict):
            ((okey, odir),) = order.items()
            reverse = odir == "desc"
            if okey == "_key":
                items.sort(key=lambda it: A._sort_key(it[0]),
                           reverse=reverse)
            else:
                # host ties keep the first occurrence among the matched
                # rows: recover it from the mask, then a stable count sort
                marr = col.ords[: col.n_rows][mask[: col.n_rows]]
                uniq, first = np.unique(marr[marr >= 0], return_index=True)
                pos = dict(zip(uniq.tolist(), first.tolist()))
                items.sort(key=lambda it: pos.get(it[2], float("inf")))
                items.sort(key=lambda it: (it[1],), reverse=reverse)
        else:
            items.sort(key=lambda it: (-it[1], A._sort_key(it[0])))
        other = sum(it[1] for it in items[size:])
        A._check_max_buckets(ctx, min(len(items), size))
        return items[:size], other, tname

    def _assemble_terms(self, ctx, node, body, spec, boards, partial):
        counts, metrics = boards["counts"], boards["metrics"]
        items, other, tname = self._terms_items(
            ctx, boards["col"], body, counts, len(counts) - 1, partial,
            boards.get("mask"))
        buckets = []
        for key, c, lane, merge_lane in items:
            b = {"key": key, "doc_count": int(c)}
            self._sub_outputs(b, lane, metrics, spec, partial, merge_lane)
            buckets.append(b)
        A.format_terms_keys(buckets, tname)
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": int(other), "buckets": buckets}

    def _histo_keys(self, meta, counts, n_lanes):
        """{float key: lane} of the lanes holding rows."""
        groups: Dict[float, int] = {}
        cal_bounds = meta.get("cal_bounds")
        if cal_bounds is not None:
            for i in range(min(n_lanes, len(cal_bounds))):
                if int(counts[i]) > 0:
                    groups[float(cal_bounds[i] + meta["offset"])] = i
        else:
            for i in np.nonzero(counts[:n_lanes] > 0)[0].tolist():
                groups[float((meta["base"] + i) * meta["interval"]
                             + meta["offset"])] = i
        return groups

    def _histo_buckets(self, ctx, body, meta, counts, n_lanes, partial,
                       fill):
        min_count = -1 if partial else int(body.get("min_doc_count", 0))
        groups = self._histo_keys(meta, counts, n_lanes)
        all_keys = A.fill_histo_keys(sorted(groups),
                                     body.get("extended_bounds"),
                                     meta["interval"], min_count)
        A._check_max_buckets(ctx, len(all_keys))
        buckets = []
        for key in all_keys:
            lane = groups.get(key)
            c = int(counts[lane]) if lane is not None else 0
            if c < min_count and min_count > 0:
                continue
            b = A.histo_bucket(key, c, meta["date"], meta["fmt"], meta["tz"])
            fill(b, lane)
            buckets.append(b)
        if not meta["date"] and body.get("format"):
            for b in buckets:
                b["key_as_string"] = A._decimal_format(b["key"],
                                                       body["format"])
        return {"buckets": buckets}

    def _assemble_histo(self, ctx, body, spec, boards, partial):
        meta, metrics = boards["hist_meta"], boards["metrics"]

        def fill(b, lane):
            if lane is not None:
                self._sub_outputs(b, lane, metrics, spec, partial)
            else:
                self._empty_sub_outputs(b, metrics, spec, partial)
        return self._histo_buckets(ctx, body, meta, boards["counts"],
                                   meta["n_buckets"], partial, fill)

    def _assemble_range(self, body, spec, boards, partial):
        counts, metrics = boards["counts"], boards["metrics"]
        buckets = []
        for i, r in enumerate(body.get("ranges", [])):
            frm, to = boards["frm_to"][i]
            key = r.get("key")
            if key is None:
                lo_s = "*" if frm is None else float(frm)
                hi_s = "*" if to is None else float(to)
                key = f"{lo_s}-{hi_s}"
            b = {"key": key, "doc_count": int(counts[i])}
            if frm is not None:
                b["from"] = float(frm)
            if to is not None:
                b["to"] = float(to)
            self._sub_outputs(b, i, metrics, spec, partial)
            b["_sort"] = (frm if frm is not None else -np.inf,
                          to if to is not None else np.inf)
            buckets.append(b)
        buckets.sort(key=lambda b: b.pop("_sort"))
        return {"buckets": buckets}

    # ------------------------------------------------------- tree assembly
    @staticmethod
    def _tree_eff_counts(tnode, P) -> np.ndarray:
        """Doc counts of this node's lanes under the parent composite
        selection P: the flat board as (parents, k), the rows of P
        summed."""
        ks = tnode["ks"]
        k = ks[-1]
        counts = tnode["counts"]
        if counts is None or not P or k == 0:
            return np.zeros(max(k, 0), dtype=np.int64)
        total = int(np.prod(ks))
        return counts[:total].reshape(total // k, k)[np.asarray(P)].sum(
            axis=0)

    def _tree_sub_outputs(self, b, P_i, tnode, spec_node, partial):
        for mname, board4 in tnode["metrics"].items():
            if board4 is None or not P_i:
                c, ss, m1, m2 = 0, 0.0, float("inf"), float("-inf")
            else:
                cnt, s, mn, mx = board4
                idx = np.asarray(P_i)
                c, ss = int(cnt[idx].sum()), float(s[idx].sum())
                m1, m2 = float(mn[idx].min()), float(mx[idx].max())
            b[mname] = self._leaf_out(spec_node, mname, c, ss, m1, m2,
                                      partial)

    def _card_out(self, rec, P, partial, name):
        body = rec["body"]
        if partial:
            board = rec["board"]
            regs: Dict[int, int] = {}
            if board is not None and P:
                v = board[np.asarray(P)].max(axis=0)
                regs = {int(i): int(v[i]) for i in np.nonzero(v)[0]}
            return AP.hll_pack(regs)
        pt = body.get("precision_threshold")
        if pt is not None and int(pt) < 0:
            raise IllegalArgumentError(
                f"[precisionThreshold] must be greater than or equal to "
                f"0. Found [{int(pt)}] in [{name}]")
        board, k_card, col = rec["board"], rec["k"], rec["col"]
        if board is None or not P:
            sub = np.zeros(k_card, dtype=np.int64)
        else:
            total = (len(board) - 1) // k_card
            sub = board[: total * k_card].reshape(total, k_card)[
                np.asarray(P)].sum(axis=0)
        distinct = int(np.count_nonzero(sub[:len(col.ord_keys)]))
        if rec["miss"] and int(sub[k_card - 1]) > 0:
            # the host adds `missing` to its distinct set: a new value only
            # when no counted key equals it
            mv = A._hashable(body.get("missing"))
            mi = next((i for i, kk in enumerate(col.ord_keys)
                       if A._hashable(kk) == mv), None)
            if mi is None or int(sub[mi]) == 0:
                distinct += 1
        return {"value": distinct}

    def _assemble_tree(self, ctx, tnode, spec_node, P, partial):
        """One tree node's buckets under the parent selection P, recursing
        with each bucket's own composite lanes: the flat boards unfold
        into the nested JSON of the host's recursion."""
        node_ = tnode["node"]
        lvl = tnode["chain"][-1]
        k = lvl["k"]
        body = spec_node[node_.kind]
        eff = self._tree_eff_counts(tnode, P)
        sub_spec = A.sub_aggs_of(spec_node)

        def bucket_fill(b, P_i):
            self._tree_sub_outputs(b, P_i, tnode, spec_node, partial)
            for cname, rec in tnode["cards"].items():
                out = self._card_out(rec, P_i, partial, cname)
                b[cname] = out if partial else _with_meta(out,
                                                          sub_spec[cname])
            for chname, ch in tnode["children"].items():
                res = self._assemble_tree(ctx, ch, sub_spec[chname], P_i,
                                          partial)
                b[chname] = res if partial else _with_meta(res,
                                                           sub_spec[chname])

        if lvl["kind"] == "ord":
            items, other, tname = self._terms_items(
                ctx, lvl["col"], body, eff, k - 1, partial,
                tnode.get("mask"))
            buckets = []
            for key, c, lane, merge_lane in items:
                b = {"key": key, "doc_count": int(c)}
                P_i = [p * k + lane for p in P]
                if merge_lane is not None:
                    P_i += [p * k + merge_lane for p in P]
                bucket_fill(b, P_i)
                buckets.append(b)
            A.format_terms_keys(buckets, tname)
            return {"doc_count_error_upper_bound": 0,
                    "sum_other_doc_count": int(other), "buckets": buckets}
        meta = lvl["meta"]
        n_lanes = len(meta["cal_bounds"]) if meta.get("cal_bounds") \
            is not None else k
        return self._histo_buckets(
            ctx, body, meta, eff, min(n_lanes, len(eff)), partial,
            lambda b, lane: bucket_fill(
                b, [p * k + lane for p in P] if lane is not None else []))


def _with_meta(out, spec: dict):
    """A final-mode result with its spec's `meta`, as the host adds it."""
    if isinstance(spec.get("meta"), dict) and isinstance(out, dict):
        out["meta"] = spec["meta"]
    return out
