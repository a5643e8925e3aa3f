"""Hybrid `rank: {rrf}` search: one plan, one dispatch per leg, RRF,
fetch (port of the `knn`, `late_interaction`, lexical, learned-sparse and
generic legs of `elasticsearch_tpu/search/hybrid_plan.py`).

  plan    normalize → classify sub-searches into legs:
            lexical — `match` / `term` on a text field, no fuzziness →
                   the BM25 board (`ops/bm25.py`, `csrc/bm25.cu` on the
                   card), one board call a text field a batch; a `match`
                   whose text analyzes to nothing is an empty leg
            sparse — `sparse_vector` / `weighted_tokens` on a
                   `rank_features` or `sparse_vector` field → the same
                   board over the learned-sparse layout (`ops/sparse.py`),
                   one board call a field a batch, whatever the query's
                   token count; an empty token map is an empty leg
            knn  — `knn` on a dense_vector field → the vector store
                   (`vectors/store.py`, the binned kernel on the card;
                   a filtered leg's filter runs on the host and its rows
                   send the leg's batch to the exact route)
            maxsim — `late_interaction` on a rank_vectors field → the
                   late-interaction store (`vectors/late_interaction.py`,
                   the MaxSim kernels on the card), whatever the query's
                   token count
            generic — any other query kind `search/queries.py` parses
                   (a sparse kind on a field without feature maps too) →
                   the host query phase, body by body
  score   one store dispatch per leg group of a batch
  fuse    reciprocal-rank fusion; f64 accumulation in leg order
  hydrate fetch only the final `from + size` window

Bodies reach `HybridExecutor` through a `BoundedBatcher`
(`serving/batcher.py`), so concurrent bodies share their legs' dispatches.
Every body compiles its own plan: compiling is a few mapping lookups, and
PyTorch runs eagerly, so there is no compiled program to reuse. A
sub-search of a kind `search/queries.py` does not parse is refused with a
400 naming it, and so is a kNN leg whose filter is of such a kind.
The device rung of the shard request cache sits in front of the executor,
in `node.py::Node._search_rrf`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.index.mapping import (
    DenseVectorFieldMapper, RankFeaturesFieldMapper, RankVectorsFieldMapper,
    TextFieldMapper,
)
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops.bm25 import LexicalShard
from elasticsearch_tpu_torch.ops.sparse import SparseShard
from elasticsearch_tpu_torch.search.profile import hybrid_profile
from elasticsearch_tpu_torch.search.queries import (
    SearchContext, parse_query, resolve_msm,
)
from elasticsearch_tpu_torch.serving.batcher import BoundedBatcher
from elasticsearch_tpu_torch.vectors.late_interaction import (
    LateInteractionShard,
)

DEFAULT_RANK_CONSTANT = 60
DEFAULT_WINDOW = 100
# `aggs` is accepted and ignored, as the reference's fused path ignores it
_BODY_KEYS = {"rank", "sub_searches", "query", "knn", "size", "from",
              "_source", "docvalue_fields", "request_cache", "aggs",
              "aggregations", "profile", "timeout", "terminate_after"}


class LexicalLeg:
    """`match` / `term` sub-search on a text field, lowered to the BM25
    board."""

    __slots__ = ("field", "terms", "required", "boost")

    def __init__(self, field: str, terms: List[str], required: int,
                 boost: float):
        self.field = field
        self.terms = terms
        self.required = required
        self.boost = boost


class EmptyLeg:
    """A leg whose analysis produced nothing searchable (match text that
    analyzes to no term): an empty ranked list, as the host query phase
    returns for it."""

    __slots__ = ()


class LexicalTemplate:
    """Compile-time half of a lexical leg: everything but the query TEXT,
    which is bound from each body."""

    __slots__ = ("field", "kind", "operator", "msm", "boost")

    def __init__(self, field: str, kind: str, operator: str, msm,
                 boost: float):
        self.field = field
        self.kind = kind          # "match" | "term"
        self.operator = operator
        self.msm = msm
        self.boost = boost

    def bind(self, qspec, mapper_service):
        if self.kind == "term":
            text = qspec.get("value") if isinstance(qspec, dict) else qspec
            return LexicalLeg(self.field, [str(text)], 1, self.boost)
        text = qspec.get("query") if isinstance(qspec, dict) else qspec
        terms = mapper_service.get(self.field).search_analyzer.terms(
            str(text))
        if not terms:
            return EmptyLeg()
        required = len(terms) if self.operator == "and" \
            else resolve_msm(self.msm, len(terms))
        return LexicalLeg(self.field, terms, required, self.boost)


class SparseTemplate:
    """Compile-time half of a learned-sparse leg (`sparse_vector` /
    `weighted_tokens` on a feature-map field): field and boost; the query's
    TOKEN MAP is bound from each body."""

    __slots__ = ("field", "kind", "boost")

    def __init__(self, field: str, kind: str, boost: float):
        self.field = field
        self.kind = kind          # "sparse_vector" | "weighted_tokens"
        self.boost = boost

    def bind(self, qspec: dict):
        spec = qspec[self.kind]
        if self.kind == "sparse_vector":
            tokens = spec.get("query_vector") or {}
        else:
            tokens = (spec[self.field] or {}).get("tokens") or {}
        if not tokens:
            return EmptyLeg()
        return SparseLeg(self.field, tokens, self.boost)


class SparseLeg:
    __slots__ = ("field", "tokens", "boost")

    def __init__(self, field: str, tokens: Dict[str, float], boost: float):
        self.field = field
        self.tokens = tokens
        self.boost = boost


class GenericLeg:
    """Any other sub-search, parsed when its body's plan compiles (every
    body compiles its own): run through the host query phase (inside the
    batch's runner, fused and fetched with the rest)."""

    __slots__ = ("query",)

    def __init__(self, query):
        self.query = query


class KnnTemplate:
    """Compile-time half of a kNN leg: k/num_candidates/filter/boost/metric
    are resolved from the mapping and the spec (the filter parsed); the
    query VECTOR is bound from the body."""

    __slots__ = ("field", "dims", "k", "num_candidates", "filter_query",
                 "boost", "metric")

    def __init__(self, field, dims, k, num_candidates, filter_query, boost,
                 metric):
        self.field = field
        self.dims = dims
        self.k = k
        self.num_candidates = num_candidates
        self.filter_query = filter_query
        self.boost = boost
        self.metric = metric

    def bind(self, spec):
        qv = np.asarray(spec["query_vector"], dtype=np.float32)
        if qv.ndim != 1 or qv.shape[0] != self.dims:
            raise IllegalArgumentError(
                f"[knn] query vector has {qv.shape[-1] if qv.ndim else 0} "
                f"dims, field [{self.field}] expects {self.dims}")
        return KnnLeg(self.field, qv, self.k, self.num_candidates,
                      self.filter_query, self.boost, self.metric)


class MaxSimTemplate:
    """Compile-time half of a late-interaction leg: field/k/boost are
    resolved at compile; the query TOKEN VECTORS are bound from the body."""

    __slots__ = ("field", "dims", "k", "boost")

    def __init__(self, field: str, dims: int, k: int, boost: float):
        self.field = field
        self.dims = dims
        self.k = k
        self.boost = boost

    def bind(self, qspec: dict):
        spec = qspec["late_interaction"]
        qt = np.asarray(spec["query_tokens"], dtype=np.float32)
        if qt.ndim == 1:
            qt = qt.reshape(1, -1)
        if qt.ndim != 2 or qt.shape[1] != self.dims:
            raise IllegalArgumentError(
                f"[late_interaction] query tokens have "
                f"{qt.shape[-1] if qt.ndim else 0} dims, field "
                f"[{self.field}] expects {self.dims}")
        return MaxSimLeg(self.field, qt, self.k, self.boost)


class KnnLeg:
    __slots__ = ("field", "query_vector", "k", "num_candidates",
                 "filter_query", "boost", "metric")

    def __init__(self, field: str, query_vector, k: int,
                 num_candidates: int, filter_query, boost: float,
                 metric: str):
        self.field = field
        self.query_vector = np.asarray(query_vector, dtype=np.float32)
        self.k = k
        self.num_candidates = num_candidates
        self.filter_query = filter_query
        self.boost = boost
        self.metric = metric


class MaxSimLeg:
    __slots__ = ("field", "query_tokens", "k", "boost")

    def __init__(self, field: str, query_tokens, k: int, boost: float):
        self.field = field
        self.query_tokens = query_tokens
        self.k = k
        self.boost = boost


class HybridPlan:
    """Compiled structure of a hybrid body: leg templates + fusion
    parameters. Per-query VALUES are not part of the plan; `bind` extracts
    them from the body (a lexical leg's text analyzed by the mapping the
    plan was compiled against)."""

    __slots__ = ("legs", "rank_constant", "window", "size", "frm",
                 "fetch_body", "mapper_service")

    def __init__(self, legs, rank_constant, window, size, frm, fetch_body,
                 mapper_service):
        self.legs = legs
        self.rank_constant = rank_constant
        self.window = window
        self.size = size
        self.frm = frm
        # the keys the fetch of the fused window reads
        self.fetch_body = fetch_body
        self.mapper_service = mapper_service

    def bind(self, body: dict) -> List[Any]:
        """The executable legs of `body` against the templates."""
        bound: List[Any] = []
        for template, q in zip(self.legs, sub_queries_of(body)):
            if isinstance(template, LexicalTemplate):
                bound.append(template.bind(q[template.kind][template.field],
                                           self.mapper_service))
            elif isinstance(template, KnnTemplate):
                bound.append(template.bind(q["knn"]))
            elif isinstance(template, GenericLeg):
                bound.append(template)
            else:
                bound.append(template.bind(q))
        return bound


def sub_queries_of(body: dict) -> List[dict]:
    subs: List[dict] = []
    if body.get("sub_searches"):
        subs = [s.get("query", {"match_all": {}})
                for s in body["sub_searches"]]
    else:
        if body.get("query") is not None:
            subs.append(body["query"])
        if body.get("knn") is not None:
            knn = body["knn"]
            if isinstance(knn, list):
                subs.extend({"knn": spec} for spec in knn)
            else:
                subs.append({"knn": knn})
    return subs


def _not_ported(kind: str, why: str) -> IllegalArgumentError:
    return IllegalArgumentError(
        f"[rrf] sub-search [{kind}] is not supported by this build: {why}; "
        f"[knn] on dense_vector and [late_interaction] on rank_vectors "
        f"fields, and the query kinds the query phase parses, are ported")


def _compile_lexical(kind: str, qspec, mapper_service
                     ) -> Optional[LexicalTemplate]:
    """Lower a match / term sub-search to a lexical template when it
    scores exactly as the host path would (a text field, no fuzziness);
    purely structural, as the reference classifies it."""
    if not isinstance(qspec, dict) or len(qspec) != 1:
        return None
    ((field, v),) = qspec.items()
    if not isinstance(mapper_service.get(field), TextFieldMapper):
        return None
    if kind == "term":
        boost = float(v.get("boost", 1.0)) if isinstance(v, dict) else 1.0
        return LexicalTemplate(field, "term", "or", None, boost)
    if isinstance(v, dict):
        if v.get("fuzziness") is not None:
            return None
        return LexicalTemplate(field, "match",
                               str(v.get("operator", "or")).lower(),
                               v.get("minimum_should_match"),
                               float(v.get("boost", 1.0)))
    return LexicalTemplate(field, "match", "or", None, 1.0)


def _compile_sparse(kind: str, qspec, mapper_service
                    ) -> Optional[SparseTemplate]:
    """Lower a sparse_vector / weighted_tokens sub-search to a sparse
    template when its field holds feature maps (`rank_features` or
    `sparse_vector`); purely structural, as the reference classifies
    it."""
    if not isinstance(qspec, dict):
        return None
    if kind == "sparse_vector":
        field = qspec.get("field")
        boost = float(qspec.get("boost", 1.0))
    else:
        if len(qspec) != 1:
            return None
        ((field, v),) = qspec.items()
        boost = float(v.get("boost", 1.0)) if isinstance(v, dict) else 1.0
    if not field or not isinstance(mapper_service.get(field),
                                   RankFeaturesFieldMapper):
        return None
    return SparseTemplate(field, kind, boost)


def compile_plan(body: dict, mapper_service) -> HybridPlan:
    """Parse + classify ONE hybrid body into an executable plan."""
    for key in body:
        if key not in _BODY_KEYS:
            raise ParsingError(
                f"unknown key [{key}] for a search request body "
                f"(SearchSourceBuilder)")
    rrf = (body.get("rank") or {}).get("rrf") or {}
    rank_constant = int(rrf.get("rank_constant", DEFAULT_RANK_CONSTANT))
    window = int(rrf.get("rank_window_size",
                         rrf.get("window_size", DEFAULT_WINDOW)))
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0) or 0)
    if frm < 0:
        raise IllegalArgumentError("[from] parameter cannot be negative")
    if size < 0:
        raise IllegalArgumentError(
            f"[size] parameter cannot be negative, found [{size}]")
    subs = sub_queries_of(body)
    if len(subs) < 2:
        raise IllegalArgumentError(
            "[rrf] requires at least 2 ranked lists (sub_searches, or "
            "query + knn)")
    legs: List[Any] = []
    for q in subs:
        if not isinstance(q, dict) or len(q) != 1:
            raise ParsingError("[rrf] each sub-search must hold one query")
        ((kind, spec),) = q.items()
        field = spec.get("field") if isinstance(spec, dict) else None
        mapper = mapper_service.get(field) if isinstance(field, str) else None
        if kind == "knn":
            if not isinstance(mapper, DenseVectorFieldMapper):
                raise _not_ported(kind, f"[{field}] is not a dense_vector "
                                        f"field")
            filter_query = None
            if spec.get("filter") is not None:
                try:
                    filter_query = parse_query(spec["filter"])
                except ParsingError as e:
                    raise _not_ported(kind, f"its filter: {e.message}")
            # the reference's leg semantics: k defaults to 10 (not
            # num_candidates), and num_candidates clamps up to k
            k = int(spec.get("k", 10))
            nc = max(int(spec.get("num_candidates", spec.get("k", 10))), k)
            if k < 1:
                raise IllegalArgumentError("[k] must be greater than 0")
            from elasticsearch_tpu_torch.vectors.store import _METRIC_MAP
            legs.append(KnnTemplate(field, mapper.dims, k, nc, filter_query,
                                    float(spec.get("boost", 1.0)),
                                    _METRIC_MAP[mapper.similarity]))
        elif kind == "late_interaction":
            if not isinstance(mapper, RankVectorsFieldMapper):
                raise _not_ported(kind, f"[{field}] is not a rank_vectors "
                                        f"field")
            legs.append(MaxSimTemplate(field, mapper.dims,
                                       int(spec.get("k", 10)),
                                       float(spec.get("boost", 1.0))))
        else:
            leg = (_compile_lexical(kind, spec, mapper_service)
                   if kind in ("match", "term") else
                   _compile_sparse(kind, spec, mapper_service)
                   if kind in ("sparse_vector", "weighted_tokens") else None)
            if leg is None:
                try:
                    leg = GenericLeg(parse_query(q))
                except ParsingError as e:
                    raise _not_ported(kind, e.message)
            legs.append(leg)
    return HybridPlan(legs, rank_constant, window, size, frm,
                      {k: v for k, v in body.items()
                       if k in ("_source", "docvalue_fields")},
                      mapper_service)


def fuse_rrf(leg_rows: List[np.ndarray], rank_constant: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """RRF over ranked row lists → (unique rows ascending, f64 scores).
    Per row, contributions add one leg at a time in leg order."""
    non_empty = [r for r in leg_rows if len(r)]
    if not non_empty:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))
    uniq = np.unique(np.concatenate(non_empty))
    scores = np.zeros(len(uniq), dtype=np.float64)
    for rows in leg_rows:
        if not len(rows):
            continue
        idx = np.searchsorted(uniq, rows)
        np.add.at(scores, idx,
                  1.0 / (rank_constant + np.arange(1, len(rows) + 1,
                                                   dtype=np.float64)))
    return uniq, scores


def _ranked(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best scores by (score desc, index asc)."""
    return np.lexsort((np.arange(len(scores)), -scores))[:k]


class HybridExecutor:
    """Per-index hybrid serving path behind a bounded combining queue.

    Whole hybrid bodies coalesce: the first thread in becomes the runner
    and executes every body that accumulated while the previous batch was
    in flight, with one BM25 board per text field and per feature-map
    field, one MaxSim dispatch per (rank_vectors field, k) and one kNN
    dispatch per (dense_vector field, k, num_candidates) for the whole
    batch. Admission control (queue depth + deadline) sheds overload as
    HTTP 429 instead of queueing into the tail.

    The runner holds the batcher's run lock for `_dispatch_batch` (plan +
    bind, the generic, lexical, sparse and MaxSim legs, which complete
    there, and the kNN launches);
    the kNN boards' wait, RRF and fetch run in `_finalize_batch` outside
    it, overlapping the next batch's dispatch. A poisoned batch is retried
    one body at a time through both stages back to back.

    A `profile` body gets `profile.hybrid` (`search/profile.py`): the
    batch's plan / score / fuse / hydrate times, its queue wait and the
    score time's split into the launch stage and the device wait, the
    scheduler's counters, each leg's engine, and the hand kernels the
    batch launched (the runner thread's launch event trace, on while a
    body of the batch profiles). The port compiles every body's plan, so
    `plan_cache` reads `miss`. A traced batch leader's trace gets the
    `hybrid.*` stage spans.
    """

    def __init__(self, svc, device, max_batch: int = 64,
                 max_queue_depth: int = 256,
                 deadline_ms: Optional[float] = 10_000.0, query_cache=None):
        self.svc = svc
        # the node query cache (`search/caches.py::QueryCache`) for the
        # `bool` filter clauses of the generic legs and the kNN filters
        self.query_cache = query_cache
        # the node's `search.allow_expensive_queries`, read a batch
        self.allow_expensive = lambda: True
        # kNN legs search every shard's store (`svc.vector_store`); the
        # lexical and late-interaction stores sync from the combined
        # reader (rows rebased by shard), so BM25 reads corpus-wide
        # statistics
        def impact_dtype(key: str) -> str:
            # the reference lays out any value but bf16 and int8 as f32
            dtype = str(svc.settings.get(key, "f32"))
            return dtype if dtype in ("bf16", "int8") else "f32"

        self.lexical = LexicalShard(
            dtype=impact_dtype("index.lexical.impact_dtype"), device=device)
        self.sparse = SparseShard(
            dtype=impact_dtype("index.sparse.impact_dtype"), device=device)
        self.late = LateInteractionShard(device=device)
        # the admission policy (batch ceiling, queue depth, deadline) is
        # the reference's `search.hybrid.*` defaults; top-up and 2 batches
        # in flight are the batcher's defaults
        self.batcher = BoundedBatcher(
            self._dispatch_batch, self._finalize_batch, max_batch=max_batch,
            max_queue_depth=max_queue_depth, deadline_ms=deadline_ms)
        # finalize stages of different batches run concurrently at
        # async_depth > 1, so every stats write takes the lock
        self._lock = threading.Lock()
        self.stats = {"searches": 0, "batches": 0, "max_batch_seen": 0,
                      "plan_nanos": 0, "score_nanos": 0, "fuse_nanos": 0,
                      "hydrate_nanos": 0, "queue_wait_nanos": 0,
                      "dispatch_nanos": 0, "sync_nanos": 0}

    def _bump(self, **deltas) -> None:
        with self._lock:
            for key, v in deltas.items():
                self.stats[key] += v

    def submit(self, body: dict) -> dict:
        return self.batcher.submit(body)

    # ------------------------------------------------------------- batch
    def _dispatch_batch(self, bodies: List[dict]) -> dict:
        """Dispatch stage (under the batcher's run lock): compile and bind
        every body, run the MaxSim legs, launch the kNN legs. Returns the
        handle `_finalize_batch` lands."""
        start = time.perf_counter()
        reader = self.svc.combined_reader()
        meta = self.batcher.batch_meta()
        t0 = time.perf_counter_ns()
        plans = [compile_plan(body, self.svc.mapper_service)
                 for body in bodies]
        bound = [plan.bind(body) for plan, body in zip(plans, bodies)]
        t1 = time.perf_counter_ns()
        # the launch event trace costs a dict a launch: on only when a body
        # of the batch profiles
        trace = any(body.get("profile") for body in bodies)
        if trace:
            dispatch.record_events(True)
        try:
            leg_results, leg_info, pending = self._score_legs_async(
                reader, plans, bound)
        except BaseException:
            if trace:
                dispatch.record_events(False)
            raise
        dispatch_nanos = time.perf_counter_ns() - t1
        self._bump(searches=len(bodies), batches=1, plan_nanos=t1 - t0,
                   dispatch_nanos=dispatch_nanos,
                   queue_wait_nanos=meta.get("queue_wait_max_nanos", 0))
        with self._lock:
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(bodies))
        return {"start": start, "reader": reader, "plans": plans,
                "bodies": bodies, "leg_results": leg_results,
                "leg_info": leg_info, "pending": pending,
                "plan_nanos": t1 - t0, "dispatch_nanos": dispatch_nanos,
                "trace": trace, "meta": meta}

    def _finalize_batch(self, handle: dict) -> List[dict]:
        """Finalize stage (outside the run lock): land the kNN boards, fuse
        RRF and fetch the final window of each body."""
        from elasticsearch_tpu_torch.search.service import fetch_hits
        reader, plans = handle["reader"], handle["plans"]
        ctx = SearchContext(reader, self.svc.mapper_service)
        leg_results, leg_info = handle["leg_results"], handle["leg_info"]
        events = []
        t0 = time.perf_counter_ns()
        try:
            self._land_knn_legs(handle["pending"], plans, leg_results,
                                leg_info)
        finally:
            if handle["trace"]:
                events = dispatch.drain_events()
                dispatch.record_events(False)
        t1 = time.perf_counter_ns()
        fused = []
        for bi, plan in enumerate(plans):
            rows, scores = fuse_rrf([leg_results[(bi, li)]
                                     for li in range(len(plan.legs))],
                                    plan.rank_constant)
            top = np.lexsort((rows, -scores))[plan.frm:plan.frm + plan.size]
            fused.append((rows, scores, top))
        t2 = time.perf_counter_ns()
        dispatch_nanos, sync_nanos = handle["dispatch_nanos"], t1 - t0
        meta, bodies = handle["meta"], handle["bodies"]
        out = []
        for bi, (plan, body, (rows, scores, top)) in enumerate(
                zip(plans, bodies, fused)):
            hits = fetch_hits(ctx, self.svc.name, plan.fetch_body,
                              rows[top], scores[top])
            resp = {
                "took": int((time.perf_counter() - handle["start"]) * 1000),
                "timed_out": False,
                "_shards": {"total": self.svc.num_shards,
                            "successful": self.svc.num_shards,
                            "skipped": 0, "failed": 0},
                "hits": {"total": {"value": int(len(rows)),
                                   "relation": "eq"},
                         "max_score": hits[0]["_score"] if hits else None,
                         "hits": hits}}
            if body.get("profile"):
                resp["profile"] = hybrid_profile(
                    self.svc.name, handle["plan_nanos"],
                    dispatch_nanos + sync_nanos, t2 - t1, 0, False,
                    len(bodies), [leg_info[(bi, li)]
                                  for li in range(len(plan.legs))],
                    dispatch_events=events,
                    queue_wait_nanos=meta.get("queue_wait_max_nanos", 0),
                    device_dispatch_nanos=dispatch_nanos,
                    device_sync_nanos=sync_nanos,
                    scheduler=self.scheduler_snapshot())
            out.append(resp)
        hydrate_nanos = time.perf_counter_ns() - t2
        for resp in out:
            if "profile" in resp:
                resp["profile"]["hybrid"]["breakdown"]["hydrate_nanos"] = \
                    hydrate_nanos
        # score = launch + device wait, the figure of the unbatched path
        self._bump(sync_nanos=sync_nanos,
                   score_nanos=dispatch_nanos + sync_nanos,
                   fuse_nanos=t2 - t1, hydrate_nanos=hydrate_nanos)
        tr = meta.get("trace")
        if tr is not None:
            # the batch leader's finer stage spans (the batcher recorded
            # batch.dispatch / batch.finalize and linked the followers);
            # every duration was measured above, so no wait is added
            parent = meta.get("trace_parent")
            tr.record_span("hybrid.plan", handle["plan_nanos"],
                           parent_id=parent)
            tr.record_span("hybrid.device_dispatch", dispatch_nanos,
                           parent_id=parent, coalesced=len(bodies))
            tr.record_span("hybrid.device_sync", sync_nanos,
                           parent_id=parent)
            tr.record_span("hybrid.fuse", t2 - t1, parent_id=parent)
            tr.record_span("hybrid.hydrate", hydrate_nanos,
                           parent_id=parent)
        return out

    def scheduler_snapshot(self) -> dict:
        """The batcher's scheduler counters (top-ups, deadline and
        cancellation sheds, dispatch/finalize overlap hits), for the
        profile."""
        sched = self.batcher.sched
        return {"topups": sched["topups"],
                "deadline_sheds": sched["deadline_sheds"],
                "overlap_hits": sched["overlap_hits"],
                "pipelined_batches": sched["pipelined_batches"]}

    # -------------------------------------------------------------- legs
    def score_legs(self, reader, plans: List[HybridPlan],
                   bound: List[List[Any]]) -> List[List[np.ndarray]]:
        """Each body's legs, ranked and cut to its plan's window, run as
        one batch: the fusion's inputs, for checks that recompute RRF."""
        leg_results, leg_info, pending = self._score_legs_async(
            reader, plans, bound)
        self._land_knn_legs(pending, plans, leg_results, leg_info)
        return [[leg_results[(bi, li)] for li in range(len(legs))]
                for bi, legs in enumerate(bound)]

    def _score_legs_async(self, reader, plans: List[HybridPlan],
                          bound: List[List[Any]]):
        """Group the batch's bound legs so each store sees one dispatch:
        lexical legs per text field and sparse legs per feature-map field
        (one board each), MaxSim legs per (field,
        k), both complete here (the MaxSim rescore's inputs are its own
        coarse phase's ids, so no board is left in flight); kNN legs per
        (field, k, num_candidates), launched un-landed
        (`search_many_async`); generic legs run the host query phase one
        by one. Returns ({(body, leg): ranked rows}, {(body, leg): the
        leg's profile entry}, the pending kNN groups)."""
        from elasticsearch_tpu_torch.search.service import (
            check_result_window)
        leg_results: Dict[Tuple[int, int], np.ndarray] = {}
        leg_info: Dict[Tuple[int, int], dict] = {}
        lex_groups: Dict[str, list] = {}
        sparse_groups: Dict[str, list] = {}
        maxsim_groups: Dict[tuple, list] = {}
        knn_groups: Dict[tuple, list] = {}
        ctx = SearchContext(reader, self.svc.mapper_service,
                            self.svc.vector_store, self.svc.settings,
                            query_cache=self.query_cache)
        ctx.allow_expensive = self.allow_expensive()
        for bi, legs in enumerate(bound):
            for li, leg in enumerate(legs):
                if isinstance(leg, EmptyLeg):
                    leg_results[(bi, li)] = np.zeros(0, dtype=np.int64)
                    leg_info[(bi, li)] = {"type": "empty"}
                elif isinstance(leg, GenericLeg):
                    # the reference runs a generic leg as a query phase
                    # of size `window`, held to `index.max_result_window`
                    check_result_window(plans[bi].window, self.svc.settings)
                    result = leg.query.execute(ctx).with_scores()
                    top = native.topk(result.scores,
                                      min(plans[bi].window, len(result.rows)))
                    leg_results[(bi, li)] = result.rows[top]
                    leg_info[(bi, li)] = {"type": "query_phase"}
                elif isinstance(leg, LexicalLeg):
                    lex_groups.setdefault(leg.field, []).append(
                        (bi, li, leg))
                elif isinstance(leg, SparseLeg):
                    sparse_groups.setdefault(leg.field, []).append(
                        (bi, li, leg))
                elif isinstance(leg, MaxSimLeg):
                    maxsim_groups.setdefault((leg.field, leg.k), []).append(
                        (bi, li, leg))
                else:
                    knn_groups.setdefault(
                        (leg.field, leg.k, leg.num_candidates), []).append(
                        (bi, li, leg))
        for field, entries in lex_groups.items():
            window = max(plans[bi].window for bi, _li, _leg in entries)
            results = self.lexical.search_batch(
                reader, field,
                [(leg.terms, leg.boost) for _bi, _li, leg in entries],
                window, required=[leg.required for _bi, _li, leg in entries])
            lf = self.lexical.field(reader, field)
            for (bi, li, leg), (rows, _scores) in zip(entries, results):
                leg_results[(bi, li)] = rows[:plans[bi].window]
                leg_info[(bi, li)] = {
                    "type": "lexical_device", "field": field,
                    "terms": len(leg.terms), "corpus_slots": lf.n_slots,
                    "impact_tiles": int(lf.tile_slots.shape[0])}
        for field, entries in sparse_groups.items():
            window = max(plans[bi].window for bi, _li, _leg in entries)
            results = self.sparse.search_batch(
                reader, field,
                [(leg.tokens, leg.boost) for _bi, _li, leg in entries],
                window)
            sf = self.sparse.field(reader, field)
            for (bi, li, leg), (rows, _scores) in zip(entries, results):
                leg_results[(bi, li)] = rows[:plans[bi].window]
                leg_info[(bi, li)] = {
                    "type": "sparse_device", "field": field,
                    "tokens": len(leg.tokens), "corpus_slots": sf.n_slots,
                    "impact_tiles": int(sf.tile_slots.shape[0])}
        for (field, k), entries in maxsim_groups.items():
            mapper = self.svc.mapper_service.get(field)
            results = self.late.search_batch(
                reader, mapper, [(leg.query_tokens, leg.boost)
                                 for _bi, _li, leg in entries], k)
            lf = self.late.field(reader, mapper)
            n_docs = lf.snap.n_docs
            for (bi, li, _leg), (rows, _scores) in zip(entries, results):
                leg_results[(bi, li)] = rows[:plans[bi].window]
                leg_info[(bi, li)] = {
                    "type": "maxsim_device", "field": field, "k": k,
                    "encoding": lf.encoding,
                    "coarse_window": lf.coarse_window(k) if n_docs else 0,
                    "docs": n_docs}
        pending = []
        for (field, k, num_candidates), entries in knn_groups.items():
            # each leg's filter runs on the host, on the batch's reader;
            # filtered and unfiltered legs share the group's dispatch
            filters = [None if leg.filter_query is None
                       else leg.filter_query.execute(ctx).rows
                       for _bi, _li, leg in entries]
            handle = self.svc.vector_store.search_many_async(
                field, [leg.query_vector for _bi, _li, leg in entries], k,
                num_candidates=num_candidates, filter_rows=filters,
                reader=reader)
            pending.append((entries, handle))
        return leg_results, leg_info, pending

    def _land_knn_legs(self, pending, plans: List[HybridPlan],
                       leg_results: Dict[Tuple[int, int], np.ndarray],
                       leg_info: Dict[Tuple[int, int], dict]) -> None:
        """Land each kNN group's boards, then each leg as `KnnQuery` scores
        it, cut to the plan's window by (score desc, row asc)."""
        store = self.svc.vector_store
        for entries, handle in pending:
            batch_out = store.finalize_many(handle)
            engine = store.last_knn_phases.get("engine")
            for (bi, li, leg), (rows, raw) in zip(entries, batch_out):
                leg_info[(bi, li)] = {
                    "type": "knn_device", "field": leg.field, "k": leg.k,
                    **({"engine": engine} if engine else {})}
                scores = (np.asarray(sim.to_es_score(raw, leg.metric))
                          * leg.boost)
                order = np.argsort(rows, kind="stable")
                rows = rows[order].astype(np.int64)
                scores = scores[order].astype(np.float32)
                leg_results[(bi, li)] = rows[_ranked(scores,
                                                     plans[bi].window)]
