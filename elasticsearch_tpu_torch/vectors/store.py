"""Per-shard device vector store: segments → device corpus (port of the
monolithic path of `elasticsearch_tpu/vectors/store.py`).

Each vector field of a shard is mirrored into one device-resident `Corpus`,
rebuilt from the engine's sealed segments whenever a refresh changed the
field's segment set or tombstones, with a row map joining device rows back
to the engine's global rows (and thence `_id`).

Fields on the `tpu_ivf` engine (`index.knn.engine: tpu_ivf`, or an
`*_ivf` index_options type) of at least `IVF_MIN_ROWS` rows also carry an
`IVFRouter` built from the same extraction, so IVF row ids index the flat
corpus directly; the flat corpus stays resident as the router's
exhaustive fallback. An append-only refresh places only the new rows
into the existing layout and keeps the router (its centroids and tuned
nprobe) until the layout needs a retrain.

The packed int4 rung serves two-phase: a coarse top-(k·oversample) on
the packed tiles, then an exact f32 rescore of that window from the host
rows the field was built from (`quant/rescore.py`).

`search` coalesces concurrent requests through a per-(field, version, k,
precision, num_candidates) `CombiningBatcher` (`serving/batcher.py`): one
dispatch a batch, pipelined so the exhaustive route's launch runs under the
batcher's run lock and its device→host wait in the finalize stage outside
it. A refresh retires a rebuilt field's batchers; requests already queued
in one are served against the corpus it closed over.

A request may carry `filter_rows`, the sorted engine rows its filter
query let through. Filtered and unfiltered requests share batches; a
batch holding any filter takes the exact route with a [B, N] row mask
(every valid row for a request without a filter), and an IVF field falls
back to its exhaustive corpus for it (`fallback_reason: filtered`). A
request names the reader its filter ran on, and is served from the
corpus synced for that reader.

Left out, as ROADMAP.md lists: generational segments, the mesh, the
semantic cache, the host mirror and its cost router, and the binary rung.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.index.mapping import DenseVectorFieldMapper
from elasticsearch_tpu_torch.index.segment import ShardReader
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import knn as knn_ops
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.quant import rescore as quant_rescore
from elasticsearch_tpu_torch.serving.batcher import CombiningBatcher

# below this many rows the exhaustive scan beats IVF routing overhead;
# tpu_ivf fields smaller than this quietly serve exhaustive
IVF_MIN_ROWS = 512

_METRIC_MAP = {
    "cosine": sim.COSINE,
    "dot_product": sim.DOT_PRODUCT,
    "l2_norm": sim.L2_NORM,
    "max_inner_product": sim.MAX_INNER_PRODUCT,
}

# index_options.type -> storage encoding (None = the store's default); the
# engine half of the mapping lives in `_field_engine`
_OPTION_TYPE_ENCODING = {
    "flat": None, "ivf": None,
    "int8_flat": "int8", "int8_ivf": "int8",
    "int4_flat": "int4", "int4_ivf": "int4",
}

# score floor below which a slot is padding (the NEG_INF sentinel)
_FLOOR = -1e37


class FieldCorpus:
    """Device corpus for one vector field + host-side row map."""

    __slots__ = ("corpus", "row_map", "metric", "dims", "version",
                 "encoding", "rescore", "rescore_oversample",
                 "rescore_candidates", "router", "source", "_row_index")

    def __init__(self, corpus, row_map: np.ndarray, metric: str, dims: int,
                 version: tuple, encoding: str = "bf16",
                 rescore: bool = False, rescore_oversample: int = 4,
                 rescore_candidates: int = 128, router=None, source=None):
        self.corpus = corpus          # knn_ops.Corpus or None (empty field)
        self.row_map = row_map        # device row -> engine global row
        self.metric = metric
        self.dims = dims
        self.version = version        # segment/tombstone fingerprint
        self.encoding = encoding
        # two-phase rescore of packed rungs: window = k · oversample, exact
        # rows gathered from `source` (the f32 extraction, device row order)
        self.rescore = rescore
        self.rescore_oversample = rescore_oversample
        self.rescore_candidates = rescore_candidates
        self.router = router          # ann.IVFRouter (tpu_ivf) or None
        self.source = source
        self._row_index = None

    def row_index(self) -> np.ndarray:
        """Engine global row -> device row (-1: not in this corpus), made
        at the first filtered request."""
        if self._row_index is None:
            n = int(self.row_map[-1]) + 1 if len(self.row_map) else 0
            index = np.full(n, -1, dtype=np.int32)
            index[self.row_map] = np.arange(len(self.row_map),
                                            dtype=np.int32)
            self._row_index = index
        return self._row_index


def filter_mask(fc: FieldCorpus, filters: Sequence[Optional[np.ndarray]],
                b_pad: int, n_pad: int) -> torch.Tensor:
    """[b_pad, n_pad] bool host mask of a batch: row i keeps every valid
    device row when filters[i] is None, else the device rows of the engine
    rows in filters[i] (`np.isin(fc.row_map, filters[i])`, by a scatter
    through `row_index` instead of a search over the whole row map). Pad
    rows and pad queries keep nothing. For a corpus on the card it is
    built in pinned memory, so its upload does not wait on the host."""
    n_valid = len(fc.row_map)
    index = fc.row_index()
    out = torch.zeros((b_pad, n_pad), dtype=torch.bool,
                      pin_memory=fc.corpus.device.type == "cuda")
    mask = out.numpy()
    for i, rows in enumerate(filters):
        if rows is None:
            mask[i, :n_valid] = True
            continue
        rows = np.asarray(rows, dtype=np.int64)
        # rows are sorted: the ones inside the index are one slice
        dev = index[rows[np.searchsorted(rows, 0):
                         np.searchsorted(rows, len(index))]]
        mask[i, dev[dev >= 0]] = True
    return out


def _pad_batch(queries: np.ndarray, n_real: int) -> np.ndarray:
    """Pad a query batch to the dispatch layer's query bucket; pad results
    are sliced away by the caller."""
    b_pad = dispatch.bucket_queries(n_real)
    if b_pad != n_real:
        queries = np.concatenate(
            [queries, np.zeros((b_pad - n_real, queries.shape[1]),
                               dtype=np.float32)])
    return queries


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Queries onto `device` with no host wait: a copy from pageable memory
    would block until the card had run everything queued before it (the
    previous batch's kernels), so it goes through pinned memory."""
    t = torch.from_numpy(batch)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _to_host_async(*tensors: torch.Tensor):
    """Enqueue device→host copies into pinned memory and record an event
    behind them. Waiting on the event waits for this batch's work only: a
    `.cpu()` in finalize would also wait for kernels another runner queued
    on the stream after this batch. Returns (host tensors, event or None
    on the CPU)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return tensors, None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return tuple(host), ready


class VectorStoreShard:
    def __init__(self, dtype: str = "bf16", device="cuda",
                 knn_engine: str = "tpu", knn_nlist=None,
                 knn_nprobe="auto"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.knn_engine = knn_engine        # "tpu" (exhaustive) | "tpu_ivf"
        self.knn_nlist = knn_nlist          # None = pick_nlist(n)
        self.knn_nprobe = knn_nprobe        # "auto" | int
        self._fields: Dict[str, FieldCorpus] = {}
        self._field_plans: Dict[str, dict] = {}
        # layouts staged by `restore_ivf_layout` for the next sync's build
        self._restored_ivf: Dict[str, dict] = {}
        self._lock = threading.Lock()
        # the HTTP server answers requests on several threads
        self._stats_lock = threading.Lock()
        self.knn_stats: Dict[str, int] = {
            "searches": 0, "ivf_searches": 0, "fallback_searches": 0,
            "ivf_trains": 0, "ivf_restores": 0, "fused_probe_searches": 0,
            "rescore_searches": 0, "rescore_window_rows": 0,
            "rescore_promoted": 0, "rescore_nanos": 0,
            "route_nanos": 0, "score_nanos": 0, "merge_nanos": 0}
        # key -> (the FieldCorpus the batcher serves, the batcher)
        self._batchers: Dict[tuple, Tuple[FieldCorpus, CombiningBatcher]] = {}
        self._batchers_lock = threading.Lock()
        # scheduler counters of batchers retired at refresh
        self._sched_retired: Dict[str, int] = {}
        # per-thread phases of the last search (`last_knn_phases`)
        self._tls = threading.local()
        # reader -> the fields synced for it: a filtered request is served
        # from the corpus of the reader its filter ran on
        self._snapshots = weakref.WeakKeyDictionary()

    def _field_engine(self, mapper: DenseVectorFieldMapper) -> str:
        """Effective engine for one field: explicit index_options beat the
        index-level `index.knn.engine` setting."""
        otype = (mapper.params.get("index_options") or {}).get("type")
        if otype is not None and otype.endswith("ivf"):
            return "tpu_ivf"
        if otype is not None and otype.endswith("flat"):
            return "tpu"
        return self.knn_engine

    def _encoding_plan(self, mapper: DenseVectorFieldMapper) -> dict:
        """One field's quantization-ladder plan: storage encoding, whether
        it rescores (packed rungs by default; int8 `rescore` keeps the
        residual level on the device), and the rescore window sizes."""
        opts = mapper.params.get("index_options") or {}
        encoding = _OPTION_TYPE_ENCODING.get(opts.get("type")) or self.dtype
        packed = encoding == "int4"
        oversample = max(int(opts.get(
            "rescore_oversample",
            quant_rescore.DEFAULT_OVERSAMPLE.get(encoding, 4))), 1)
        return {
            "encoding": encoding,
            "rescore": bool(opts.get("rescore", packed)),
            "rescore_oversample": oversample,
            # the int8 residual path's device window
            "rescore_candidates": oversample * 32,
        }

    # ------------------------------------------------------- IVF layouts
    def export_ivf_layout(self) -> Dict[str, dict]:
        """Trained IVF layouts of every field routed through an IVFIndex
        (corpus-independent: centroids + shape)."""
        from elasticsearch_tpu_torch.ann.ivf_index import export_layout
        with self._lock:
            fields = dict(self._fields)
        return {field: export_layout(fc.router.index)
                for field, fc in fields.items() if fc.router is not None}

    def restore_ivf_layout(self, layouts: Dict[str, dict]) -> None:
        """Stage layouts (as `export_ivf_layout` of either package gives
        them) for the next sync's IVF build: rows re-place into the
        restored centroids instead of re-training k-means. Incompatible
        layouts are never consumed and the build trains."""
        self._restored_ivf.update(layouts or {})

    def _bump(self, **deltas) -> None:
        with self._stats_lock:
            for key, value in deltas.items():
                self.knn_stats[key] += value

    @staticmethod
    def _fingerprint(reader: ShardReader, field: str) -> tuple:
        return tuple((v.segment.seg_id, v.segment.num_docs, int(v.live.sum()))
                     for v in reader.views if field in v.segment.vectors)

    def sync(self, reader: ShardReader,
             vector_mappers: Dict[str, DenseVectorFieldMapper]) -> None:
        """Rebuild every vector field whose segment composition or plan
        changed (the monolithic full build), and its IVF router."""
        for field, mapper in vector_mappers.items():
            version = self._fingerprint(reader, field)
            plan = self._encoding_plan(mapper)
            cached = self._fields.get(field)
            if (cached is not None and cached.version == version
                    and self._field_plans.get(field) == plan):
                continue
            metric = _METRIC_MAP[mapper.similarity]
            full, row_map = reader.vector_rows(field)
            dtype = plan["encoding"]
            corpus = router = None
            if len(row_map):
                corpus = knn_ops.build_corpus(
                    full, metric=metric, dtype=dtype,
                    residual=plan["rescore"] and dtype == "int8",
                    device=self.device)
                if (self._field_engine(mapper) == "tpu_ivf"
                        and len(row_map) >= IVF_MIN_ROWS):
                    router = self._ivf_router(field, mapper, cached, full,
                                              row_map, metric, dtype)
            fc = FieldCorpus(corpus, row_map, metric, mapper.dims, version,
                             encoding=dtype, rescore=plan["rescore"],
                             rescore_oversample=plan["rescore_oversample"],
                             rescore_candidates=plan["rescore_candidates"],
                             router=router,
                             source=full if dtype == "int4" else None)
            with self._lock:
                self._fields[field] = fc
                self._field_plans[field] = plan
            self._retire_field(field)
        with self._lock:
            self._snapshots[reader] = dict(self._fields)

    def _ivf_router(self, field, mapper, cached, full, row_map, metric,
                    dtype):
        """The field's IVF router: the cached one extended by an
        append-only refresh, else one over a restored layout, else one
        over a freshly trained layout."""
        from elasticsearch_tpu_torch.ann import IVFRouter, build_ivf_index
        from elasticsearch_tpu_torch.ann.ivf_index import (
            ivf_from_layout, layout_compatible)
        old = cached.router if cached is not None else None
        old_n = len(cached.row_map) if cached is not None else 0
        if (old is not None and not old.index.needs_retrain
                and old.index.dtype == dtype
                and old.index.metric == metric
                and 0 < old_n <= len(row_map)
                and np.array_equal(row_map[:old_n], cached.row_map)):
            # append-only refresh (new sealed segments, no deletes): place
            # only the delta rows, keeping the trained centroids and the
            # tuned nprobe until drift forces a retrain. The rows go into a
            # copy of the layout: requests still queued against the
            # previous snapshot read the old one
            index = old.index.clone()
            index.add(full[old_n:],
                      np.arange(old_n, len(row_map), dtype=np.int32))
            if not index.needs_retrain:
                return old.with_index(index)
        opts = mapper.params.get("index_options") or {}
        nlist = opts.get("nlist", self.knn_nlist)
        ivf = None
        layout = self._restored_ivf.pop(field, None)
        if layout is not None and layout_compatible(
                layout, len(row_map), mapper.dims, metric, dtype):
            ivf = ivf_from_layout(layout, full)
            self._bump(ivf_restores=1)
        if ivf is None:
            ivf = build_ivf_index(
                full, metric=metric,
                nlist=int(nlist) if nlist is not None else None,
                dtype=dtype, seed=0, device=self.device)
            self._bump(ivf_trains=1)
        return IVFRouter(ivf, nprobe=opts.get("nprobe", self.knn_nprobe),
                         device=self.device)

    def field(self, name: str) -> Optional[FieldCorpus]:
        return self._fields.get(name)

    def close(self) -> None:
        """Drop every field's corpus, the per-reader snapshots and the
        batchers (an index delete): the device memory goes with the last
        reference. Requests still queued in a batcher finish against the
        corpus it closed over."""
        with self._lock:
            self._fields.clear()
            self._field_plans.clear()
            self._snapshots = weakref.WeakKeyDictionary()
        with self._batchers_lock:
            for _, batcher in self._batchers.values():
                self._retire_sched(batcher)
            self._batchers.clear()

    def _field_for(self, name: str, reader) -> Optional[FieldCorpus]:
        """The corpus synced for `reader` (the latest when the reader is
        None or was never synced)."""
        if reader is not None:
            with self._lock:
                snap = self._snapshots.get(reader)
            if snap is not None:
                return snap.get(name)
        return self._fields.get(name)

    @property
    def last_knn_phases(self) -> dict:
        """Phases of the last search made on the CALLING thread (engine,
        fallback reason, IVF route/score/merge times, rescore window).
        Each request carries its batch's phases back to its own thread, so
        concurrent requests never read each other's."""
        return getattr(self._tls, "phases", {})

    # ------------------------------------------------------- batchers
    def _retire_field(self, field: str) -> None:
        """Drop the batchers of a rebuilt field's earlier builds, folding
        their scheduler counters into the retired total. Entries still
        queued in one are served by its own runners against the corpus it
        closed over. A batcher already made for the current build stays."""
        with self._batchers_lock:
            current = self._fields.get(field)
            for key in [key for key, (fc, _) in self._batchers.items()
                        if key[0] == field and fc is not current]:
                self._retire_sched(self._batchers.pop(key)[1])

    def _retire_sched(self, batcher: CombiningBatcher) -> None:
        """Fold a dropped batcher's scheduler counters into the retired
        total (caller holds `_batchers_lock`). As in the reference, what
        it counts after this (requests that were queued in it) is not
        added."""
        for key, val in batcher.sched.items():
            self._sched_retired[key] = self._sched_retired.get(key, 0) + val

    def scheduler_stats(self) -> Dict[str, int]:
        """Combining-batcher counters summed over this shard's kNN
        batchers, live and retired: batches, requests, top-ups, pipelined
        batches, sheds, overlap hits, queue-wait / dispatch / finalize
        time."""
        out = dict(self._sched_retired)
        with self._batchers_lock:
            batchers = [b for _, b in self._batchers.values()]
        for b in batchers:
            for key, val in b.sched.items():
                out[key] = out.get(key, 0) + val
        return out

    def pending_requests(self, field: str) -> int:
        """Searches queued, not yet claimed by a runner, across the
        field's batchers."""
        with self._batchers_lock:
            return sum(b.pending() for key, (_, b) in self._batchers.items()
                       if key[0] == field)

    def queued_requests(self) -> int:
        """Searches queued across all of this shard's batchers
        (`CombiningBatcher.load()`)."""
        with self._batchers_lock:
            return sum(b.load()["pending"]
                       for _, b in self._batchers.values())

    def _batcher(self, field: str, fc: FieldCorpus, k: int, precision: str,
                 num_candidates: Optional[int]) -> CombiningBatcher:
        key = (field, fc.version, k, precision, num_candidates)
        with self._batchers_lock:
            cached = self._batchers.get(key)
            if cached is not None and cached[0] is fc:
                return cached[1]

            def dispatch_fn(requests):
                return self._dispatch_many(fc, k, precision, requests,
                                           num_candidates)

            def finalize_fn(handle):
                results, phases = self._finalize(handle)
                return [(res, dict(phases)) for res in results]

            # pipelined: the runner holds the run lock only for the launch;
            # the device→host wait and the row-map join of batch N overlap
            # batch N+1's launch
            batcher = CombiningBatcher(dispatch_fn, finalize_fn)
            if self._fields.get(field) is not fc:
                # a refresh replaced the field after this request read it:
                # serve the request through a batcher nothing keeps, so no
                # cached batcher holds the old corpus
                return batcher
            if cached is not None:   # an earlier build under the same key
                self._retire_sched(cached[1])
            if len(self._batchers) > 64:  # stale (field, k) variants
                for _, stale in self._batchers.values():
                    self._retire_sched(stale)
                self._batchers.clear()
            self._batchers[key] = (fc, batcher)
            return batcher

    # --------------------------------------------------------- search
    def search(self, field: str, query_vector: np.ndarray, k: int,
               filter_rows: Optional[np.ndarray] = None,
               precision: str = "bf16",
               num_candidates: Optional[int] = None,
               reader=None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search. Returns (global_rows [m], raw_scores [m]), m <= k
        (padding and filtered-out slots removed). `filter_rows`: the sorted
        engine rows allowed to match, from a filter query run on `reader`.
        Concurrent callers coalesce through a per-(field, version, k,
        precision, num_candidates) combining batcher into one dispatch."""
        fc = self._field_for(field, reader)
        if fc is None or fc.corpus is None:
            self._tls.phases = {}
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32)
        batcher = self._batcher(field, fc, k, precision, num_candidates)
        result, phases = batcher.submit(
            (np.asarray(query_vector, dtype=np.float32), filter_rows))
        self._tls.phases = phases
        return result

    def search_many(self, field: str, queries: List[np.ndarray], k: int,
                    precision: str = "bf16",
                    num_candidates: Optional[int] = None,
                    filter_rows: Optional[Sequence] = None,
                    reader=None) -> list:
        """Score a batch of query vectors in one dispatch, on the calling
        thread: for a caller that already holds a batch (the hybrid
        executor's runner), past the batcher. `filter_rows[i]` (or None)
        filters query i."""
        results, phases = self._finalize(self.search_many_async(
            field, queries, k, precision=precision,
            num_candidates=num_candidates, filter_rows=filter_rows,
            reader=reader))
        self._tls.phases = phases
        return results

    def search_many_async(self, field: str, queries: List[np.ndarray],
                          k: int, precision: str = "bf16",
                          num_candidates: Optional[int] = None,
                          filter_rows: Optional[Sequence] = None,
                          reader=None):
        """Launch a batch's kNN without waiting for it: an opaque handle
        that `finalize_many` lands. The exhaustive route returns the boards
        still in flight; the IVF route (its router waits for the card
        between its phases) and empty fields complete here."""
        fc = self._field_for(field, reader)
        if fc is None or fc.corpus is None:
            return ("done", [(np.zeros(0, dtype=np.int64),
                              np.zeros(0, dtype=np.float32))
                             for _ in queries], {})
        filters = filter_rows if filter_rows is not None \
            else [None] * len(queries)
        return self._dispatch_many(fc, k, precision,
                                   list(zip(queries, filters)),
                                   num_candidates)

    def finalize_many(self, handle) -> list:
        """Land a `search_many_async` handle: wait for its boards (this
        batch's copies only), rescore packed rungs, join the row map. Its
        phases become the calling thread's `last_knn_phases`."""
        results, self._tls.phases = self._finalize(handle)
        return results

    def _finalize(self, handle) -> Tuple[list, dict]:
        kind, payload, phases = handle
        if kind == "done":
            return payload, phases
        fc, scores, ids, ready, k_eff, n_valid, n_real, rescore_ctx = payload
        if ready is not None:
            ready.synchronize()
        scores = scores.numpy()[:, :k_eff]
        ids = ids.numpy()[:, :k_eff]
        if rescore_ctx is not None:
            # phase two: exact f32 re-rank of the coarse window (the host
            # gather + score runs here, outside the run lock)
            scores, ids, phases["rescore"] = self._apply_rescore(
                rescore_ctx, scores, ids, n_real)
        return (self._land_results(fc, scores, ids, _FLOOR, n_valid, n_real),
                phases)

    def _dispatch_many(self, fc: FieldCorpus, k: int, precision: str,
                       requests: List[tuple],
                       num_candidates: Optional[int]):
        """Dispatch stage of one batch of (query vector, filter rows)
        requests: through the IVF router when the field has one and no
        fallback reason applies (completes here), else the exhaustive
        route, launched with no host wait: the queries (and a filtered
        batch's mask) go up from pinned memory and the boards come back
        into pinned memory behind an event. Returns (kind, payload,
        phases)."""
        n_valid = len(fc.row_map)
        n_real = len(requests)
        n_pad = fc.corpus.matrix.shape[0]
        batch = np.stack([np.asarray(q, dtype=np.float32)
                          for q, _ in requests])
        filters = [fr for _, fr in requests]
        any_filter = any(fr is not None for fr in filters)
        # two-phase plan: k widens to the coarse window BEFORE the bucket
        # ladder
        k_req = min(k, n_pad)
        rescore_ctx = self._rescore_ctx(fc, batch, k_req)
        k_eff = (k_req if rescore_ctx is None
                 else quant_rescore.coarse_window(
                     k_req, fc.rescore_oversample, limit=n_pad))
        self._bump(searches=1)
        phases: dict = {}
        if fc.router is not None:
            reason = fc.router.should_fallback(k_eff, any_filter, precision)
            if reason is None:
                results, phases = self._execute_ivf(
                    fc, k_eff, n_valid, batch, n_real, num_candidates,
                    rescore_ctx)
                return ("done", results, phases)
            self._bump(fallback_searches=1)
            phases = {"engine": "tpu_exhaustive", "fallback_reason": reason}
        padded = _pad_batch(batch, n_real)
        mask = None
        if any_filter:
            # a filtered batch takes the exact route, its unfiltered
            # requests too
            t0 = time.perf_counter_ns()
            mask = filter_mask(fc, filters, len(padded), n_pad).to(
                self.device, non_blocking=True)
            phases["mask_nanos"] = time.perf_counter_ns() - t0
        # k rounds up the bucket ladder; the extra columns slice away below
        # (top-k prefixes are exact)
        k_b = dispatch.bucket_k(k_eff, limit=n_pad)
        s, i = knn_ops.knn_search_auto(
            _to_device(padded, self.device), fc.corpus, k=k_b,
            metric=fc.metric, filter_mask=mask, precision=precision,
            rescore_candidates=fc.rescore_candidates)
        (s, i), ready = _to_host_async(s[:n_real, :k_eff], i[:n_real, :k_eff])
        return ("pending", (fc, s, i, ready, k_eff, n_valid, n_real,
                            rescore_ctx), phases)

    @staticmethod
    def _rescore_ctx(fc: FieldCorpus, queries: np.ndarray,
                     k_final: int) -> Optional[dict]:
        """Two-phase rescore context, or None when this field serves
        single-phase: active exactly when the corpus is packed int4 with
        rescore on."""
        if not fc.rescore or fc.source is None \
                or fc.corpus.matrix.dtype != torch.uint8:
            return None
        source = fc.source
        return {"queries": queries, "k": k_final, "metric": fc.metric,
                "gather": lambda ids: source[ids]}

    def _apply_rescore(self, ctx: dict, scores: np.ndarray,
                       ids: np.ndarray, n_real: int):
        """Run the exact-rescore phase over coarse boards (flat device row
        ids), fold the window stats into knn_stats, and return them as the
        batch's `rescore` phase."""
        t0 = time.perf_counter_ns()
        out_s, out_i, stats = quant_rescore.rescore_boards(
            ctx["queries"][:n_real], scores[:n_real], ids[:n_real],
            ctx["k"], ctx["gather"], ctx["metric"])
        nanos = time.perf_counter_ns() - t0
        self._bump(rescore_searches=1,
                   rescore_window_rows=stats["window"] * n_real,
                   rescore_promoted=stats["promoted"], rescore_nanos=nanos)
        return out_s, out_i, {"window": stats["window"],
                              "promoted": stats["promoted"],
                              "rescore_nanos": nanos}

    def _execute_ivf(self, fc: FieldCorpus, k_eff: int, n_valid: int,
                     queries: np.ndarray, n_real: int,
                     num_candidates: Optional[int],
                     rescore_ctx: Optional[dict]):
        """Serve one batch through the tpu_ivf router (packed encodings
        rescore the coarse window exactly before landing). Returns
        (results, phases)."""
        padded = _pad_batch(queries, n_real)
        k_b = dispatch.bucket_k(k_eff, limit=n_valid)
        scores, rows, phases = fc.router.search(
            padded, k_b, num_candidates=num_candidates)
        scores, rows = scores[:, :k_eff], rows[:, :k_eff]
        phases = dict(phases)
        if rescore_ctx is not None:
            scores, rows, phases["rescore"] = self._apply_rescore(
                rescore_ctx, scores, rows, n_real)
        t0 = time.perf_counter_ns()
        out = self._land_results(fc, scores, rows, _FLOOR, n_valid, n_real)
        phases["merge_nanos"] += time.perf_counter_ns() - t0
        self._bump(ivf_searches=1,
                   fused_probe_searches=int(phases["fused_probe"]),
                   **{ph: phases[ph] for ph in ("route_nanos", "score_nanos",
                                                "merge_nanos")})
        return out, phases

    @staticmethod
    def _land_results(fc, scores: np.ndarray, ids: np.ndarray,
                      floor: float, n_valid: int, n_real: int) -> list:
        out = []
        for qi in range(n_real):
            sc, rid = scores[qi], ids[qi]
            valid = (sc > floor) & (rid >= 0) & (rid < n_valid)
            sc, rid = sc[valid], rid[valid]
            out.append((fc.row_map[rid], sc.astype(np.float32)))
        return out
