"""Per-shard device vector store: segments → device corpus (port of
`elasticsearch_tpu/vectors/store.py`, less the mesh, the host mirror and
the semantic cache).

Each vector field of a shard is mirrored on the device, with a row map
joining device rows back to the engine's global rows (and thence `_id`).
The field's rows are read through the segment block store
(`columnar/store.py`), so a refresh extracts only new or changed segments.
With generational segments on (`index.segments.enabled`, the default;
`segments/`), the first refresh builds the field's corpus and later ones
are absorbed by its `GenerationalCorpus`: new rows seal into a small L0
generation, deletes set tombstones, and a background thread merges
generations (and retrains an IVF layout) off the refresh path. Only a
first build, a metric change and an engine segment rewrite (its merge
re-bases rows) rebuild the corpus; a bulk load into an established field
seals as one generation, which `_forcemerge` folds into the base. Each
rebuild of a resident corpus is counted with its reason
(`segment_stats`). A field whose snapshot is one clean generation serves
as the single corpus does; otherwise a batch runs one board a generation,
merged in flat row order, and the handle holds that snapshot until the
batch has landed.

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

Each dispatched batch holds an in-flight slot until its finalize (or the
garbage collection of a handle dropped unfinalized) releases it: the
`serving.inflight_dispatches` gauge of `_nodes/stats/telemetry`. A
`search` may carry `deadline_at`, an absolute deadline its batcher sheds
the request at when no runner has claimed it by then.

A request may carry `filter_rows`, the sorted engine rows its filter
query let through. Filtered and unfiltered requests share batches; a
batch holding any filter takes the exact route with a [B, N] row mask
(every valid row for a request without a filter), and an IVF field falls
back to its exhaustive corpus for it (`fallback_reason: filtered`). A
request names the reader its filter ran on, and is served from the
corpus synced for that reader.

Left out, as ROADMAP.md lists: the mesh (and a generation's graduation to
it), the semantic cache, the host mirror and its cost router, and the
binary rung.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.columnar import store as columnar
from elasticsearch_tpu_torch.index.mapping import DenseVectorFieldMapper
from elasticsearch_tpu_torch.index.segment import ShardReader
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import knn as knn_ops
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.quant import codec as quant_codec
from elasticsearch_tpu_torch.quant import rescore as quant_rescore
from elasticsearch_tpu_torch.segments import (
    GenerationalCorpus, TieredMergePolicy, row_index_of,
)
from elasticsearch_tpu_torch.serving.batcher import CombiningBatcher
from elasticsearch_tpu_torch.telemetry import metrics as _telemetry_metrics

logger = logging.getLogger("elasticsearch_tpu_torch.vectors")

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
    """Device corpus for one vector field + host-side row map.

    A generational field's view (`gens` set) holds the `GenerationSet` it
    was made for (`snap`): `corpus`, `router` and `source` are its base
    generation's, `row_map` its flat row map."""

    __slots__ = ("corpus", "row_map", "metric", "dims", "version",
                 "encoding", "rescore", "rescore_oversample",
                 "rescore_candidates", "router", "source", "gens", "snap",
                 "_row_index")

    def __init__(self, corpus, row_map: np.ndarray, metric: str, dims: int,
                 version: tuple, encoding: str = "bf16",
                 rescore: bool = False, rescore_oversample: int = 4,
                 rescore_candidates: int = 128, router=None, source=None,
                 gens=None, snap=None):
        self.corpus = corpus          # knn_ops.Corpus or None (empty field)
        self.row_map = row_map        # device row -> engine global row
        self.metric = metric
        self.dims = dims
        self.version = version        # segment/tombstone fingerprint
        self.encoding = encoding
        # two-phase rescore of packed rungs: window = k · oversample, exact
        # rows gathered from `source` (a columnar RowSource, device row
        # order)
        self.rescore = rescore
        self.rescore_oversample = rescore_oversample
        self.rescore_candidates = rescore_candidates
        self.router = router          # ann.IVFRouter (tpu_ivf) or None
        self.source = source
        self.gens = gens              # segments.GenerationalCorpus or None
        self.snap = snap              # its GenerationSet for this view
        self._row_index = None

    def row_index(self) -> np.ndarray:
        """Engine global row -> device row (-1: not in this corpus), made
        at the first filtered request."""
        if self._row_index is None:
            self._row_index = row_index_of(self.row_map)
        return self._row_index


def filter_mask(fc, filters: Sequence[Optional[np.ndarray]],
                b_pad: int, n_pad: int) -> torch.Tensor:
    """[b_pad, n_pad] bool host mask of a batch over `fc` (a FieldCorpus,
    or a generation: anything with `row_map`, `row_index()` and
    `corpus`): row i keeps every valid device row when filters[i] is None,
    else the device rows of the engine rows in filters[i]
    (`np.isin(fc.row_map, filters[i])`, by a scatter through `row_index`
    instead of a search over the whole row map). Pad rows and pad queries
    keep nothing. For a corpus on the card it is built in pinned memory,
    so its upload does not wait on the host."""
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


class _InflightSlot:
    """One dispatched, not yet finalized batch's place in the store's
    in-flight count. A pending handle carries its slot so the count cannot
    leak: `finalize_many` releases it, and a handle dropped unfinalized (a
    caller that launched several legs and raised before landing them all)
    releases at garbage collection. `release` is idempotent."""

    __slots__ = ("_store",)

    def __init__(self, store):
        self._store = store

    def release(self) -> None:
        store, self._store = self._store, None
        if store is not None:
            store._end_dispatch()

    def __del__(self):
        self.release()


class VectorStoreShard:
    def __init__(self, dtype: str = "bf16", device="cuda",
                 knn_engine: str = "tpu", knn_nlist=None,
                 knn_nprobe="auto", segments_enabled: bool = True,
                 segments_tier_size: int = 4, segments_max_l0: int = 8,
                 segments_merge_budget_ms: float = 50.0,
                 segments_background_merge: bool = True):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.knn_engine = knn_engine        # "tpu" (exhaustive) | "tpu_ivf"
        self.knn_nlist = knn_nlist          # None = pick_nlist(n)
        self.knn_nprobe = knn_nprobe        # "auto" | int
        # generational device segments (`index.segments.*`): refresh seals
        # L0 generations and sets tombstones, a background tiered merger
        # consolidates; off, every changed refresh rebuilds the field
        self.segments_enabled = bool(segments_enabled)
        self.segments_tier_size = segments_tier_size
        self.segments_max_l0 = segments_max_l0
        self.segments_merge_budget_ms = segments_merge_budget_ms
        self.segments_background_merge = bool(segments_background_merge)
        self._gens: Dict[str, GenerationalCorpus] = {}
        # every rebuild of a resident corpus, by reason, and the refreshes
        # the generational path absorbed instead
        self.segment_counters: Dict[str, object] = {
            "full_rebuilds": 0, "rebuilds_avoided": 0,
            "rebuild_reasons": {}}
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
            "route_nanos": 0, "score_nanos": 0, "merge_nanos": 0,
            # batches over more than one generation (or a tombstoned one),
            # and their per-generation legs by route
            "generational_searches": 0, "segment_legs_exact": 0,
            "segment_legs_auto": 0}
        # key -> (the FieldCorpus the batcher serves, the batcher)
        self._batchers: Dict[tuple, Tuple[FieldCorpus, CombiningBatcher]] = {}
        self._batchers_lock = threading.Lock()
        # scheduler counters of batchers retired at refresh
        self._sched_retired: Dict[str, int] = {}
        # per-thread phases of the last search (`last_knn_phases`)
        self._tls = threading.local()
        # each field's last refresh composition in the block store
        # (cached / delta / full), for `profile.knn.columnar`
        self.columnar_refresh: Dict[str, dict] = {}
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
        """Bring every vector field whose segment composition or plan
        changed up to `reader`: through its generational corpus when it
        has one and the refresh can be absorbed
        (`GenerationalCorpus.try_incremental`), else by a full build of
        its corpus (and its IVF router), which becomes the field's new
        generation 0."""
        for field, mapper in vector_mappers.items():
            version = self._fingerprint(reader, field)
            plan = self._encoding_plan(mapper)
            cached = self._fields.get(field)
            if (cached is not None and cached.version == version
                    and self._field_plans.get(field) == plan):
                continue
            view = columnar.STORE.vector_view(reader, field)
            row_map = view.row_map
            self.columnar_refresh[field] = view.refresh
            metric = _METRIC_MAP[mapper.similarity]
            dtype = plan["encoding"]
            # the int8 rung's device rescore level; packed rungs rescore
            # from the host rows instead
            residual = plan["rescore"] and dtype == "int8"
            gc = self._gens.get(field) if self.segments_enabled else None
            if len(row_map) == 0:
                self._install(field, plan, FieldCorpus(
                    None, row_map, metric, mapper.dims, version))
                self._drop_gens(field)
                continue
            if gc is not None:
                if cached is None or self._reader_prefix_ok(cached.version,
                                                            version):
                    outcome = gc.try_incremental(view, row_map, dtype=dtype,
                                                 metric=metric,
                                                 rescore=residual)
                else:
                    # the engine rewrote its segments (its merge): row ids
                    # were re-based, so one id no longer names one doc
                    gc.last_rebuild_reason = "segment_rewrite"
                    outcome = None
                if outcome is not None:
                    if outcome != "noop":
                        with self._stats_lock:
                            self.segment_counters["rebuilds_avoided"] += 1
                    self._install(field, plan, self._generational_view(
                        gc, gc.snapshot(), metric, mapper.dims, version,
                        plan))
                    continue
            reason = (gc.last_rebuild_reason if gc is not None
                      else self._rebuild_reason(cached, row_map, dtype))
            self._full_build(field, mapper, plan, view, cached, version,
                             metric, reason)
        with self._lock:
            self._snapshots[reader] = dict(self._fields)

    def _install(self, field: str, plan: dict, fc: FieldCorpus) -> None:
        with self._lock:
            self._fields[field] = fc
            self._field_plans[field] = plan
        self._retire_field(field)

    def _drop_gens(self, field: str, wait: bool = False) -> None:
        gc = self._gens.pop(field, None)
        if gc is not None:
            gc.close(timeout_s=60.0 if wait else 0.0)

    def _full_build(self, field, mapper, plan, view, cached, version,
                    metric, reason) -> None:
        """The full build of one field (its corpus and IVF router) from
        the block store's view, counted when it replaces a resident
        corpus; with segments on it becomes a new generational corpus."""
        dtype = plan["encoding"]
        residual = plan["rescore"] and dtype == "int8"
        full = view.matrix()
        row_map = view.row_map
        corpus = knn_ops.build_corpus(full, metric=metric, dtype=dtype,
                                      residual=residual, device=self.device)
        router = None
        if (self._field_engine(mapper) == "tpu_ivf"
                and len(row_map) >= IVF_MIN_ROWS):
            router = self._ivf_router(field, mapper, cached, full, row_map,
                                      metric, dtype)
        del full
        if (cached is not None and cached.corpus is not None
                and reason is not None):
            with self._stats_lock:
                self.segment_counters["full_rebuilds"] += 1
                reasons = self.segment_counters["rebuild_reasons"]
                reasons[reason] = reasons.get(reason, 0) + 1
            logger.info("full corpus rebuild of field [%s]: reason=%s "
                        "rows=%d", field, reason, len(row_map))
        source = view.as_source()
        gc = None
        if self.segments_enabled:
            gc = GenerationalCorpus.from_monolithic(
                corpus, row_map, source, metric, dtype, residual,
                mapper.dims, router=router, device=self.device,
                policy=TieredMergePolicy(self.segments_tier_size,
                                         self.segments_max_l0),
                merge_budget_ms=self.segments_merge_budget_ms,
                background=self.segments_background_merge,
                knn_params={"engine": self._field_engine(mapper),
                            "min_rows": IVF_MIN_ROWS},
                view_cb=lambda g, _f=field: self._reinstall_view(_f, g),
                ivf_build=lambda vecs, m, d, _f=field, _mp=mapper:
                    self._train_router(_f, _mp, vecs, m, d)[0])
            self._drop_gens(field)
            self._gens[field] = gc
            fc = self._generational_view(gc, gc.snapshot(), metric,
                                         mapper.dims, version, plan)
        else:
            fc = FieldCorpus(corpus, row_map, metric, mapper.dims, version,
                             encoding=dtype, rescore=plan["rescore"],
                             rescore_oversample=plan["rescore_oversample"],
                             rescore_candidates=plan["rescore_candidates"],
                             router=router, source=source)
        self._install(field, plan, fc)

    @staticmethod
    def _reader_prefix_ok(old_version: tuple, new_version: tuple) -> bool:
        """An incremental refresh needs the old reader's segments to be a
        prefix of the new one's (the same ids and sizes, live counts only
        shrinking, new segments after): an engine segment rewrite re-bases
        rows, and the row-id classifier would seal the wrong rows."""
        if len(old_version) > len(new_version):
            return False
        return all(o[0] == n[0] and o[1] == n[1] and o[2] >= n[2]
                   for o, n in zip(old_version, new_version))

    @staticmethod
    def _rebuild_reason(cached: Optional[FieldCorpus], row_map: np.ndarray,
                        dtype: str) -> Optional[str]:
        """Why a full build replaces a resident corpus when the field has
        no generational corpus (None: a first build)."""
        if cached is None or cached.corpus is None \
                or len(cached.row_map) == 0:
            return None
        if cached.corpus.matrix.dtype != quant_codec.MATRIX_DTYPES[dtype]:
            return "dtype_change"
        old = cached.row_map
        if len(row_map) >= len(old) \
                and np.array_equal(row_map[:len(old)], old):
            return "append_headroom"
        if np.isin(old, row_map, invert=True).any():
            return "deletes"
        return "segment_rewrite"

    def _generational_view(self, gc, snap, metric: str, dims: int,
                           version: tuple, plan: dict) -> FieldCorpus:
        """The FieldCorpus of one generation set: its base generation's
        corpus, router and source (what one clean generation serves with)
        and the flat row map."""
        base = snap.generations[0]
        return FieldCorpus(
            base.corpus, snap.row_map, metric, dims, version,
            encoding=plan["encoding"], rescore=plan["rescore"],
            rescore_oversample=plan["rescore_oversample"],
            rescore_candidates=plan["rescore_candidates"],
            router=base.router, source=base.source, gens=gc, snap=snap)

    def _reinstall_view(self, field: str, gc) -> None:
        """After a background merge installed: serve the merged set from
        every view of the same epoch (the latest one and those of readers
        synced to it; a merge keeps the live rows and their order), and
        retire the field's batchers, so the old generations go once the
        batches holding them have landed. A view of an earlier epoch keeps
        its own set."""
        snap = gc.snapshot()
        with self._lock:
            fc = self._fields.get(field)
            if self._gens.get(field) is not gc or fc is None \
                    or fc.gens is not gc:
                return
            renewed: Dict[int, FieldCorpus] = {}

            def renew(old: FieldCorpus) -> FieldCorpus:
                if old.gens is not gc or old.snap.epoch != snap.epoch \
                        or old.snap is snap:
                    return old
                if id(old) not in renewed:
                    renewed[id(old)] = self._generational_view(
                        gc, snap, old.metric, old.dims, old.version,
                        self._field_plans[field])
                return renewed[id(old)]

            self._fields[field] = renew(fc)
            for fields in list(self._snapshots.values()):
                if field in fields:
                    fields[field] = renew(fields[field])
        self._retire_field(field)

    def segment_stats(self) -> dict:
        """The generational counters of this shard: its rebuilds (with
        their reasons) and the rebuilds avoided, and the generation, tier
        and merge counters summed over its fields."""
        with self._stats_lock:
            out = {"full_rebuilds": self.segment_counters["full_rebuilds"],
                   "rebuilds_avoided":
                       self.segment_counters["rebuilds_avoided"],
                   "rebuild_reasons": dict(
                       self.segment_counters["rebuild_reasons"]),
                   "enabled": self.segments_enabled}
        agg: Dict[str, int] = {}
        tiers: Dict[str, dict] = {}
        merge_reasons: Dict[str, int] = {}
        for gc in list(self._gens.values()):
            for key, val in gc.segment_stats().items():
                if key == "tiers":
                    for t, tv in val.items():
                        slot = tiers.setdefault(t, {k: 0 for k in tv})
                        for k2, v2 in tv.items():
                            slot[k2] += v2
                elif key == "merge_reasons":
                    for r, c in val.items():
                        merge_reasons[r] = merge_reasons.get(r, 0) + c
                else:
                    agg[key] = agg.get(key, 0) + val
        out.update(agg)
        out["tiers"] = tiers
        out["merge_reasons"] = merge_reasons
        return out

    def _ivf_router(self, field, mapper, cached, full, row_map, metric,
                    dtype):
        """The field's IVF router: the cached one extended by an
        append-only refresh, else one over a restored layout, else one
        over a freshly trained layout."""
        old = cached.router if cached is not None else None
        old_n = len(cached.row_map) if cached is not None else 0
        if cached is not None and cached.snap is not None \
                and not cached.snap.simple:
            # the router covers the base generation only, not the flat
            # row map of the view
            old = None
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
        router, restored = self._train_router(field, mapper, full, metric,
                                              dtype)
        self._bump(**{"ivf_restores" if restored else "ivf_trains": 1})
        return router

    def _train_router(self, field, mapper, full, metric, dtype):
        """(A router over a layout staged by `restore_ivf_layout` when one
        fits these rows, else over a freshly trained one, and whether it
        was restored): the full build's and the merge thread's."""
        from elasticsearch_tpu_torch.ann import IVFRouter, build_ivf_index
        from elasticsearch_tpu_torch.ann.ivf_index import (
            ivf_from_layout, layout_compatible)
        opts = mapper.params.get("index_options") or {}
        nlist = opts.get("nlist", self.knn_nlist)
        ivf = None
        layout = self._restored_ivf.pop(field, None)
        if layout is not None and layout_compatible(
                layout, len(full), mapper.dims, metric, dtype):
            ivf = ivf_from_layout(layout, full)
        restored = ivf is not None
        if ivf is None:
            ivf = build_ivf_index(
                full, metric=metric,
                nlist=int(nlist) if nlist is not None else None,
                dtype=dtype, seed=0, device=self.device)
        return IVFRouter(ivf, nprobe=opts.get("nprobe", self.knn_nprobe),
                         device=self.device), restored

    def field(self, name: str) -> Optional[FieldCorpus]:
        return self._fields.get(name)

    def close(self) -> None:
        """Drop every field's corpus and generations, the per-reader
        snapshots and the batchers (an index delete), after the merge
        threads have stopped: the device memory goes with the last
        reference. Requests still queued in a batcher finish against the
        corpus it closed over."""
        for field in list(self._gens):
            self._drop_gens(field, wait=True)
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

    # ------------------------------------------------------- in flight
    @staticmethod
    def _begin_dispatch() -> None:
        """Count one batch in flight on the `serving.inflight_dispatches`
        gauge (looked up at each call, so a registry `reset()` leaves no
        stale handle). The reference's count of the other batches in
        flight feeds its mesh router, which is not ported."""
        _telemetry_metrics.gauge("serving.inflight_dispatches").inc()

    @staticmethod
    def _end_dispatch() -> None:
        _telemetry_metrics.gauge("serving.inflight_dispatches").dec()

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
               reader=None, deadline_at: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search. Returns (global_rows [m], raw_scores [m]), m <= k
        (padding and filtered-out slots removed). `filter_rows`: the sorted
        engine rows allowed to match, from a filter query run on `reader`.
        Concurrent callers coalesce through a per-(field, version, k,
        precision, num_candidates) combining batcher into one dispatch;
        `deadline_at` (time.monotonic seconds) sheds the request there
        when no runner claims it in time (`EsRejectedExecutionError`)."""
        fc = self._field_for(field, reader)
        if fc is None or fc.corpus is None:
            self._tls.phases = {}
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32)
        batcher = self._batcher(field, fc, k, precision, num_candidates)
        result, phases = batcher.submit(
            (np.asarray(query_vector, dtype=np.float32), filter_rows),
            deadline_at=deadline_at)
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
        kind, payload, phases = handle[:3]
        if kind == "done":
            return payload, phases
        try:
            return self._land_pending(payload, phases)
        finally:
            if len(handle) > 3:     # `_dispatch_many`'s in-flight slot
                handle[3].release()

    def _land_pending(self, payload, phases: dict) -> Tuple[list, dict]:
        # `fc`: the FieldCorpus, or the GenerationSet of a generational
        # batch (the flat row map), held until the boards have landed
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
        """`_dispatch_routed` inside an in-flight slot: a pending handle
        carries its slot as a fourth element, which `_finalize` releases."""
        self._begin_dispatch()
        slot = _InflightSlot(self)
        try:
            handle = self._dispatch_routed(fc, k, precision, requests,
                                           num_candidates)
        except BaseException:
            slot.release()
            raise
        if handle[0] == "done":
            slot.release()
            return handle
        return handle + (slot,)

    def _dispatch_routed(self, fc: FieldCorpus, k: int, precision: str,
                         requests: List[tuple],
                         num_candidates: Optional[int]):
        """Dispatch stage of one batch of (query vector, filter rows)
        requests: through the IVF router when the field has one and no
        fallback reason applies (completes here), else the exhaustive
        route, launched with no host wait: the queries (and a filtered
        batch's mask) go up from pinned memory and the boards come back
        into pinned memory behind an event. A generational view whose set
        is more than one clean generation fans out instead
        (`_dispatch_generational`). Returns (kind, payload, phases)."""
        if fc.snap is not None and not fc.snap.simple:
            return self._dispatch_generational(fc.snap, fc, k, precision,
                                               requests, num_candidates)
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

    def _dispatch_generational(self, snap, fc: FieldCorpus, k: int,
                               precision: str, requests: List[tuple],
                               num_candidates: Optional[int]):
        """One board a generation, merged in flat row order
        (`GenerationSet.search_async`): L0 seals and tombstoned
        generations between merges. The handle holds `snap` until its
        boards land, so a merge installing meanwhile neither swaps the row
        map under it nor frees the tensors it reads. Packed generations
        rescore the coarse window through `snap.gather_rows`."""
        n_real = len(requests)
        batch = np.stack([np.asarray(q, dtype=np.float32)
                          for q, _ in requests])
        filters = [fr for _, fr in requests]
        k_req = min(k, snap.total_pad)
        rescore_ctx = None
        k_eff = k_req
        if fc.rescore and any(g.corpus.matrix.dtype == torch.uint8
                              for g in snap.generations):
            rescore_ctx = {"queries": batch, "k": k_req,
                           "metric": fc.metric, "gather": snap.gather_rows}
            k_eff = quant_rescore.coarse_window(
                k_req, fc.rescore_oversample, limit=snap.total_pad)
        padded = _pad_batch(batch, n_real)
        self._bump(searches=1, generational_searches=1)
        s, i, phases = snap.search_async(
            _to_device(padded, self.device), padded, n_real, k_eff, filters,
            fc.metric, precision, num_candidates=num_candidates,
            bump=self._bump)
        (s, i), ready = _to_host_async(s[:n_real, :k_eff], i[:n_real, :k_eff])
        return ("pending", (snap, s, i, ready, k_eff, len(snap.row_map),
                            n_real, rescore_ctx), phases)

    @staticmethod
    def _rescore_ctx(fc: FieldCorpus, queries: np.ndarray,
                     k_final: int) -> Optional[dict]:
        """Two-phase rescore context, or None when this field serves
        single-phase: active exactly when the corpus is packed int4 with
        rescore on."""
        if not fc.rescore or fc.source is None \
                or fc.corpus.matrix.dtype != torch.uint8:
            return None
        return {"queries": queries, "k": k_final, "metric": fc.metric,
                "gather": fc.source.gather}

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
