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

Left out, as ROADMAP.md lists: the combining batcher, generational
segments, the mesh, the semantic cache, the host mirror, filtered kNN and
the binary rung.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.index.mapping import DenseVectorFieldMapper
from elasticsearch_tpu_torch.index.segment import ShardReader
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import knn as knn_ops
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.quant import rescore as quant_rescore

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
                 "rescore_candidates", "router", "source")

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


def _pad_batch(queries: np.ndarray, n_real: int) -> np.ndarray:
    """Pad a query batch to the dispatch layer's query bucket; pad results
    are sliced away by the caller."""
    b_pad = dispatch.bucket_queries(n_real)
    if b_pad != n_real:
        queries = np.concatenate(
            [queries, np.zeros((b_pad - n_real, queries.shape[1]),
                               dtype=np.float32)])
    return queries


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
        self.last_knn_phases: dict = {}

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
            # tuned nprobe until drift forces a retrain
            old.index.add(full[old_n:],
                          np.arange(old_n, len(row_map), dtype=np.int32))
            if not old.index.needs_retrain:
                return old
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

    def search(self, field: str, query_vector: np.ndarray, k: int,
               precision: str = "bf16",
               num_candidates: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search. Returns (global_rows [m], raw_scores [m]), m <= k
        (padding slots removed)."""
        return self.search_many(field, [query_vector], k,
                                precision=precision,
                                num_candidates=num_candidates)[0]

    def search_many(self, field: str, queries: List[np.ndarray], k: int,
                    precision: str = "bf16",
                    num_candidates: Optional[int] = None) -> list:
        """Score a batch of query vectors in one dispatch: through the IVF
        router when the field has one and no fallback reason applies,
        else the exhaustive route; packed rungs then rescore exactly."""
        fc = self._fields.get(field)
        if fc is None or fc.corpus is None:
            return [(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32))
                    for _ in queries]
        n_valid = len(fc.row_map)
        n_real = len(queries)
        n_pad = fc.corpus.matrix.shape[0]
        batch = np.stack([np.asarray(q, dtype=np.float32) for q in queries])
        # two-phase plan: k widens to the coarse window BEFORE the bucket
        # ladder
        k_req = min(k, n_pad)
        rescore_ctx = self._rescore_ctx(fc, batch, k_req)
        k_eff = (k_req if rescore_ctx is None
                 else quant_rescore.coarse_window(
                     k_req, fc.rescore_oversample, limit=n_pad))
        self._bump(searches=1)
        self.last_knn_phases = {}
        if fc.router is not None:
            reason = fc.router.should_fallback(k_eff, False, precision)
            if reason is None:
                return self._execute_ivf(fc, k_eff, n_valid, batch, n_real,
                                         num_candidates, rescore_ctx)
            self._bump(fallback_searches=1)
            self.last_knn_phases = {"engine": "tpu_exhaustive",
                                    "fallback_reason": reason}
        padded = _pad_batch(batch, n_real)
        # k rounds up the bucket ladder; the extra columns slice away below
        # (top-k prefixes are exact)
        k_b = dispatch.bucket_k(k_eff, limit=n_pad)
        s, i = knn_ops.knn_search_auto(
            torch.from_numpy(padded).to(self.device), fc.corpus, k=k_b,
            metric=fc.metric, precision=precision,
            rescore_candidates=fc.rescore_candidates)
        scores = s[:, :k_eff].cpu().numpy()
        ids = i[:, :k_eff].cpu().numpy()
        if rescore_ctx is not None:
            scores, ids = self._apply_rescore(rescore_ctx, scores, ids,
                                              n_real)
        return self._land_results(fc, scores, ids, _FLOOR, n_valid, n_real)

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
        ids) and fold the window stats into knn_stats / last_knn_phases."""
        t0 = time.perf_counter_ns()
        out_s, out_i, stats = quant_rescore.rescore_boards(
            ctx["queries"][:n_real], scores[:n_real], ids[:n_real],
            ctx["k"], ctx["gather"], ctx["metric"])
        nanos = time.perf_counter_ns() - t0
        self._bump(rescore_searches=1,
                   rescore_window_rows=stats["window"] * n_real,
                   rescore_promoted=stats["promoted"], rescore_nanos=nanos)
        phases = dict(self.last_knn_phases or {})
        phases["rescore"] = {"window": stats["window"],
                             "promoted": stats["promoted"],
                             "rescore_nanos": nanos}
        self.last_knn_phases = phases
        return out_s, out_i

    def _execute_ivf(self, fc: FieldCorpus, k_eff: int, n_valid: int,
                     queries: np.ndarray, n_real: int,
                     num_candidates: Optional[int],
                     rescore_ctx: Optional[dict]) -> list:
        """Serve one batch through the tpu_ivf router (packed encodings
        rescore the coarse window exactly before landing)."""
        padded = _pad_batch(queries, n_real)
        k_b = dispatch.bucket_k(k_eff, limit=n_valid)
        scores, rows, phases = fc.router.search(
            padded, k_b, num_candidates=num_candidates)
        scores, rows = scores[:, :k_eff], rows[:, :k_eff]
        phases = dict(phases)
        if rescore_ctx is not None:
            scores, rows = self._apply_rescore(rescore_ctx, scores, rows,
                                               n_real)
            phases["rescore"] = self.last_knn_phases["rescore"]
        t0 = time.perf_counter_ns()
        out = self._land_results(fc, scores, rows, _FLOOR, n_valid, n_real)
        phases["merge_nanos"] += time.perf_counter_ns() - t0
        self._bump(ivf_searches=1,
                   fused_probe_searches=int(phases["fused_probe"]),
                   **{ph: phases[ph] for ph in ("route_nanos", "score_nanos",
                                                "merge_nanos")})
        self.last_knn_phases = phases
        return out

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
