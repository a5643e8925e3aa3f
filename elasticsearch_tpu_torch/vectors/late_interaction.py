"""Late-interaction (`rank_vectors`) field store: coarse, then MaxSim (port of
`elasticsearch_tpu/vectors/late_interaction.py`).

Serving shape per field:

* build (lazy, per reader snapshot): per-segment token blocks come
  codec-encoded from `columnar/blocks.py`, cached by the field per
  (segment, encoding, metric, dims) fingerprint so a refresh re-encodes only
  new segments, then assemble on the field's device into ONE token tile
  [N_pad, cap, W] plus per-token scales [N_pad, cap]. cap is the pow-2 max
  tokens per doc; N_pad is `_pow2(n + 1)`, so at least one all-zero padding
  row always exists (invalid coarse candidates clamp onto it and score
  NEG_INF). The pooled per-doc centroids build a standard coarse corpus
  (`ops/knn.build_corpus`) at the mapping's coarse rung, lane-padded on
  every device, so the candidate window never depends on the device. The
  tile, its scales, the row map and the coarse corpus form one immutable
  snapshot, published by a single assignment once it is built: a search
  reads the snapshot once and never sees a half-built field.

* search: pooled query centroids retrieve a top-(k·oversample) candidate
  window through the exact single-vector path (`ops/knn.knn_search`), then
  ONE fused rescore (`ops/maxsim.py`: the `maxsim_dense` / `maxsim_int4`
  kernels on the card) scores the whole batch's windows against the token
  tile. Ordering ties break by ascending global row. Each request records
  its coarse, rescore and select times, each taken after a device sync.

The exact oracle this path is recall-gated against is the host walker
(`search/queries_ext.LateInteractionQuery`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.columnar import blocks as columnar
from elasticsearch_tpu_torch.ops import dispatch, knn, maxsim
from elasticsearch_tpu_torch.quant import tokens as quant_tokens

_TQ_MIN = 8

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8}


def _pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy block as a tensor on `device`; bf16 arrives as its uint16
    bit pattern."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Snapshot:
    """One built state of a field: the token tile [N_pad, cap, W] and its
    scales [N_pad, cap] on the device, the row map and the coarse corpus
    (an ops.knn.Corpus over the pooled rows)."""

    __slots__ = ("n_docs", "cap", "n_pad", "tokens_total", "row_map",
                 "tile", "tile_scales", "coarse_corpus")

    def __init__(self, n_docs=0, cap=1, n_pad=1, tokens_total=0,
                 row_map=None, tile=None, tile_scales=None,
                 coarse_corpus=None):
        self.n_docs = n_docs                # docs bearing >= 1 token
        self.cap = cap                      # pow-2 max tokens/doc
        self.n_pad = n_pad                  # pow-2 tile rows (> n_docs)
        self.tokens_total = tokens_total
        self.row_map = (np.zeros(0, dtype=np.int64) if row_map is None
                        else row_map)
        self.tile = tile
        self.tile_scales = tile_scales
        self.coarse_corpus = coarse_corpus


class LateInteractionField:
    """One `rank_vectors` field's token tile + coarse corpus over a reader
    snapshot, resident on `device`."""

    def __init__(self, field: str, dims: int, metric: str = "cosine",
                 encoding: str = "int8", coarse: str = "f32",
                 oversample: int = 4, device="cuda"):
        self.field = field
        self.dims = int(dims)
        self.metric = metric
        self.encoding = encoding
        self.coarse_dtype = coarse
        self.oversample = int(oversample)
        self.device = resolve_device(device)
        self.variant = (encoding, metric, self.dims)
        self.version: tuple = ()
        self.snap = _Snapshot()
        self.columnar_refresh: dict = {}
        self.last_phases: dict = {}     # coarse/rescore/select nanos
        # per-segment encoded blocks, keyed by fingerprint
        self._blocks: Dict[tuple, columnar.TokenVectorBlock] = {}

    # the published snapshot's parts
    n_docs = property(lambda self: self.snap.n_docs)
    cap = property(lambda self: self.snap.cap)
    n_pad = property(lambda self: self.snap.n_pad)
    tokens_total = property(lambda self: self.snap.tokens_total)
    row_map = property(lambda self: self.snap.row_map)
    tile = property(lambda self: self.snap.tile)
    tile_scales = property(lambda self: self.snap.tile_scales)
    coarse_corpus = property(lambda self: self.snap.coarse_corpus)

    # ------------------------------------------------------------- build
    def sync(self, reader) -> bool:
        """(Re)assemble the token tile + coarse corpus; True if rebuilt.
        Segments whose fingerprint is cached are not re-encoded. Callers
        serialise syncs (the shard's lock); searches may run meanwhile on
        the snapshot published before."""
        # a combined reader repeats seg_ids across shards: the base (the
        # shard's row offset) tells their segments apart
        version = tuple((columnar.fingerprint(v), v.segment.base)
                        for v in reader.views)
        if version == self.version:
            return False
        blocks, cache = [], {}
        n_cached = n_extracted = 0
        for view in reader.views:
            fp = (columnar.fingerprint(view, (self.variant,)),
                  view.segment.base)
            blk = self._blocks.get(fp)
            if blk is not None or fp in self._blocks:
                n_cached += 1
            else:
                blk = columnar.extract_token_vector_block(
                    view, self.field, self.variant)
                n_extracted += 1
            cache[fp] = blk
            if blk is not None and blk.n_rows:
                blocks.append(blk)
        self._blocks = cache            # segments gone from the reader drop
        self.columnar_refresh = {
            "blocks": n_cached + n_extracted, "cached": n_cached,
            "extracted": n_extracted,
            "mode": ("cached" if not n_extracted else
                     "delta" if n_cached else "full")}

        n = sum(b.n_rows for b in blocks)
        counts = (np.concatenate([b.counts for b in blocks]).astype(np.int64)
                  if blocks else np.zeros(0, dtype=np.int64))
        w = quant_tokens.packed_width(self.encoding, self.dims)
        cap = _pow2(max(int(counts.max()) if n else 1, 1))
        n_pad = _pow2(n + 1)
        tokens_total = int(counts.sum())
        # token t of doc i lands at tile[i, t]: scattered on the device
        dtype = blocks[0].data.dtype if blocks else np.dtype(np.uint8)
        tdtype = (torch.bfloat16 if dtype == np.uint16
                  else _TORCH_DTYPES[np.dtype(dtype)])
        dev = self.device
        tile = torch.zeros((n_pad, cap, w), dtype=tdtype, device=dev)
        scales = torch.zeros((n_pad, cap), dtype=torch.float32, device=dev)
        if n:
            doc = torch.repeat_interleave(
                torch.arange(n, device=dev),
                torch.from_numpy(counts).to(dev))
            starts = torch.from_numpy(np.cumsum(counts) - counts).to(dev)
            pos = torch.arange(tokens_total, device=dev) - starts[doc]
            tile[doc, pos] = _tensor(np.concatenate(
                [b.data for b in blocks]), dev)
            scales[doc, pos] = _tensor(np.concatenate(
                [b.scales for b in blocks]), dev)
            del doc, pos, starts
        self.snap = _Snapshot(
            n_docs=n, cap=cap, n_pad=n_pad, tokens_total=tokens_total,
            row_map=(np.concatenate([b.rows for b in blocks]) if blocks
                     else None),
            tile=tile, tile_scales=scales,
            coarse_corpus=(knn.build_corpus(
                np.concatenate([b.pooled for b in blocks]),
                metric=self.metric, dtype=self.coarse_dtype,
                pad_to=knn.pad_rows(n), residual=False, device=dev)
                if n else None))
        self.version = version
        return True

    def nbytes(self) -> int:
        snap = self.snap
        if snap.tile is None:
            return 0
        return int(snap.tile.numel() * snap.tile.element_size()
                   + snap.tile_scales.numel() * 4)

    # ------------------------------------------------------------ search
    def coarse_window(self, k: int, snap: _Snapshot = None) -> int:
        """Bucketed candidate-window width for the fused rescore: the
        oversampled k, clamped to the live docs, then rounded up the k
        ladder and clamped to the lane-padded coarse row count."""
        n_docs = (snap or self.snap).n_docs
        rows = knn.pad_rows(max(n_docs, 1))
        win = min(max(k * self.oversample, k), max(n_docs, 1))
        return dispatch.bucket_k(win, limit=rows)

    def plan_queries(self, queries: Sequence[Tuple[np.ndarray, float]]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(q_tokens [Qp, Tq_pad, d_pad] f32, centroids [Qp, dims] f32,
        boosts [n_real]): tokens metric-prepped through the same
        `quant/tokens.py` prep the stored blocks ran, zero-padded to a pow-2
        token count (at least 8) and the tile's lane width; the query batch
        pads to its dispatch bucket with all-zero queries."""
        n_real = len(queries)
        n_bucket = dispatch.bucket_queries(max(n_real, 1))
        tq = 1
        prepped = []
        boosts = np.ones(n_real, dtype=np.float32)
        for i, (tokens, boost) in enumerate(queries):
            t = quant_tokens.prep_tokens(
                np.asarray(tokens, dtype=np.float32).reshape(-1, self.dims),
                self.metric)
            prepped.append(t)
            boosts[i] = np.float32(boost)
            tq = max(tq, len(t))
        tq_pad = _pow2(max(tq, _TQ_MIN))
        d_pad = quant_tokens.pad_dim(self.dims)
        q = np.zeros((n_bucket, tq_pad, d_pad), dtype=np.float32)
        cent = np.zeros((n_bucket, self.dims), dtype=np.float32)
        for i, t in enumerate(prepped):
            q[i, :len(t), :self.dims] = t
            cent[i] = quant_tokens.pool_doc(t, self.metric)
        return q, cent, boosts

    def search_batch(self, queries: Sequence[Tuple[np.ndarray, float]],
                     k: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Two-phase batch: coarse centroid top-W, the fused MaxSim rescore
        of the window, per-query top-k with (-score, ascending row) ties.
        Returns [(global rows, f32 scores)] per query; the phase times land
        in `last_phases`."""
        empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32))
        self.last_phases = {}
        snap = self.snap                # one snapshot for the whole batch
        if snap.n_docs == 0:
            return [empty for _ in queries]
        dev = self.device
        t0 = time.perf_counter_ns()
        q, cent, boosts = self.plan_queries(queries)
        wc = self.coarse_window(k, snap)
        _scores_c, ids_c = knn.knn_search(
            torch.from_numpy(cent).to(dev), snap.coarse_corpus, k=wc,
            metric=self.metric)
        # invalid coarse slots (padding rows of the coarse corpus, or
        # windows wider than the live doc count) clamp onto the token tile's
        # reserved all-zero padding row -> NEG_INF in the board
        invalid = (ids_c < 0) | (ids_c >= snap.n_docs)
        ids = torch.where(invalid, torch.full_like(ids_c, snap.n_docs),
                          ids_c).to(torch.int32)
        _sync(dev)
        t1 = time.perf_counter_ns()
        board = maxsim.maxsim_rescore(ids, torch.from_numpy(q).to(dev),
                                      snap.tile, snap.tile_scales)
        _sync(dev)
        t2 = time.perf_counter_ns()
        board = board.cpu().numpy()
        ids_np = ids.cpu().numpy()
        invalid = invalid.cpu().numpy()
        out = []
        for qi in range(len(queries)):
            s = board[qi]
            keep = ~invalid[qi] & (s > -np.inf) & np.isfinite(s)
            cand = ids_np[qi][keep]
            sv = s[keep]
            rows = snap.row_map[cand]
            order = np.lexsort((rows, -sv))[:k]
            out.append((rows[order],
                        (sv[order] * boosts[qi]).astype(np.float32)))
        self.last_phases = {"coarse_nanos": t1 - t0,
                            "rescore_nanos": t2 - t1,
                            "select_nanos": time.perf_counter_ns() - t2}
        return out


class LateInteractionShard:
    """Per-index late-interaction store: one LateInteractionField per
    `rank_vectors` field, lazily synced on first hybrid use."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._fields: Dict[str, LateInteractionField] = {}
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"searches": 0, "queries": 0, "rebuilds": 0,
                      "score_nanos": 0, "coarse_nanos": 0,
                      "rescore_nanos": 0, "select_nanos": 0}
        self.last_phases: dict = {}

    def field(self, reader, mapper) -> LateInteractionField:
        """mapper: the field's RankVectorsFieldMapper (geometry + encoding
        come from the mapping, not the caller)."""
        with self._lock:
            lf = self._fields.get(mapper.name)
            if lf is None:
                lf = LateInteractionField(
                    mapper.name, mapper.dims, metric=mapper.similarity,
                    encoding=mapper.encoding, coarse=mapper.coarse,
                    oversample=mapper.oversample, device=self.device)
                self._fields[mapper.name] = lf
            if lf.sync(reader):
                with self._stats_lock:
                    self.stats["rebuilds"] += 1
            return lf

    def search_batch(self, reader, mapper, queries, k: int):
        lf = self.field(reader, mapper)
        t0 = time.perf_counter_ns()
        out = lf.search_batch(queries, k)
        nanos = time.perf_counter_ns() - t0
        phases = lf.last_phases
        with self._stats_lock:
            self.stats["searches"] += 1
            self.stats["queries"] += len(queries)
            self.stats["score_nanos"] += nanos
            for key, v in phases.items():
                self.stats[key] += v
            self.last_phases = phases
        return out

    def field_stats(self) -> Dict[str, dict]:
        with self._lock:
            return {name: self._field_stats(lf)
                    for name, lf in self._fields.items()}

    @staticmethod
    def _field_stats(lf: LateInteractionField) -> dict:
        snap = lf.snap
        return {"docs": snap.n_docs, "tokens": snap.tokens_total,
                "cap": snap.cap, "encoding": lf.encoding,
                "tile_bytes": lf.nbytes(),
                "columnar_refresh": dict(lf.columnar_refresh)}
