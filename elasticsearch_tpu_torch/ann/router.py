"""Query-time IVF engine: routing, nprobe selection, fallback, timings
(port of `elasticsearch_tpu/ann/router.py`, single device).

`IVFRouter.search` runs the two device stages — centroid routing
(`ops/knn_ivf.route`) and pruned scoring — separately, with a device sync
after each, so the per-phase times (route / score / merge) are measured,
not modeled. Scoring takes the fused kernels (`ops/ivf_fused.py`) when the
layout and metric are eligible (dot-like metrics at bf16 precision), and
the scan route (`ops/knn_ivf.score_probes`) otherwise (l2).

nprobe selection:
  * an integer setting is clamped to nlist and snapped up to the pow-2
    ladder (never fewer partitions than configured);
  * `"auto"` tunes once per layout: a held-out sample of the indexed
    vectors is the query set, the engine's own full-probe (nprobe = nlist)
    result the ground truth, and nprobe doubles until recall@k meets
    `RECALL_TARGET` plus a margin;
  * `num_candidates` widens a request's probing so that at least that
    many rows are scored, snapped to the next pow-2 rung.

Fallback to the exhaustive path (`should_fallback`): filtered searches,
f32-precision requests, layouts flagged `needs_retrain`, empty layouts,
and k beyond one partition's capacity.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.ann.ivf_index import IVFIndex
from elasticsearch_tpu_torch.ops import ivf_fused as fused
from elasticsearch_tpu_torch.ops import knn_ivf


# the auto-tuner's recall gate: RECALL_TARGET + TUNE_MARGIN (tune slightly
# past the target: the gate is measured on a finite held-out sample, and
# serving queries are noisier than corpus rows), over TUNE_SAMPLE indexed
# rows drawn with numpy from TUNE_SEED, as the reference draws them
RECALL_TARGET = 0.95
TUNE_MARGIN = 0.01
TUNE_SAMPLE = 128
TUNE_SEED = 0


def _pad_back_k(scores: np.ndarray, rows: np.ndarray, k: int, k_dev: int):
    """Widen results [Q, k_dev] back to the requested [Q, k] with the
    empty-slot sentinels (-inf, -1): the probed-row budget caps what the
    scorers can return."""
    if k_dev < k:
        pad = k - k_dev
        scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
        rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
    return scores, rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class IVFRouter:
    """One field's IVF engine instance (wraps the layout + tuning state)."""

    def __init__(self, index: IVFIndex, nprobe="auto", device="cuda"):
        self.index = index
        self.nprobe_setting = nprobe
        self.device = torch.device(device)
        self._tuned_nprobe: Optional[int] = None

    def with_index(self, index: IVFIndex) -> "IVFRouter":
        """A new router serving `index` with this router's settings and its
        tuned nprobe carried over (an append leaves the layout's geometry
        as it was)."""
        new = IVFRouter(index, nprobe=self.nprobe_setting,
                        device=self.device)
        new._tuned_nprobe = self._tuned_nprobe
        return new

    # ---------------------------------------------------------- nprobe

    def effective_nprobe(self, k: int) -> int:
        if self.nprobe_setting != "auto":
            n = max(1, min(int(self.nprobe_setting), self.index.nlist))
            if n != self.index.nlist and n & (n - 1):
                # snap an off-ladder setting UP: never fewer probes than
                # configured, recall only improves
                n = min(1 << (n - 1).bit_length(), self.index.nlist)
            return n
        if self._tuned_nprobe is None:
            self._tuned_nprobe = self.tune_nprobe(k=max(k, 10))
        return self._tuned_nprobe

    def tune_nprobe(self, k: int = 10) -> int:
        """Recall-gate auto-tune: double nprobe until recall@k on a
        held-out sample of the indexed vectors meets the target, against
        the engine's own full-probe result over the same partitions (so
        quantization loss, which no probing recovers, does not drive the
        tuner to exhaustive)."""
        idx = self.index
        valid_mask = idx.part_rows >= 0
        flat_vecs = idx.part_vecs[valid_mask]
        n = int(valid_mask.sum())
        if n == 0:
            return 1
        rng = np.random.default_rng(TUNE_SEED)
        sample = min(TUNE_SAMPLE, n)
        pick = rng.choice(n, size=sample, replace=False)
        queries = flat_vecs[pick]
        k_eff = min(k, n)

        _, truth, _ = self._device_search(queries, k_eff, idx.nlist)
        truth_rows = [set(t[t >= 0]) for t in truth]

        gate = min(1.0, RECALL_TARGET + TUNE_MARGIN)
        nprobe = 1
        while True:
            _, got_rows, _ = self._device_search(queries, k_eff, nprobe)
            hits = sum(len(truth_rows[i] & set(got_rows[i]))
                       for i in range(sample))
            recall = hits / max(sum(len(t) for t in truth_rows), 1)
            if recall >= gate or nprobe >= idx.nlist:
                return nprobe
            nprobe = min(idx.nlist, nprobe * 2)

    # ---------------------------------------------------------- search

    def should_fallback(self, k: int, has_filter: bool,
                        precision: str) -> Optional[str]:
        """Reason string when this search must take the exhaustive path."""
        idx = self.index
        if has_filter:
            return "filtered"
        if precision == "f32":
            return "f32_precision"
        if idx.needs_retrain:
            return "needs_retrain"
        if idx.total == 0:
            return "empty"
        if k > idx.cap:  # one probe can't even fill the result list
            return "k_exceeds_partition"
        return None

    def _device_search(self, queries: np.ndarray, k: int, nprobe: int):
        """(scores [Q,k], rows [Q,k], phases dict) — rows are device-corpus
        row ids, -1 for empty slots."""
        idx = self.index
        dev = self.device
        nprobe = max(1, min(nprobe, idx.nlist))
        t0 = time.perf_counter_ns()
        parts = idx.device_partitions(dev)
        q = knn_ivf._prep_queries(
            torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(dev),
            idx.metric)
        probe_ids, _ = knn_ivf.route(q, parts, nprobe, metric=idx.metric)
        _sync(dev)
        t1 = time.perf_counter_ns()
        k_dev = min(k, nprobe * idx.cap)
        use_fused = fused.fused_eligible(parts.parts.dtype, idx.metric)
        if use_fused:
            scores, rows = fused.fused_probe_scores(q, parts, probe_ids,
                                                    k_dev)
        else:
            scores, rows = knn_ivf.score_probes(q, parts, probe_ids, k_dev,
                                                metric=idx.metric)
        _sync(dev)
        t2 = time.perf_counter_ns()
        scores_np, rows_np = _pad_back_k(scores.cpu().numpy(),
                                         rows.cpu().numpy(), k, k_dev)
        t3 = time.perf_counter_ns()
        phases = {"engine": "tpu_ivf", "nprobe": nprobe,
                  "nlist": idx.nlist,
                  "scored_rows": nprobe * idx.cap,
                  "fused_probe": use_fused,
                  "route_nanos": t1 - t0, "score_nanos": t2 - t1,
                  "merge_nanos": t3 - t2}
        return scores_np, rows_np, phases

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None,
               num_candidates: Optional[int] = None):
        """Pruned top-k over the partition layout.

        num_candidates (the `_search` knn API knob) widens probing the way
        ef does for HNSW: enough partitions are probed that at least that
        many rows get scored, snapped to the next pow-2 rung (clamped to
        nlist). Returns (scores [Q, k], rows [Q, k], phases). Callers
        decide fallback beforehand via `should_fallback`."""
        if nprobe is None:
            nprobe = self.effective_nprobe(k)
        if num_candidates is not None and num_candidates > 0:
            want = -(-int(num_candidates) // max(self.index.cap, 1))
            if want > nprobe:
                nprobe = min(1 << (want - 1).bit_length(), self.index.nlist)
        return self._device_search(np.asarray(queries, dtype=np.float32), k,
                                   nprobe)
