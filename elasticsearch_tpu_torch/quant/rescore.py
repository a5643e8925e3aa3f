"""Two-phase serving: coarse packed top-k, exact rescore of the window
(port of `elasticsearch_tpu/quant/rescore.py`, host numpy, unchanged).

A packed encoding (int4) answers the coarse question — WHICH
~k·oversample rows are worth an exact look — and the exact f32 rows,
gathered from the host rows the field was built from, answer the final
ordering. The scores it produces are exact raw similarities in the
`ops/similarity` conventions, so `to_es_score` and every downstream
consumer are encoding-blind.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.ops import similarity as sim

# default coarse-window oversampling per packed rung (the reference's
# table; the binary rung is not ported)
DEFAULT_OVERSAMPLE = {"int4": 4, "binary": 16}

# score floor below which a coarse slot is padding, matching the device
# kernels' NEG_INF sentinel
_FLOOR = -1e37


def exact_scores(queries: np.ndarray, rows: np.ndarray,
                 metric: str) -> np.ndarray:
    """Raw similarity of `queries` [B, D] vs `rows` [B, C, D] (or
    [C, D] broadcast), f32, same conventions as the device kernels:
    cosine normalizes both sides, l2 returns 2q·v - |q|² - |v|²."""
    queries = np.asarray(queries, dtype=np.float32)
    rows = np.asarray(rows, dtype=np.float32)
    if metric == sim.COSINE:
        qn = np.linalg.norm(queries, axis=-1, keepdims=True)
        queries = queries / np.maximum(qn, 1e-30)
        rn = np.linalg.norm(rows, axis=-1, keepdims=True)
        rows = rows / np.maximum(rn, 1e-30)
        return np.einsum("bd,bcd->bc", queries, rows, dtype=np.float32)
    dots = np.einsum("bd,bcd->bc", queries, rows, dtype=np.float32)
    if metric == sim.L2_NORM:
        q_sq = (queries * queries).sum(axis=-1, keepdims=True)
        r_sq = (rows * rows).sum(axis=-1)
        return 2.0 * dots - q_sq - r_sq
    return dots


def rescore_boards(
    queries: np.ndarray,
    coarse_scores: np.ndarray,
    coarse_ids: np.ndarray,
    k: int,
    gather: Callable[[np.ndarray], np.ndarray],
    metric: str,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Exactly re-rank coarse boards and keep the top k.

    queries:       [B, D] f32 (UNPADDED real queries)
    coarse_scores: [B, W] coarse raw scores (-inf/NEG_INF padding)
    coarse_ids:    [B, W] int row ids in the gather space (-1 padding)
    gather:        ascending-unique row ids -> f32 rows [m, D]
    Returns (scores [B, k] f32, ids [B, k], stats): exact raw scores,
    -inf/-1 padded; stats = {"window", "promoted"} where `promoted`
    counts final-top-k slots whose coarse rank was >= k.
    """
    b, w = coarse_ids.shape
    out_s = np.full((b, k), -np.inf, dtype=np.float32)
    out_i = np.full((b, k), -1, dtype=np.int64)
    valid = (coarse_ids >= 0) & (coarse_scores > _FLOOR)
    flat = coarse_ids[valid]
    stats = {"window": int(w), "promoted": 0}
    if flat.size == 0:
        return out_s, out_i, stats
    uniq, inv = np.unique(flat.astype(np.int64), return_inverse=True)
    vecs = np.asarray(gather(uniq), dtype=np.float32)   # [m, D]
    promoted = 0
    pos = 0
    for qi in range(b):
        vq = valid[qi]
        n_c = int(vq.sum())
        if n_c == 0:
            continue
        cand_ids = coarse_ids[qi, vq].astype(np.int64)
        cand_vecs = vecs[inv[pos:pos + n_c]]
        pos += n_c
        raw = exact_scores(queries[qi:qi + 1], cand_vecs[None], metric)[0]
        kk = min(k, n_c)
        # argsort over (-score, candidate order): the coarse board is
        # score-descending, so equal exact scores tie-break by coarse rank
        order = np.argsort(-raw, kind="stable")[:kk]
        out_s[qi, :kk] = raw[order]
        out_i[qi, :kk] = cand_ids[order]
        promoted += int((order >= k).sum())
    stats["promoted"] = promoted
    return out_s, out_i, stats


def coarse_window(k: int, oversample: int, limit: Optional[int] = None
                  ) -> int:
    """Coarse-phase k for a final k at `oversample`, clamped to the
    corpus. Callers round the result up the k-ladder."""
    w = max(int(k) * max(int(oversample), 1), int(k))
    if limit is not None:
        w = min(w, int(limit))
    return max(w, 1)
