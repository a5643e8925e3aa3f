"""Centroid-pruned IVF search: route → pruned scoring → top-k (port of
`elasticsearch_tpu/ops/knn_ivf.py`).

The device half of the `tpu_ivf` engine (`elasticsearch_tpu_torch/ann/`).
Where `ops/knn.py` scores all N rows per query, this scores only the
`nprobe` partitions a small centroid matmul routes each query to:

    route:  c[Q, nlist] = q @ centroids^T
    probe:  top-nprobe partition ids per query (ties to the lower id)
    score:  for each probe slot, a gather of [Q, cap, D] partition tiles
            + one batched product → [Q, cap] scores
    merge:  running top-k across probe slots

This is the scan route: it stages each slot's [Q, cap, D] gather in
device memory. The dot-like metrics at bf16 precision take the fused
kernel instead (`ops/ivf_fused.py`), which never stages a tile; l2 and
`precision="f32"` stay here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec


class IVFPartitions(NamedTuple):
    """Device-resident partitioned corpus.

    centroids:    [nlist, D] f32 routing centroids (unit vectors when the
                  corpus is cosine-normalized)
    centroid_sq:  [nlist] f32 ||c||² (l2 routing)
    parts:        [nlist, cap, D] f32 / bf16 / int8 partition tiles, or
                  [nlist, cap, D/2] uint8 packed int4 nibbles
    part_scales:  [nlist, cap] f32 int8/int4 per-row scales (validity 1/0
                  otherwise); 0 on every padding slot
    part_sq:      [nlist, cap] f32 ||row||² (l2 scoring)
    part_rows:    [nlist, cap] int32 device-corpus row ids; -1 = padding
    """

    centroids: torch.Tensor
    centroid_sq: torch.Tensor
    parts: torch.Tensor
    part_scales: torch.Tensor
    part_sq: torch.Tensor
    part_rows: torch.Tensor


def ivf_partitions_from_numpy(arrays, device="cuda") -> IVFPartitions:
    """The port's `IVFPartitions` from the reference's, given as numpy
    arrays (a dict or a NamedTuple of them), from the same bytes: a bf16
    `parts` arrives as its uint16 bit pattern (or any 2-byte view)."""
    device = torch.device(device)
    if not isinstance(arrays, dict):
        arrays = arrays._asdict()

    def tensor(a, dtype=None):
        a = np.array(a, dtype=dtype, copy=True, order="C")
        return torch.from_numpy(a).to(device)

    parts = np.asarray(arrays["parts"])
    if parts.dtype.itemsize == 2 and parts.dtype != np.float16:
        parts_t = tensor(parts.view(np.int16)).view(torch.bfloat16)
    elif parts.dtype in (np.float32, np.int8, np.uint8):
        parts_t = tensor(parts)
    else:
        raise ValueError(f"unsupported partition dtype [{parts.dtype}]")
    return IVFPartitions(
        centroids=tensor(arrays["centroids"], np.float32),
        centroid_sq=tensor(arrays["centroid_sq"], np.float32),
        parts=parts_t,
        part_scales=tensor(arrays["part_scales"], np.float32),
        part_sq=tensor(arrays["part_sq"], np.float32),
        part_rows=tensor(arrays["part_rows"], np.int32))


def _prep_queries(queries: torch.Tensor, metric: str) -> torch.Tensor:
    queries = queries.to(torch.float32)
    if metric == sim.COSINE:
        queries = sim.normalize(queries)
    return queries


def check_nprobe(nprobe: int, nlist: int) -> None:
    """nprobe sits on the pow-2 ladder or equals nlist (the reference's
    closed-grid predicate `_grid_ivf`): the router snaps per-request
    widening to those rungs, and this catches a caller that forgets."""
    nprobe, nlist = int(nprobe), int(nlist)
    if not (nprobe == nlist or (nprobe >= 1 and nprobe & (nprobe - 1) == 0)):
        raise ValueError(f"nprobe [{nprobe}] must be a power of two or "
                         f"equal to nlist [{nlist}]")


def route(queries: torch.Tensor, ivf: IVFPartitions, nprobe: int,
          metric: str = sim.COSINE):
    """Centroid routing: [Q, D] metric-prepped queries → ([Q, nprobe] int32
    partition ids, [Q, nprobe] centroid scores). f32 operands, TF32 off."""
    check_nprobe(nprobe, ivf.centroids.shape[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.to(torch.float32)
    dots = q @ ivf.centroids.to(torch.float32).T
    if metric == sim.L2_NORM:
        scores = sim.l2_raw_from_dots(dots, q, ivf.centroid_sq)
    else:
        scores = dots
    vals, ids = topk_ops.top_k(scores, nprobe)
    return ids.to(torch.int32), vals


def score_probes(queries: torch.Tensor, ivf: IVFPartitions,
                 probe_ids: torch.Tensor, k: int, metric: str = sim.COSINE,
                 precision: str = "bf16"):
    """Score the probed partitions and merge a global top-k (the scan
    route: one staged [Q, cap, D] gather per probe slot).

    queries:   [Q, D] metric-prepped
    probe_ids: [Q, nprobe] int32 partition ids from `route`
    Returns (scores [Q, k] raw similarity, rows [Q, k] int32 device-corpus
    row ids). Empty slots come back as NEG_INF / row -1."""
    check_nprobe(probe_ids.shape[1], ivf.centroids.shape[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    q = queries.to(f32)
    nq = q.shape[0]
    dev = q.device
    mm = f32 if precision == "f32" else torch.bfloat16
    best_s = torch.full((nq, k), NEG_INF, dtype=f32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    q_mm = q.to(mm).to(f32)
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    for pid in probe_ids.to(torch.int64).T:             # [Q] per slot
        block = ivf.parts[pid]                           # [Q, cap, W]
        rows = ivf.part_rows[pid]                        # [Q, cap]
        if ivf.parts.dtype == torch.uint8:
            dots = quant_codec.int4_blocked_dots(q, block, mm)
            dots = dots * ivf.part_scales[pid]
        else:
            dots = torch.einsum("qd,qcd->qc", q_mm, block.to(mm).to(f32))
            if ivf.parts.dtype == torch.int8:
                dots = dots * ivf.part_scales[pid]
        if metric == sim.L2_NORM:
            s = 2.0 * dots - q_sq - ivf.part_sq[pid]
        else:
            s = dots
        s = torch.where(rows >= 0, s, torch.full_like(s, NEG_INF))
        vals, pos = topk_ops.top_k(torch.cat([best_s, s], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, rows], dim=1), 1, pos)
        best_s = vals
    return best_s, best_i


def ivf_search(queries: torch.Tensor, ivf: IVFPartitions, k: int,
               nprobe: int, metric: str = sim.COSINE,
               precision: str = "bf16"):
    """Route + scan-score convenience entry (the serving router calls the
    stages itself to time them and to pick the fused route)."""
    nprobe = min(nprobe, ivf.centroids.shape[0])
    q = _prep_queries(queries.to(ivf.centroids.device), metric)
    probe_ids, _ = route(q, ivf, nprobe, metric=metric)
    return score_probes(q, ivf, probe_ids, k, metric=metric,
                        precision=precision)
