"""Exact kNN as matmul + top-k, and the route to the binned kernel (port of
`elasticsearch_tpu/ops/knn.py`).

    scores = queries @ corpus^T          (bf16 operands, f32 accumulate)
    top-k  = top_k(scores + masks)       (ties to the lower row)

Two execution shapes, as in the reference: single-shot, and a blocked loop
over corpus tiles with a running top-k merge that keeps peak memory at
[Q, block_size] scores. `knn_search_auto` sends unfiltered dot-like
searches over tile-padded corpora to the hand-written binned kernel
(`ops/knn_binned.py`); everything else takes the exact path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.quantization import quantize_int8_np
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec

LANE = 128          # corpus rows pad to a multiple of this ...
BINNED_TILE = 8192  # ... or of the binned kernel's tile on CUDA


@dataclass
class Corpus:
    """Device-resident searchable vector block.

    matrix:    [N_pad, D] f32 / bf16 / int8 storage, or [N_pad, D/2]
               uint8 packed int4 nibbles
    sq_norms:  [N_pad] f32 — ||row||^2 (post-normalization for cosine)
    scales:    [N_pad] f32 — int8/int4 per-row scales (all-ones when
               unquantized)
    num_valid: rows beyond this are padding and never match
    residual / residual_scales: optional second int8 level
      (row ≈ matrix*scales + residual*residual_scales); only the rescore
      of `binned_knn_search_rescored_packed` reads it.
    row_weight: the binned kernel's per-row weight [1, N_pad] f32,
      computed from the fields above at this corpus's first binned search
      (`knn_binned.corpus_row_weight`) and kept; a corpus is never edited in place.
    """

    matrix: torch.Tensor
    sq_norms: torch.Tensor
    scales: torch.Tensor
    num_valid: int
    residual: Optional[torch.Tensor] = None
    residual_scales: Optional[torch.Tensor] = None
    row_weight: Optional[torch.Tensor] = field(default=None, init=False,
                                               repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.matrix.device


def pad_rows(n: int, multiple: int = LANE) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def preferred_pad_multiple(n: int, metric: str, device) -> int:
    """Pad large dot-metric corpora to the binned kernel's tile on CUDA so
    the kernel route stays eligible. On the CPU keep the reference's lane
    padding (the reference pads to the tile only on a TPU), so that CPU
    parity tests compare the same route."""
    if n < BINNED_TILE or metric == sim.L2_NORM:
        return LANE
    return BINNED_TILE if torch.device(device).type == "cuda" else LANE


def build_corpus(vectors: np.ndarray, metric: str = sim.COSINE,
                 dtype: str = "bf16", pad_to: Optional[int] = None,
                 residual: bool = True, device="cuda") -> Corpus:
    """Build the device corpus from raw host vectors, byte-identical to the
    reference's `build_corpus` for the f32, bf16, int8 and int4 encodings.

    Cosine rows are L2-normalized here, once. int8 and int4 quantization run
    on the host in numpy, chunked; `residual` keeps the second int8 level.
    The packed int4 rung never rides the binned kernel, so it keeps the
    lane padding."""
    if dtype not in ("f32", "bf16", "int8", "int4"):
        raise ValueError(f"unsupported corpus dtype [{dtype}]")
    device = torch.device(device)
    vectors = np.asarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    pad_mult = (LANE if dtype in quant_codec.PACKED_ENCODINGS
                else preferred_pad_multiple(n, metric, device))
    n_pad = pad_to if pad_to is not None else pad_rows(max(n, 1), pad_mult)
    if n_pad < n:
        raise ValueError(f"pad_to {n_pad} < corpus size {n}")

    if metric == sim.COSINE:
        norms = np.linalg.norm(vectors, axis=-1, keepdims=True)
        vectors = vectors / np.maximum(norms, 1e-30)

    padded = np.zeros((n_pad, d), dtype=np.float32)
    padded[:n] = vectors
    sq_norms = torch.from_numpy(np.einsum("nd,nd->n", padded, padded)
                                .astype(np.float32)).to(device)

    res = res_scales = None
    if dtype in quant_codec.PACKED_ENCODINGS:
        enc = quant_codec.get(dtype).encode_np(padded)
        matrix = torch.from_numpy(enc.data).to(device)
        scales = torch.from_numpy(enc.scales).to(device)
    elif dtype == "int8":
        q8, scales_np = quantize_int8_np(padded)
        matrix = torch.from_numpy(q8).to(device)
        scales = torch.from_numpy(scales_np).to(device)
        if residual:
            # second level, chunked so the f32 residual temp stays bounded
            r8 = np.empty_like(q8)
            rscales_np = np.empty((n_pad,), dtype=np.float32)
            chunk = max(1, (64 << 20) // max(d * 4, 1))
            for lo in range(0, n_pad, chunk):
                hi = lo + chunk
                res_f = (padded[lo:hi]
                         - q8[lo:hi].astype(np.float32)
                         * scales_np[lo:hi, None])
                r8[lo:hi], rscales_np[lo:hi] = quantize_int8_np(res_f)
            res = torch.from_numpy(r8).to(device)
            res_scales = torch.from_numpy(rscales_np).to(device)
    else:
        matrix = torch.from_numpy(padded).to(device)
        if dtype == "bf16":
            matrix = matrix.to(torch.bfloat16)
        scales = torch.ones((n_pad,), dtype=torch.float32, device=device)

    return Corpus(matrix=matrix, sq_norms=sq_norms, scales=scales,
                  num_valid=int(n), residual=res, residual_scales=res_scales)


def corpus_from_numpy(arrays: dict, device="cuda") -> Corpus:
    """The port's `Corpus` from a reference corpus given as numpy arrays
    (`matrix`, `sq_norms`, `scales`, `num_valid`, optional `residual`,
    `residual_scales`), from the same bytes: a bf16 matrix arrives as its
    uint16 bit pattern (or any 2-byte view of it), int8 as is."""
    device = torch.device(device)

    def tensor(a):
        # a copy: arrays viewed from another framework are often read-only
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)

    mat = np.asarray(arrays["matrix"])
    if mat.dtype.itemsize == 2 and mat.dtype != np.float16:
        matrix = tensor(mat.view(np.int16)).view(torch.bfloat16)
    elif mat.dtype in (np.float32, np.int8, np.uint8):
        matrix = tensor(mat)
    else:
        raise ValueError(f"unsupported corpus matrix dtype [{mat.dtype}]")
    res = arrays.get("residual")
    res_s = arrays.get("residual_scales")
    return Corpus(
        matrix=matrix,
        sq_norms=tensor(np.asarray(arrays["sq_norms"], dtype=np.float32)),
        scales=tensor(np.asarray(arrays["scales"], dtype=np.float32)),
        num_valid=int(arrays["num_valid"]),
        residual=None if res is None else tensor(np.asarray(res)),
        residual_scales=(None if res_s is None
                         else tensor(np.asarray(res_s, dtype=np.float32))))


def corpus_from_encoded(data: np.ndarray, scales: np.ndarray,
                        vectors: np.ndarray, metric: str = sim.COSINE,
                        dtype: str = "int4", pad_to: Optional[int] = None,
                        device="cuda") -> Corpus:
    """Build a packed-encoding corpus from ALREADY-ENCODED rows. `vectors`
    is the raw f32 matrix (for sq-norms); padding rows take the codec's
    encode-of-zeros, so the matrix and scales are byte-identical to
    `build_corpus(vectors, dtype=dtype)`. Cosine rows are normalized
    before encoding, so their sq-norm is exactly 1 for any non-zero row."""
    device = torch.device(device)
    codec = quant_codec.get(dtype)
    vectors = np.asarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    n_pad = pad_to if pad_to is not None else pad_rows(max(n, 1), LANE)
    if n_pad < n:
        raise ValueError(f"pad_to {n_pad} < corpus size {n}")
    sq_np = np.zeros((n_pad,), dtype=np.float32)
    chunk = max(1, (64 << 20) // max(d * 4, 1))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block_sq = np.einsum("nd,nd->n", vectors[lo:hi], vectors[lo:hi])
        if metric == sim.COSINE:
            sq_np[lo:hi] = (block_sq > 0).astype(np.float32)
        else:
            sq_np[lo:hi] = block_sq
    w = codec.packed_width(d)
    pad_enc = codec.encode_np(np.zeros((1, d), dtype=np.float32))
    full_data = np.empty((n_pad, w), dtype=codec.packed_np_dtype)
    full_scales = np.empty((n_pad,), dtype=np.float32)
    full_data[:n] = np.asarray(data).reshape(n, w)
    full_scales[:n] = scales
    full_data[n:] = pad_enc.data[0]
    full_scales[n:] = pad_enc.scales[0]
    return Corpus(matrix=torch.from_numpy(full_data).to(device),
                  sq_norms=torch.from_numpy(sq_np).to(device),
                  scales=torch.from_numpy(full_scales).to(device),
                  num_valid=int(n))


def _block_scores(queries, matrix, sq_norms, scales, metric: str,
                  precision: str):
    """Raw similarity for one corpus block, int8 and int4 de-scaled after
    the matmul. Queries arrive metric-prepped (cosine queries are unit)."""
    if matrix.dtype == torch.int8:
        # int8 values are exact in bf16: the matmul sees the stored levels
        mat = matrix.to(torch.float32 if precision == "f32" else torch.bfloat16)
        dots = sim._matmul(queries, mat, precision) * scales[None, :]
        if metric == sim.L2_NORM:
            return sim.l2_raw_from_dots(dots, queries, sq_norms)
        return dots
    if matrix.dtype == torch.uint8:
        # int4 packed nibbles: two half-width matmuls on the (even, odd)
        # level planes, de-scaled after
        mm = torch.float32 if precision == "f32" else torch.bfloat16
        lo, hi = quant_codec.int4_planes(matrix, mm)
        q_even, q_odd = quant_codec.split_query_planes(queries)
        dots = (sim._matmul(q_even, lo, precision)
                + sim._matmul(q_odd, hi, precision)) * scales[None, :]
        if metric == sim.L2_NORM:
            return sim.l2_raw_from_dots(dots, queries, sq_norms)
        return dots
    return sim.similarity_scores(queries, matrix, sq_norms, metric=metric,
                                 precision=precision, normalize_queries=False)


def _prep_queries(queries, metric: str):
    queries = queries.to(torch.float32)
    if metric == sim.COSINE:
        queries = sim.normalize(queries)
    return queries


def knn_search_auto(queries: torch.Tensor, corpus: Corpus, k: int,
                    metric: str = sim.COSINE,
                    filter_mask: Optional[torch.Tensor] = None,
                    precision: str = "bf16",
                    rescore_candidates: int = 128):
    """Route to the binned kernel or the exact path, as the reference's
    `knn_search_auto` does: a dot-like metric, no filter, a tile-padded
    corpus, k <= 64 and bf16 precision take the binned kernel (with the
    rescore of its top candidates when the corpus carries the residual
    level); everything else is exact. A kernel that fails raises: there is
    no fallback from the binned route. The packed int4 rung always takes
    the exact path, as in the reference."""
    from elasticsearch_tpu_torch.ops import knn_binned as binned

    n_pad = corpus.matrix.shape[0]
    if (filter_mask is None
            and metric in (sim.COSINE, sim.DOT_PRODUCT, sim.MAX_INNER_PRODUCT)
            and corpus.matrix.dtype != torch.uint8
            and n_pad % binned.BLOCK_N == 0
            and k <= 64
            and precision == "bf16"):
        if corpus.residual is not None:
            return binned.binned_knn_search_rescored_packed(
                queries, corpus, k, metric=metric,
                rescore_candidates=rescore_candidates)
        return binned.binned_knn_search(queries, corpus, k, metric=metric)
    return knn_search(queries, corpus, k, metric=metric,
                      filter_mask=filter_mask, precision=precision)


def knn_search(queries: torch.Tensor, corpus: Corpus, k: int,
               metric: str = sim.COSINE,
               filter_mask: Optional[torch.Tensor] = None,
               precision: str = "bf16",
               block_size: Optional[int] = None):
    """Exact top-k of `queries` [Q, D] against `corpus`.

    filter_mask: optional [N_pad] or [Q, N_pad] bool — True = searchable.
    Returns (scores [Q, k] raw similarity, ids [Q, k] int64 rows). Padded
    and filtered-out rows score NEG_INF."""
    n_pad = corpus.matrix.shape[0]
    dev = corpus.device
    q = _prep_queries(queries.to(dev), metric)
    valid = torch.arange(n_pad, device=dev) < corpus.num_valid
    if filter_mask is not None:
        valid = valid & filter_mask.to(dev)  # broadcasts [N] or [Q, N]

    if block_size is None or block_size >= n_pad:
        scores = _block_scores(q, corpus.matrix, corpus.sq_norms,
                               corpus.scales, metric, precision)
        return topk_ops.masked_top_k(scores, valid, k)

    if n_pad % block_size != 0:
        raise ValueError(f"n_pad {n_pad} not divisible by block_size {block_size}")
    nq = q.shape[0]
    best_s = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
    for lo in range(0, n_pad, block_size):
        hi = lo + block_size
        s = _block_scores(q, corpus.matrix[lo:hi], corpus.sq_norms[lo:hi],
                          corpus.scales[lo:hi], metric, precision)
        block_valid = valid[..., lo:hi]
        s = torch.where(block_valid, s, torch.full_like(s, NEG_INF))
        ids = torch.arange(lo, hi, device=dev).expand(nq, block_size)
        vals, pos = topk_ops.top_k(torch.cat([best_s, s], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos)
        best_s = vals
    return best_s, best_i
