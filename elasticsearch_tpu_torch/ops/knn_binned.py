"""Binned-reduction kNN on the hand-written Hopper kernels (port of
`elasticsearch_tpu/ops/pallas_knn_binned.py`).

The TPU-KNN recipe: instead of an exact top-k inside the scan, keep only the
max of every 64-row bin, then one small top-k over the [Q, n_bins]
candidates. Score and row travel together through the max: the score is
shifted positive (+4, so IEEE order is integer order), bitcast to int32, its
low 6 bits cleared and replaced by the bin-local chunk index, so the max of
the packed int32 is also its argmax.

Layout kept from the reference so `_decode` and the rescore compare id for
id: within an 8192-row tile, row `tile_base + t·128 + lane` goes to output
column `tile·128 + lane` with chunk index `t` (0..63).

Kernels (`csrc/knn_binned.cu`): `knn_binned_bf16` (bf16 operands, f32
accumulate; scores clamped to ±3 unless cosine) and `knn_binned_int8`
(s8×s8→s32 with the per-query and per-row dequant scales). Each wrapper
launches its kernel for a CUDA tensor, or raises; it runs the plain PyTorch
version (`binned_packed_reference`) only for tensors on the CPU. Both come
in two variants, picked by `launch_plan` from the shape: `tma` (TMA ring +
wgmma, rows whose byte width is a multiple of 16) and `wmma` (the rest).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from elasticsearch_tpu_torch.ops import _build
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.knn import Corpus, _prep_queries
from elasticsearch_tpu_torch.quant.codec import quantize_queries_int8

BLOCK_N = 8192
BIN_SIZE = 64
BINS_PER_TILE = BLOCK_N // BIN_SIZE   # 128
IDX_BITS = 6                          # log2(BIN_SIZE)
MASK = ~((1 << IDX_BITS) - 1)
# cosine scores live in [-1, 1]; dot products are clamped into this window
SHIFT = 4.0
CLAMP = 3.0

KERNEL_BF16 = "knn_binned_bf16"
KERNEL_INT8 = "knn_binned_int8"
_TILES_PER_STEP = 16   # plain version: tiles scored per matmul

# launch plan (mirrors the constants of csrc/knn_binned.cu)
VARIANT_TMA = "tma"
VARIANT_WMMA = "wmma"
CHUNKS = BLOCK_N // BINS_PER_TILE      # 64 chunks of 128 rows a tile
TMA_QN = (8, 16, 32, 64, 128)          # query-group widths (wgmma N)
WMMA_QB = 64                           # query rows a wmma block
STAGES = 4                             # corpus slabs in flight
SLAB_BYTES = 128
MAX_SMEM = 232448                      # 227 KB a block
# ~2 blocks per SM of the H100's 132: 256 blocks is 1.94 a SM
MIN_BLOCKS = 256


class LaunchPlan(NamedTuple):
    """How one binned launch is cut: `variant`, query rows a block (`qn`),
    query groups, chunk ranges a tile (`split`, a divisor of 64), whether
    the query group is staged once in shared memory, and the grid
    (groups, tiles, split)."""
    variant: str
    qn: int
    groups: int
    split: int
    staged: bool
    grid: Tuple[int, int, int]


def _tma_smem_bytes(qn: int, ks: int, staged: bool) -> int:
    """Shared memory of one tma block (csrc `tma_smem_bytes`): alignment
    slack, the corpus ring, the query slabs (all of them, or one a stage),
    the per-row weights a stage, the query scales and the barriers."""
    return (1024 + STAGES * BINS_PER_TILE * SLAB_BYTES
            + (ks if staged else STAGES) * qn * SLAB_BYTES
            + STAGES * BINS_PER_TILE * 4 + qn * 4 + (2 * STAGES + 1) * 8)


@functools.lru_cache(maxsize=1024)
def launch_plan(nq: int, n_pad: int, d: int, itemsize: int) -> LaunchPlan:
    """The launch of `nq` queries against an [n_pad, d] corpus of
    `itemsize`-byte elements. Rows whose byte width is not a multiple of 16
    take the wmma variant (TMA needs 16-byte strides). The rest take the
    tma one: query groups of at most 128 rows, then the smallest split of
    each tile's 64 chunks (and, past 64, narrower query groups) that gives
    at least MIN_BLOCKS blocks. With a split, the C entry point fills the
    output with INT32_MIN before the blocks combine into it. Memoized: a
    request pays the lookup, not the search."""
    tiles = n_pad // BLOCK_N
    if (d * itemsize) % 16:
        groups = -(-nq // WMMA_QB)
        return LaunchPlan(VARIANT_WMMA, WMMA_QB, groups, 1, False,
                          (groups, tiles, 1))
    groups = -(-nq // TMA_QN[-1])
    qn = next(n for n in TMA_QN if n * groups >= nq)
    split = 1
    while groups * tiles * split < MIN_BLOCKS and split < CHUNKS:
        split *= 2
    while groups * tiles * split < MIN_BLOCKS and qn > TMA_QN[0]:
        qn //= 2
        groups = -(-nq // qn)
    ks = -(-d * itemsize // SLAB_BYTES)
    staged = _tma_smem_bytes(qn, ks, True) <= MAX_SMEM
    return LaunchPlan(VARIANT_TMA, qn, groups, split, staged,
                      (groups, tiles, split))


# --------------------------------------------------------------- plain version

def _tile_patterns(n_pad: int, num_valid: int, device):
    """valid [1, N_pad] f32 in {0, 1}; tpat [1, BLOCK_N] i32 = column // 128
    (the chunk index each column carries in its low bits)."""
    valid = (torch.arange(n_pad, device=device) < num_valid
             ).to(torch.float32).reshape(1, n_pad)
    tpat = (torch.arange(BLOCK_N, device=device, dtype=torch.int32)
            // BINS_PER_TILE).reshape(1, BLOCK_N)
    return valid, tpat


def _pack_max(s: torch.Tensor, tpat: torch.Tensor) -> torch.Tensor:
    """Shifted scores [Q, T·8192] → packed bin maxima [Q, T·128]."""
    nq, n = s.shape
    tiles = n // BLOCK_N
    p = (s.contiguous().view(torch.int32) & MASK).reshape(nq, tiles, BLOCK_N) \
        | tpat
    return p.reshape(nq, tiles, BIN_SIZE, BINS_PER_TILE).amax(dim=2) \
        .reshape(nq, tiles * BINS_PER_TILE)


def binned_packed_reference(q: torch.Tensor, matrix: torch.Tensor,
                            row_weight: torch.Tensor, tpat: torch.Tensor,
                            clamp: bool = False,
                            qscale=None) -> torch.Tensor:
    """Plain PyTorch version of both kernels: packed int32 [Q, N_pad/64].

    bf16 (`qscale` None): q [Q, D] and matrix [N_pad, D] bf16, row_weight is
    validity [1, N_pad]. The products of bf16 operands are exact in f32,
    so the f32 matmul with TF32 off is "bf16 operands, f32 accumulate".

    int8: q [Q, D] and matrix int8, qscale [Q, 1], row_weight = per-row
    scale × validity [1, N_pad]. The int8 dot products are integers below
    2^53 and exact in f64; the dequant is written as the reference writes
    it, one elementwise op at a time, so nothing contracts into an FMA."""
    n_pad = matrix.shape[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    step = _TILES_PER_STEP * BLOCK_N
    out = []
    for lo in range(0, n_pad, step):
        hi = min(lo + step, n_pad)
        w = row_weight[:, lo:hi]
        if qscale is None:
            s = torch.matmul(q.to(torch.float32),
                             matrix[lo:hi].to(torch.float32).T)
            if clamp:
                s = torch.clamp(s, -CLAMP, CLAMP)
            s = (s + SHIFT) * w
        else:
            dots = torch.matmul(q.to(torch.float64),
                                matrix[lo:hi].to(torch.float64).T)
            s = dots.to(torch.float32) * qscale
            s = torch.clamp(s * w + SHIFT * torch.clamp(w * 1e30, max=1.0),
                            0.0, SHIFT + CLAMP)
        out.append(_pack_max(s, tpat))
    return torch.cat(out, dim=1)


# -------------------------------------------------------------- CUDA wrappers

def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_binned")
    if not getattr(lib, "_typed", False):
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        plan = [i] * 5
        lib.knn_binned_bf16.argtypes = [p, p, p, p, i, n, i, i, *plan, p]
        lib.knn_binned_bf16.restype = ctypes.c_int
        lib.knn_binned_int8.argtypes = [p, p, p, p, p, i, n, i, *plan, p]
        lib.knn_binned_int8.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cuda_error_string(code).decode()}")


def _check_inputs(q, matrix, dtype, per_query=(), per_row=()):
    """Raise on anything the kernel does not take: it reads every pointer
    at the sizes given here, so a short vector would be read past its end."""
    if q.device.type != "cuda" or any(
            t.device != q.device for t in (matrix, *per_query, *per_row)):
        raise ValueError("kernel inputs must lie on one CUDA device")
    if q.dtype != dtype or matrix.dtype != dtype:
        raise TypeError(f"kernel inputs must be {dtype}, got "
                        f"{q.dtype} and {matrix.dtype}")
    if q.dim() != 2 or matrix.dim() != 2 or q.shape[1] != matrix.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"corpus {tuple(matrix.shape)}")
    if matrix.shape[0] % BLOCK_N != 0:
        raise ValueError(f"corpus rows {matrix.shape[0]} not divisible "
                         f"by {BLOCK_N}")
    if q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError("empty query batch or zero dims")
    for t in (q, matrix):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and "
                             "16-byte aligned")
    for vecs, n in ((per_query, q.shape[0]), (per_row, matrix.shape[0])):
        for t in vecs:
            if t.numel() != n:
                raise ValueError(f"expected {n} per-query/per-row values, "
                                 f"got {t.numel()}")
    for t in per_row:   # bulk-copied in 512-byte runs
        if t.data_ptr() % 16:
            raise ValueError("per-row weights must be 16-byte aligned")


def _launch(q: torch.Tensor, matrix: torch.Tensor):
    """(plan, its C arguments, the output)."""
    nq, d = q.shape
    n_pad = matrix.shape[0]
    plan = launch_plan(nq, n_pad, d, q.element_size())
    out = torch.empty((nq, n_pad // BIN_SIZE), dtype=torch.int32,
                      device=q.device)
    args = (int(plan.variant == VARIANT_TMA), plan.qn, plan.groups,
            plan.split, int(plan.staged))
    return plan, args, out


def binned_packed_bf16(q: torch.Tensor, matrix: torch.Tensor,
                       valid: torch.Tensor, clamp: bool) -> torch.Tensor:
    """Packed bin maxima of bf16 q [Q, D] against a bf16 corpus [N_pad, D]
    with validity [1, N_pad]: the `knn_binned_bf16` kernel on CUDA, the
    plain version on the CPU."""
    if q.device.type == "cpu" and matrix.device.type == "cpu":
        _, tpat = _tile_patterns(matrix.shape[0], 0, q.device)
        return binned_packed_reference(q, matrix, valid, tpat, clamp=clamp)
    valid = valid.to(torch.float32).contiguous()
    _check_inputs(q, matrix, torch.bfloat16, per_row=(valid,))
    nq, d = q.shape
    plan, args, out = _launch(q, matrix)
    lib = _lib()
    code = lib.knn_binned_bf16(
        q.data_ptr(), matrix.data_ptr(), valid.data_ptr(), out.data_ptr(),
        nq, matrix.shape[0], d, int(clamp), *args,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(lib, code, KERNEL_BF16)
    dispatch.count_launch(KERNEL_BF16, plan.variant,
                          f"q{nq}.n{matrix.shape[0]}.d{d}")
    return out


def binned_packed_int8(q8: torch.Tensor, matrix: torch.Tensor,
                       qscale: torch.Tensor,
                       row_scale_valid: torch.Tensor) -> torch.Tensor:
    """Packed bin maxima of int8 q8 [Q, D] (scales qscale [Q, 1]) against an
    int8 corpus [N_pad, D] (row scale × validity [1, N_pad]): the
    `knn_binned_int8` kernel on CUDA, the plain version on the CPU."""
    if q8.device.type == "cpu" and matrix.device.type == "cpu":
        _, tpat = _tile_patterns(matrix.shape[0], 0, q8.device)
        return binned_packed_reference(q8, matrix, row_scale_valid, tpat,
                                       qscale=qscale)
    qscale = qscale.to(torch.float32).contiguous()
    row_scale_valid = row_scale_valid.to(torch.float32).contiguous()
    _check_inputs(q8, matrix, torch.int8, per_query=(qscale,),
                  per_row=(row_scale_valid,))
    nq, d = q8.shape
    plan, args, out = _launch(q8, matrix)
    lib = _lib()
    code = lib.knn_binned_int8(
        q8.data_ptr(), matrix.data_ptr(), qscale.data_ptr(),
        row_scale_valid.data_ptr(), out.data_ptr(), nq, matrix.shape[0], d,
        *args, torch.cuda.current_stream(q8.device).cuda_stream)
    _check(lib, code, KERNEL_INT8)
    dispatch.count_launch(KERNEL_INT8, plan.variant,
                          f"q{nq}.n{matrix.shape[0]}.d{d}")
    return out


# ------------------------------------------------------------ search entries

def corpus_row_weight(corpus: Corpus) -> torch.Tensor:
    """The kernel's per-row weight [1, N_pad] f32, made at the corpus's
    first binned search and kept on it: validity, times the row scale for
    int8."""
    if corpus.row_weight is None:
        n_pad = corpus.matrix.shape[0]
        valid, _ = _tile_patterns(n_pad, corpus.num_valid, corpus.device)
        if corpus.matrix.dtype == torch.int8:
            valid = corpus.scales.reshape(1, n_pad) * valid
        corpus.row_weight = valid.contiguous()
    return corpus.row_weight


def _binned_packed(queries: torch.Tensor, corpus: Corpus, metric: str):
    """(packed [Q, N_pad/64] int32, prepped f32 queries [Q, D])."""
    n_pad = corpus.matrix.shape[0]
    if n_pad % BLOCK_N != 0:
        raise ValueError(f"corpus rows {n_pad} not divisible by {BLOCK_N}")
    q = _prep_queries(queries.to(corpus.device), metric)
    if corpus.matrix.dtype == torch.int8:
        # symmetric per-query quantization; dequant inside the kernel
        q8, qscale = quantize_queries_int8(q)
        return binned_packed_int8(q8, corpus.matrix, qscale,
                                  corpus_row_weight(corpus)), q
    return binned_packed_bf16(q.to(torch.bfloat16),
                              corpus.matrix.to(torch.bfloat16),
                              corpus_row_weight(corpus),
                              clamp=metric != sim.COSINE), q


def _decode_columns(packed: torch.Tensor):
    """(decoded scores, global row of each column's winner) [Q, ncols]."""
    ncols = packed.shape[1]
    cols = torch.arange(ncols, device=packed.device)[None, :]
    tile_base = (cols // BINS_PER_TILE) * BLOCK_N
    t = (packed & ((1 << IDX_BITS) - 1)).to(torch.int64)
    cand_s = (packed & MASK).view(torch.float32) - SHIFT
    return cand_s, tile_base + t * BINS_PER_TILE + cols % BINS_PER_TILE


def _decode(packed: torch.Tensor, k: int):
    """Packed [Q, n_tiles·128] int32 → (scores [Q, k], global ids [Q, k])."""
    cand_s, cand_i = _decode_columns(packed)
    vals, pos = topk_ops.top_k(cand_s, k)
    return vals, torch.gather(cand_i, 1, pos)


def binned_knn_search(queries: torch.Tensor, corpus: Corpus, k: int,
                      metric: str = sim.COSINE):
    """Approximate top-k (recall ≈ 1 - C(k,2)·64/N) for dot-like metrics.
    Returns (raw_scores [Q, k], ids [Q, k])."""
    packed, _ = _binned_packed(queries, corpus, metric)
    return _decode(packed, k)


def _bf16x2(x: torch.Tensor):
    """Split f32 into (hi, lo) bf16 parts with hi + lo ≈ x to ~2^-16."""
    xf = x.to(torch.float32)
    hi = xf.to(torch.bfloat16)
    lo = (xf - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _rescore_scores(q: torch.Tensor, corpus: Corpus, rows: torch.Tensor):
    """Near-exact scores [Q, C] of the candidate rows [Q, C]: the query
    bf16x2-split, candidates in bf16 (int8 levels are exact there), row
    scales applied in f32, plus the residual level when present."""
    q_hi, q_lo = _bf16x2(q)

    def dot(c):
        # bf16 x bf16 products are exact in f32: widen, then f32 bmm
        c = c.to(torch.float32)
        return (torch.bmm(c, q_hi.to(torch.float32)[:, :, None])
                + torch.bmm(c, q_lo.to(torch.float32)[:, :, None]))[..., 0]

    if corpus.matrix.dtype == torch.int8:
        s = dot(corpus.matrix[rows].to(torch.bfloat16)) * corpus.scales[rows]
        if corpus.residual is not None:
            s = s + dot(corpus.residual[rows].to(torch.bfloat16)) \
                * corpus.residual_scales[rows]
        return s
    cand = corpus.matrix[rows]
    if cand.dtype == torch.bfloat16:
        return dot(cand)
    c_hi, c_lo = _bf16x2(cand)
    return dot(c_hi) + dot(c_lo)


def _rescored_packed_impl(queries, corpus: Corpus, k: int, metric: str,
                          rescore_candidates: int):
    packed, q = _binned_packed(queries, corpus, metric)
    cand_s, cand_rows = _decode_columns(packed)
    c = min(rescore_candidates, packed.shape[1])
    _, pos = topk_ops.top_k(cand_s, c)                       # [Q, C] cols
    rows = torch.gather(cand_rows, 1, pos)                   # [Q, C] rows
    # the query stays UNQUANTIZED here: removing the kernel's query-side
    # quantization error is where the recall headroom comes from
    scores = _rescore_scores(q, corpus, rows)
    scores = torch.where(rows < corpus.num_valid, scores,
                         torch.full_like(scores, float("-inf")))
    vals, p2 = topk_ops.top_k(scores, k)
    return vals, torch.gather(rows, 1, p2)


def binned_knn_search_rescored_packed(queries: torch.Tensor, corpus: Corpus,
                                      k: int, metric: str = sim.COSINE,
                                      rescore_candidates: int = 128):
    """Binned pass + re-scoring of the top `rescore_candidates` packed
    winners with the unquantized query (bf16x2 dots)."""
    return _rescored_packed_impl(queries, corpus, k, metric,
                                 rescore_candidates)
