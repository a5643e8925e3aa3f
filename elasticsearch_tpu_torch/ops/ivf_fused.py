"""Fused gather + score of IVF probes on the hand-written Hopper kernels
(port of `elasticsearch_tpu/ops/pallas_ivf_fused.py`).

The scan route (`ops/knn_ivf.score_probes`) stages every probe slot's
[Q, cap, D] partition-tile gather in device memory before scoring it. The
kernels here read each (query, probe) tile straight out of the resident
`parts` array by its probe id, so no staged copy exists: the
[Q, nprobe, cap] f32 score board is the only new array. Then the row-id
join (`part_rows`, an int32 gather ~D× smaller than the tiles), the mask
of padding slots and one top-k finish the search.

Kernels (`csrc/ivf_fused.cu`): `ivf_fused_dense` (f32, bf16 and int8
tiles, bf16 operands, f32 accumulate, × per-row scale) and
`ivf_fused_int4` (packed nibbles: widened to bf16 levels against the
query itself, or, on its simt variant, scored against the even/odd query
planes). Slots
whose scale is ≤ 0 (every padding slot) score NEG_INF. Each wrapper
launches its kernel for CUDA tensors, or raises; it runs the plain PyTorch
version (`probe_board_reference`) only for tensors on the CPU, so the CPU
tests follow the card's route. Eligibility alone decides the route: the
dot-like metrics at bf16 precision on any of the four tile types.

Both kernels come in two variants, picked by `launch_plan` from the
shape: `grouped` (bf16, int8 and int4 tiles whose row bytes are a
multiple of 16: each probed tile is read once for every (query, probe)
entry that names it, grouped by a probe plan built on the card, and
scored with tensor-core mma) and `simt` (f32 tiles and ragged rows: one
block per (row chunk, probe, query)). `probe_plan_reference` is the plain
version of the probe plan, `int4_k_order` the grouped int4 kernel's
fragment layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from elasticsearch_tpu_torch.ops import _build
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import mma_frag
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions, check_nprobe
from elasticsearch_tpu_torch.ops.mma_frag import STEP_BYTES
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec

KERNEL_DENSE = "ivf_fused_dense"
KERNEL_INT4 = "ivf_fused_int4"

# tile dtype -> the dense kernel's dtype code
_DENSE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# launch plan of both kernels (mirrors the constants of csrc/ivf_fused.cu)
VARIANT_GROUPED = "grouped"
VARIANT_SIMT = "simt"
N_MAX = 32                   # entries (query columns) a work item
CHUNK_ROWS = 128             # grouped: tile rows a chunk (8 warps x 16)
SIMT_ROWS = 64               # simt: tile rows a block
PLAN_MAX_NLIST = 32768       # the plan kernel's histogram in shared memory
MAX_SMEM = 232448            # 227 KB a block
# blocks the grouped grid holds at least (~2.6 waves of 3 blocks on each
# of the H100's 132 SMs), counting only the items it surely has
MIN_BLOCKS = 1024


class LaunchPlan(NamedTuple):
    """How one fused launch is cut: `variant`; for `grouped`,
    whether each entry is its own item (`direct`: one query, no plan
    kernel), the bound on work items (the grid's x), the row spans a tile
    (`split`, each of `span_chunks` 128-row chunks), the grid and the board
    kernel's shared memory (simt: the staged f32 query, or the int4
    kernel's two planes)."""
    variant: str
    direct: bool
    item_bound: int
    split: int
    span_chunks: int
    grid: Tuple[int, ...]
    smem_bytes: int


def row_bytes(d: int, dtype: torch.dtype) -> int:
    """The bytes of one tile row of d dims (int4, uint8: two dims a
    byte)."""
    return d // 2 if dtype == torch.uint8 else d * dtype.itemsize


def _grouped_smem(d: int, dtype: torch.dtype, direct: bool) -> int:
    """Shared memory of a grouped block (csrc `grouped_smem`): the item's
    entry ids and its query fragments, 8 bytes a lane a k16 slice a column
    tile (a 128-byte step holds 4 slices of bf16, 8 of int8, 16 of
    int4)."""
    steps = -(-row_bytes(d, dtype) // STEP_BYTES)
    kps = {torch.bfloat16: 4, torch.int8: 8, torch.uint8: 16}[dtype]
    tiles = 1 if direct else N_MAX // 8
    return N_MAX * 4 + tiles * steps * kps * 32 * 8


def item_bound(nq: int, nprobe: int, nlist: int) -> int:
    """The most work items a probe plan can hold: a distinct probed
    partition gives one item, and each further N_MAX of its entries one
    more."""
    n = nq * nprobe
    return min(nlist, n) + n // N_MAX


@functools.lru_cache(maxsize=1024)
def launch_plan(nq: int, nprobe: int, nlist: int, cap: int, d: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The fused launch of nq x nprobe probes of d-dim queries into nlist
    tiles of cap rows of `dtype` (uint8: packed int4, d / 2 bytes a row;
    `ivf_fused_int4`, else `ivf_fused_dense`). bf16, int8 and int4 rows
    whose byte width is a multiple of 16 take `grouped` when its query
    fragments fit in shared memory (bf16 d up to 3,584) and, past one
    query, when the plan's histogram does (nlist up to 32,768); everything
    else takes `simt`. A single query needs no
    plan: each probe is its own item. The rows of a tile are cut into the
    fewest spans that give MIN_BLOCKS blocks over the items the grid surely
    holds (n / N_MAX, or n when direct). Memoized: a request pays the
    lookup, not the search."""
    n = nq * nprobe
    direct = nq == 1
    if dtype not in (torch.bfloat16, torch.int8, torch.uint8) \
            or d % 2 or row_bytes(d, dtype) % 16 \
            or _grouped_smem(d, dtype, direct) > MAX_SMEM \
            or (not direct and nlist > PLAN_MAX_NLIST):
        return LaunchPlan(VARIANT_SIMT, False, 0, 0, 0,
                          (-(-cap // SIMT_ROWS), nprobe, nq), d * 4)
    bound = n if direct else item_bound(nq, nprobe, nlist)
    least = n if direct else -(-n // N_MAX)
    chunks = -(-cap // CHUNK_ROWS)
    span = max(1, chunks // -(-MIN_BLOCKS // least))
    split = -(-chunks // span)
    return LaunchPlan(VARIANT_GROUPED, direct, bound, split, span,
                      (bound, split), _grouped_smem(d, dtype, direct))


def int4_k_order() -> torch.Tensor:
    """The grouped int4 kernel's K order in one 128-byte step (256 dims),
    as its query staging lays out the B fragments: [16 k16 slices, 4 lanes
    t, 2 registers, 2 halves] -> the dim of the step (`mma_frag`'s layout,
    shared with the warp MaxSim kernels). Register 0 holds the fragment's
    k = 2t, 2t+1 (A: a0 of row g, a1 of row g + 8; B: b0), register 1 k =
    2t+8, 2t+9 (a2, a3; b1)."""
    return mma_frag.fragment_k_order(STEP_BYTES, torch.uint8)


def fused_eligible(parts_dtype, metric: str, precision: str = "bf16") -> bool:
    """Can the fused kernels serve this layout? (a tile dtype on the fused
    ladder, a dot-like metric, bf16 serving precision)"""
    return (parts_dtype in (torch.float32, torch.bfloat16, torch.int8,
                            torch.uint8)
            and metric != sim.L2_NORM
            and precision != "f32")


# --------------------------------------------------------------- plain version

def probe_board_reference(queries: torch.Tensor, ivf: IVFPartitions,
                          probe_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the [Q, nprobe, cap] masked
    board. One probe slot at a time (a staged [Q, cap, W] gather), with
    bf16-rounded operands widened to f32: their products are exact, so the
    f32 einsum with TF32 off is "bf16 operands, f32 accumulate"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    q = queries.to(f32)
    slots = []
    for pid in probe_ids.to(torch.int64).T:              # [Q] per slot
        scales = ivf.part_scales[pid]                    # [Q, cap]
        block = ivf.parts[pid]                           # [Q, cap, W]
        if ivf.parts.dtype == torch.uint8:
            dots = quant_codec.int4_blocked_dots(q, block, bf16)
        else:
            dots = torch.einsum("qd,qcd->qc", q.to(bf16).to(f32),
                                block.to(bf16).to(f32))
        s = dots * scales
        slots.append(torch.where(scales > 0, s, torch.full_like(s, NEG_INF)))
    return torch.stack(slots, dim=1)


def probe_plan_reference(probe_ids: torch.Tensor, nlist: int):
    """Plain PyTorch version of the probe plan: the entries e = q * nprobe
    + j of probe_ids [Q, nprobe] grouped by partition. Returns (entries
    [n_valid] int32, sorted by partition, then entry; items [n_items, 3]
    int32 of (partition, first, count): each partition's run cut into
    pieces of at most N_MAX, in partition order; invalid [m] int32, the
    entries whose id lies outside [0, nlist), set apart)."""
    ids = probe_ids.reshape(-1).to(torch.int64)
    dev = ids.device
    ok = (ids >= 0) & (ids < nlist)
    valid = torch.nonzero(ok).flatten()
    entries = valid[torch.argsort(ids[valid], stable=True)]
    counts = torch.bincount(ids[valid], minlength=nlist)
    offsets = torch.cumsum(counts, 0) - counts
    per = (counts + N_MAX - 1) // N_MAX
    part = torch.repeat_interleave(torch.arange(nlist, device=dev), per)
    piece = torch.arange(len(part), device=dev) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    first = offsets[part] + piece * N_MAX
    count = torch.clamp(counts[part] - piece * N_MAX, max=N_MAX)
    items = torch.stack([part, first, count], dim=1)
    return (entries.to(torch.int32), items.to(torch.int32),
            torch.nonzero(~ok).flatten().to(torch.int32))


# -------------------------------------------------------------- CUDA wrappers

def _lib() -> ctypes.CDLL:
    lib = _build.load("ivf_fused")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ivf_fused_dense.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.ivf_fused_dense.restype = ctypes.c_int
        lib.ivf_fused_dense_grouped.argtypes = [p, p, p, p, p, p,
                                                *[i] * 10, p]
        lib.ivf_fused_dense_grouped.restype = ctypes.c_int
        lib.ivf_fused_int4_grouped.argtypes = [p, p, p, p, p, p,
                                               *[i] * 9, p]
        lib.ivf_fused_int4_grouped.restype = ctypes.c_int
        lib.ivf_probe_plan.argtypes = [p, p, p, i, i, i, i, p]
        lib.ivf_probe_plan.restype = ctypes.c_int
        lib.ivf_fused_int4.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ivf_fused_int4.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_inputs(query_planes, ivf: IVFPartitions, probe_ids,
                  width: int) -> None:
    """Raise on anything the kernels do not take: they read every pointer
    at the sizes given here (each query plane [Q, width])."""
    parts, scales = ivf.parts, ivf.part_scales
    tensors = (*query_planes, probe_ids, parts, scales)
    dev = parts.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in query_planes) \
            or probe_ids.dtype != torch.int32 \
            or scales.dtype != torch.float32:
        raise TypeError("queries and scales must be float32, probe ids "
                        "int32")
    nq = probe_ids.shape[0] if probe_ids.dim() == 2 else -1
    if parts.dim() != 3 or scales.shape != parts.shape[:2] \
            or probe_ids.dim() != 2 or nq < 1 or probe_ids.shape[1] < 1 \
            or any(t.dim() != 2 or t.shape != (nq, width)
                   for t in query_planes):
        raise ValueError(
            f"shape mismatch: queries {[tuple(t.shape) for t in query_planes]}"
            f", probe ids {tuple(probe_ids.shape)}, parts "
            f"{tuple(parts.shape)}, scales {tuple(scales.shape)}")
    if nq > 65535 or probe_ids.shape[1] > 65535:
        raise ValueError("at most 65535 queries and 65535 probes per launch")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if parts.data_ptr() % 16:
        raise ValueError("partition tiles must be 16-byte aligned")


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().cuda_error_string(code).decode()}")


def _launch(name: str, fn, *args, variant=None, bucket=None) -> None:
    _check(fn(*args), name)
    dispatch.count_launch(name, variant, bucket)


def _plan_scratch(n: int, bound: int, device) -> torch.Tensor:
    """One int32 buffer for the probe plan: items [bound, 4] (16-byte rows),
    n_items [4], entries [n]."""
    return torch.empty((4 * bound + 4 + n,), dtype=torch.int32, device=device)


def probe_plan(probe_ids: torch.Tensor, nlist: int):
    """The grouped variant's probe plan for probe_ids [Q, nprobe] int32: the
    plan kernel on CUDA (then a sync, to cut the outputs to size), the
    plain version on the CPU. Returns (entries, items) as
    `probe_plan_reference` does; a CUDA plan's entries are in atomic order
    within each partition."""
    if probe_ids.device.type == "cpu":
        return probe_plan_reference(probe_ids, nlist)[:2]
    ids = probe_ids.to(torch.int32).contiguous()
    n = ids.numel()
    bound = item_bound(1, n, nlist)
    scratch = _plan_scratch(n, bound, ids.device)
    _check(_lib().ivf_probe_plan(
        ids.data_ptr(), scratch.data_ptr(), None, n, nlist, 1, bound,
        torch.cuda.current_stream(ids.device).cuda_stream),
        "ivf_probe_plan")
    n_items = int(scratch[4 * bound])
    items = scratch[:4 * bound].view(bound, 4)[:n_items, :3]
    n_valid = int(items[:, 2].sum())
    return scratch[4 * bound + 4:][:n_valid], items


def probe_board(queries: torch.Tensor, ivf: IVFPartitions,
                probe_ids: torch.Tensor) -> torch.Tensor:
    """The [Q, nprobe, cap] f32 board of metric-prepped queries [Q, D]
    against the tiles named by probe_ids [Q, nprobe] int32: the
    `ivf_fused_int4` kernel for packed int4 tiles, `ivf_fused_dense` for
    f32/bf16/int8 tiles on CUDA, each in the variant `launch_plan` names;
    the plain version on the CPU."""
    if queries.device.type == "cpu" and ivf.parts.device.type == "cpu":
        return probe_board_reference(queries, ivf, probe_ids)
    nlist, cap, w = ivf.parts.shape
    q = queries.to(torch.float32).contiguous()
    probe_ids = probe_ids.contiguous()
    nq, nprobe = probe_ids.shape
    int4 = ivf.parts.dtype == torch.uint8
    code = _DENSE_CODES.get(ivf.parts.dtype)
    if code is None and not int4:
        raise TypeError(f"no fused kernel for {ivf.parts.dtype} tiles")
    d = 2 * w if int4 else w                  # the queries' dims
    plan = launch_plan(nq, nprobe, nlist, cap, d, ivf.parts.dtype)
    simt = plan.variant == VARIANT_SIMT
    if int4 and simt:                         # the even and odd planes [Q, w]
        planes, width = quant_codec.split_query_planes(q), w
    else:
        planes, width = (q,), d
    _check_inputs(planes, ivf, probe_ids, width)
    out = torch.empty((nq, nprobe, cap), dtype=torch.float32,
                      device=ivf.parts.device)
    lib = _lib()
    stream = torch.cuda.current_stream(ivf.parts.device).cuda_stream
    board = (probe_ids.data_ptr(), ivf.parts.data_ptr(),
             ivf.part_scales.data_ptr(), out.data_ptr())
    bucket = f"q{nq}.probes{nprobe}.cap{cap}.d{d}"
    if simt:
        vec_ok = int(row_bytes(d, ivf.parts.dtype) % 16 == 0)
        if int4:
            _launch(KERNEL_INT4, lib.ivf_fused_int4, planes[0].data_ptr(),
                    planes[1].data_ptr(), *board, nq, nprobe, nlist, cap, w,
                    vec_ok, stream, variant=VARIANT_SIMT, bucket=bucket)
        else:
            _launch(KERNEL_DENSE, lib.ivf_fused_dense, q.data_ptr(), *board,
                    nq, nprobe, nlist, cap, d, code, vec_ok, stream,
                    variant=VARIANT_SIMT, bucket=bucket)
        return out
    if q.data_ptr() % 16:            # the kernel reads query rows as float4
        q = q.clone()
    scratch = None if plan.direct else _plan_scratch(
        nq * nprobe, plan.item_bound, out.device)
    cut = (int(plan.direct), plan.item_bound, plan.split, plan.span_chunks,
           stream)
    args = (q.data_ptr(), *board,
            None if scratch is None else scratch.data_ptr(),
            nq, nprobe, nlist, cap, d)
    if int4:
        _launch(KERNEL_INT4, lib.ivf_fused_int4_grouped, *args, *cut,
                variant=VARIANT_GROUPED, bucket=bucket)
    else:
        _launch(KERNEL_DENSE, lib.ivf_fused_dense_grouped, *args, code,
                *cut, variant=VARIANT_GROUPED, bucket=bucket)
    return out


# ------------------------------------------------------------ search entry

def fused_probe_scores(queries: torch.Tensor, ivf: IVFPartitions,
                       probe_ids: torch.Tensor, k: int):
    """Score probed partitions through the fused board, then join rows and
    take the top-k. queries must be metric-prepped (like
    `knn_ivf.score_probes`); probe_ids [Q, nprobe] int32 from
    `knn_ivf.route`. Returns (scores [Q, k], rows [Q, k] int32) — the
    `score_probes` contract (NEG_INF / -1 padding) for the dot-like
    metrics `fused_eligible` admits."""
    check_nprobe(probe_ids.shape[1], ivf.centroids.shape[0])
    board = probe_board(queries, ivf, probe_ids)
    nq = board.shape[0]
    rows = ivf.part_rows[probe_ids.to(torch.int64)]      # [Q, nprobe, cap]
    flat_s = board.reshape(nq, -1)
    flat_r = rows.reshape(nq, -1)
    flat_s = torch.where(flat_r >= 0, flat_s, torch.full_like(flat_s, NEG_INF))
    vals, pos = topk_ops.top_k(flat_s, k)
    return vals, torch.gather(flat_r, 1, pos)
