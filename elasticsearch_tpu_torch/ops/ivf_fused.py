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
`ivf_fused_int4` (packed nibbles against the even/odd query planes). Slots
whose scale is ≤ 0 (every padding slot) score NEG_INF. Each wrapper
launches its kernel for CUDA tensors, or raises; it runs the plain PyTorch
version (`probe_board_reference`) only for tensors on the CPU, so the CPU
tests follow the card's route. Eligibility alone decides the route: the
dot-like metrics at bf16 precision on any of the four tile types.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops import _build
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions, check_nprobe
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec

KERNEL_DENSE = "ivf_fused_dense"
KERNEL_INT4 = "ivf_fused_int4"

# tile dtype -> the dense kernel's dtype code
_DENSE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


# -------------------------------------------------------------- CUDA wrappers

def _lib() -> ctypes.CDLL:
    lib = _build.load("ivf_fused")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ivf_fused_dense.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.ivf_fused_dense.restype = ctypes.c_int
        lib.ivf_fused_int4.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ivf_fused_int4.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_inputs(query_planes, ivf: IVFPartitions, probe_ids) -> None:
    """Raise on anything the kernels do not take: they read every pointer
    at the sizes given here."""
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
            or any(t.dim() != 2 or t.shape != (nq, parts.shape[2])
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


def _launch(name: str, fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        lib = _lib()
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cuda_error_string(code).decode()}")
    dispatch.count_launch(name)


def probe_board(queries: torch.Tensor, ivf: IVFPartitions,
                probe_ids: torch.Tensor) -> torch.Tensor:
    """The [Q, nprobe, cap] f32 board of metric-prepped queries [Q, D]
    against the tiles named by probe_ids [Q, nprobe] int32: the
    `ivf_fused_int4` kernel for packed int4 tiles, `ivf_fused_dense` for
    f32/bf16/int8 tiles on CUDA; the plain version on the CPU."""
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
    planes = quant_codec.split_query_planes(q) if int4 else (q,)
    _check_inputs(planes, ivf, probe_ids)
    out = torch.empty((nq, nprobe, cap), dtype=torch.float32,
                      device=ivf.parts.device)
    lib = _lib()
    stream = torch.cuda.current_stream(ivf.parts.device).cuda_stream
    if int4:
        _launch(KERNEL_INT4, lib.ivf_fused_int4,
                planes[0].data_ptr(), planes[1].data_ptr(),
                probe_ids.data_ptr(), ivf.parts.data_ptr(),
                ivf.part_scales.data_ptr(), out.data_ptr(),
                nq, nprobe, nlist, cap, w, int(w % 16 == 0), stream)
        return out
    row_bytes = w * ivf.parts.element_size()
    _launch(KERNEL_DENSE, lib.ivf_fused_dense,
            q.data_ptr(), probe_ids.data_ptr(), ivf.parts.data_ptr(),
            ivf.part_scales.data_ptr(), out.data_ptr(),
            nq, nprobe, nlist, cap, w, code, int(row_bytes % 16 == 0), stream)
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
