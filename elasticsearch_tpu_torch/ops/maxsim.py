"""Fused gather + MaxSim rescore of late-interaction candidates on the
hand-written Hopper kernels (port of `elasticsearch_tpu/ops/pallas_maxsim.py`).

A late-interaction query holds Tq token vectors and scores a doc as
``sum_t max_c dot(q_token_t, doc_token_c)`` (MaxSim). The serving shape is
two-phase (`vectors/late_interaction.py`): a coarse single-vector search
over pooled doc centroids picks a candidate window, then these kernels
rescore the window against the full token tiles. The kernels read each
(query, candidate) tile straight out of the resident [N_pad, cap, W] token
tile by its candidate id, so no [Q, W, cap, D] gather is staged in device
memory: the [Q, W] MaxSim board is the only new array.

Kernels (`csrc/maxsim.cu`): `maxsim_dense` (f32, bf16 and int8 token tiles:
bf16 operands, f32 accumulate, × per-token scale) and `maxsim_int4`
(packed nibbles against the even/odd query planes), for any query token
count and tile width. Token slots whose
scale is 0 (cap padding and whole padding docs) score NEG_INF before the
max; zero-padded query token rows add exactly 0.0 to a doc with any valid
token. The wrapper launches a kernel for CUDA tensors, or raises; it runs
the plain PyTorch version (`maxsim_reference`) only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops import _build
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec

KERNEL_DENSE = "maxsim_dense"
KERNEL_INT4 = "maxsim_int4"

# tile dtype -> the dense kernel's dtype code
_DENSE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# --------------------------------------------------------------- plain version

def maxsim_reference(ids: torch.Tensor, q_tokens: torch.Tensor,
                     toks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the [Q, W] f32 board. One
    query at a time (a staged [W, cap, W_tile] gather), bf16-rounded
    operands widened to f32 (their products are exact, so the f32 einsum
    with TF32 off is "bf16 operands, f32 accumulate"), per-token de-scale,
    NEG_INF mask on zero-scale slots, max over doc tokens, sum over query
    tokens. int4 keeps the two plane sums separate until the end."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    q = q_tokens.to(f32)
    int4 = toks.dtype == torch.uint8
    rows = []
    for qi, cand in enumerate(ids.to(torch.int64)):
        tile = toks[cand]                                # [W, cap, Wt]
        s = scales[cand][:, None, :]                     # [W, 1, cap]
        if int4:
            lo, hi = quant_codec.int4_planes(tile, bf16)
            qe = q[qi, :, 0::2].to(bf16).to(f32)
            qo = q[qi, :, 1::2].to(bf16).to(f32)
            dots = (torch.einsum("td,wcd->wtc", qe, lo.to(f32))
                    + torch.einsum("td,wcd->wtc", qo, hi.to(f32)))
        else:
            dots = torch.einsum("td,wcd->wtc", q[qi].to(bf16).to(f32),
                                tile.to(bf16).to(f32))
        masked = torch.where(s > 0, dots * s, torch.full_like(dots, NEG_INF))
        rows.append(masked.amax(dim=2).sum(dim=1))
    return torch.stack(rows)


# -------------------------------------------------------------- CUDA wrappers

def _lib() -> ctypes.CDLL:
    lib = _build.load("maxsim")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maxsim_dense.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.maxsim_dense.restype = ctypes.c_int
        lib.maxsim_int4.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.maxsim_int4.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_inputs(ids, q, toks, scales) -> None:
    """Raise on anything the kernels do not take: they read every pointer
    at the sizes given here. (Any Tq and width fit a block's shared memory:
    the kernel takes query rows in groups and the width in slabs. More than
    65535 queries in one launch are refused by the launch itself, which
    returns an error code.)"""
    tensors = (ids, q, toks, scales)
    dev = toks.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must lie on one CUDA device")
    if ids.dtype != torch.int32 or q.dtype != torch.float32 \
            or scales.dtype != torch.float32:
        raise TypeError("candidate ids must be int32, query tokens and "
                        "scales float32")
    if toks.dtype not in _DENSE_CODES and toks.dtype != torch.uint8:
        raise TypeError(f"no MaxSim kernel for {toks.dtype} token tiles")
    planes = 2 if toks.dtype == torch.uint8 else 1
    if ids.dim() != 2 or q.dim() != 3 or toks.dim() != 3 \
            or ids.shape[0] < 1 or ids.shape[1] < 1 \
            or q.shape[0] != ids.shape[0] or q.shape[1] < 1 \
            or q.shape[2] != planes * toks.shape[2] \
            or tuple(scales.shape) != tuple(toks.shape[:2]) \
            or toks.shape[2] % 16:
        raise ValueError(
            f"shape mismatch: ids {tuple(ids.shape)}, query tokens "
            f"{tuple(q.shape)}, token tile {tuple(toks.shape)} (its width a "
            f"multiple of 16), scales {tuple(scales.shape)}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if toks.data_ptr() % 16:
        raise ValueError("token tiles must be 16-byte aligned")


def maxsim_rescore(ids: torch.Tensor, q_tokens: torch.Tensor,
                   toks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Rescore candidate docs `ids` [Q, W] int32 against the resident token
    tile: `maxsim_int4` for packed int4 tiles, `maxsim_dense` for f32/bf16/
    int8 tiles on CUDA; the plain version on the CPU.

    q_tokens [Q, Tq, D] f32 must be metric-prepped and zero-padded to the
    tile's lane width; toks/scales are the field's [N_pad, cap, W] tile and
    [N_pad, cap] per-token scales. Invalid candidate slots must point at an
    all-padding doc row, which scores at most NEG_INF. Returns [Q, W] f32."""
    if all(t.device.type == "cpu" for t in (ids, q_tokens, toks, scales)):
        return maxsim_reference(ids, q_tokens, toks, scales)
    _check_inputs(ids, q_tokens, toks, scales)
    n_pad, cap, w = toks.shape
    nq, nw = ids.shape
    tq = q_tokens.shape[1]
    out = torch.empty((nq, nw), dtype=torch.float32, device=toks.device)
    lib = _lib()
    stream = torch.cuda.current_stream(toks.device).cuda_stream
    args = (ids.data_ptr(), q_tokens.data_ptr(), toks.data_ptr(),
            scales.data_ptr(), out.data_ptr(), nq, nw, tq, n_pad, cap, w)
    if toks.dtype == torch.uint8:
        name, code = KERNEL_INT4, lib.maxsim_int4(*args, stream)
    else:
        name, code = KERNEL_DENSE, lib.maxsim_dense(
            *args, _DENSE_CODES[toks.dtype], stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cuda_error_string(code).decode()}")
    dispatch.count_launch(name)
    return out
