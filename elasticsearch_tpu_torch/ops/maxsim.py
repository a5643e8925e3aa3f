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
(packed nibbles), for any query token count and tile width. Token slots
whose scale is 0 (cap padding and whole padding docs) score NEG_INF before
the max; zero-padded query token rows add exactly 0.0 to a doc with any
valid token. The wrapper launches a kernel for CUDA tensors, or raises; it
runs the plain PyTorch version (`maxsim_reference`) only for tensors on the
CPU.

Both kernels come in two variants, picked by `launch_plan` from the shape:
`warp` (bf16, int8 and int4 tiles at Tq <= 32: one warp a candidate, only
the rows up to its last valid slot read, through a per-warp cp.async ring
into tensor-core fragments in the K order of `ops/mma_frag.py`) and `wmma`
(f32 tiles and wider queries: the first port's kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from elasticsearch_tpu_torch.ops import _build
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import mma_frag
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec

KERNEL_DENSE = "maxsim_dense"
KERNEL_INT4 = "maxsim_int4"

# tile dtype -> the dense kernel's dtype code
_DENSE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# launch plan of both kernels (mirrors the constants of csrc/maxsim.cu)
VARIANT_WARP = "warp"
VARIANT_WMMA = "wmma"
_VARIANT_CODES = {VARIANT_WMMA: 0, VARIANT_WARP: 1}
WARP_WARPS = 4               # warp: warps a block
WARP_TQ_MAX = 32             # warp: query tokens (4 column tiles of 8)
WARP_MAX_CPW = 32            # warp: candidates a warp (one id a lane)
WARP_MAX_FRAG = 65536        # warp: the query fragments of a block
WARP_STAGES = 4              # warp: units in a warp's cp.async ring
# warp: warps the grid aims at (~31 an SM over the H100's 132 SMs); past
# that, each warp takes more candidates
TARGET_WARPS = 4096
WMMA_CAPC = 64               # wmma: doc token slots a staged chunk
WMMA_QG_MAX = 128            # wmma: query rows a group
WMMA_PAD = 8                 # wmma: bf16 padding of a staged row
MAX_SMEM = 232448            # 227 KB a block


class LaunchPlan(NamedTuple):
    """How one MaxSim launch is cut: `variant`, candidates a block (`cpb`:
    warp, 4 warps each taking every 4th; wmma, one block walking them), the
    grid (candidate runs, queries) and the block's shared memory (warp: the
    query's B fragments and the warps' load rings; wmma: query and chunk
    planes, boards, maxima)."""
    variant: str
    cpb: int
    grid: Tuple[int, int]
    smem_bytes: int


def _warp_frag(w: int, dtype: torch.dtype) -> int:
    """The warp block's query fragments: 4 column tiles x live slices x 32
    lanes x 8 bytes."""
    return 4 * mma_frag.live_slices(w, dtype) * 32 * 8


def _warp_smem(w: int, dtype: torch.dtype) -> int:
    """The warp block's shared memory (csrc `warp_smem`): the query
    fragments, each warp's ring of WARP_STAGES units of 2 KB and its
    candidates' spans."""
    return (_warp_frag(w, dtype) + WARP_WARPS * WARP_STAGES * 2048
            + WARP_WARPS * WARP_MAX_CPW * 4)


def _wmma_smem(tq: int, w: int, dtype: torch.dtype) -> int:
    """The wmma block's shared memory (csrc `wmma_shape`): the whole plane
    width in one slab if it fits in 227 KB, else the widest slab that
    does."""
    np_ = 2 if dtype == torch.uint8 else 1
    qg = min(-(-tq // 16) * 16, WMMA_QG_MAX)

    def smem(ks, slabs):
        board = np_ * qg * 16 if slabs else 256
        return (np_ * (qg + WMMA_CAPC) * (ks + WMMA_PAD) * 2 + 4 * board * 4
                + WMMA_CAPC * 4 + 4 * qg * 4)

    ks, cand = w, 512
    if smem(ks, False) > MAX_SMEM:
        while smem(ks, True) > MAX_SMEM:
            if cand < ks:
                ks = cand
            cand //= 2
    return smem(ks, ks < w)


@functools.lru_cache(maxsize=1024)
def launch_plan(nq: int, nw: int, tq: int, cap: int, w: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The MaxSim launch of nq queries of tq tokens, nw candidates each,
    against [N_pad, cap, w] token tiles of `dtype` (uint8: packed int4, w
    bytes a row; `maxsim_int4`, else `maxsim_dense`). bf16, int8 and int4
    tiles take `warp` at tq <= 32 while the query fragments fit in 64 KB
    (bf16 D up to 1,024 dims); f32 tiles and wider queries take `wmma`. Warp:
    each warp takes ceil(nq * nw / TARGET_WARPS) candidates (at most 32),
    so a Q=1 window of 64 spreads over 16 blocks, one candidate a warp.
    The token cap bounds neither variant (the warp reads each candidate's
    span; the wmma kernel streams its chunks). Memoized: a request pays
    the lookup, not the search."""
    if min(nq, nw, tq, cap, w) < 1:
        raise ValueError(f"no MaxSim launch for nq={nq} nw={nw} tq={tq} "
                         f"cap={cap} w={w}")
    if dtype in (torch.bfloat16, torch.int8, torch.uint8) \
            and tq <= WARP_TQ_MAX and w % 16 == 0 \
            and _warp_frag(w, dtype) <= WARP_MAX_FRAG:
        cpw = min(WARP_MAX_CPW, max(1, -(-(nq * nw) // TARGET_WARPS)))
        cpb = WARP_WARPS * cpw
        return LaunchPlan(VARIANT_WARP, cpb, (-(-nw // cpb), nq),
                          _warp_smem(w, dtype))
    cpb = max(1, min(8, nq * nw // 2048))
    return LaunchPlan(VARIANT_WMMA, cpb, (-(-nw // cpb), nq),
                      _wmma_smem(tq, w, dtype))



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
        ll = ctypes.c_longlong
        lib.maxsim_dense.argtypes = [p] * 5 + [i] * 9 + [ll, p]
        lib.maxsim_dense.restype = ctypes.c_int
        lib.maxsim_int4.argtypes = [p] * 5 + [i] * 8 + [ll, p]
        lib.maxsim_int4.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_inputs(ids, q, toks, scales) -> None:
    """Raise on anything the kernels do not take: they read every pointer
    at the sizes given here. (Any Tq and width fit one of the two variants.
    More than 65535 queries in one launch are refused by the launch itself,
    which returns an error code.)"""
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
    int8 tiles on CUDA, each in the variant `launch_plan` names; the plain
    version on the CPU.

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
    plan = launch_plan(nq, nw, tq, cap, w, toks.dtype)
    if q_tokens.data_ptr() % 16:       # the warp kernel reads float4 rows
        q_tokens = q_tokens.clone()
    out = torch.empty((nq, nw), dtype=torch.float32, device=toks.device)
    lib = _lib()
    stream = torch.cuda.current_stream(toks.device).cuda_stream
    args = (ids.data_ptr(), q_tokens.data_ptr(), toks.data_ptr(),
            scales.data_ptr(), out.data_ptr(), nq, nw, tq, n_pad, cap, w)
    cut = (_VARIANT_CODES[plan.variant], plan.cpb, plan.smem_bytes, stream)
    if toks.dtype == torch.uint8:
        name, code = KERNEL_INT4, lib.maxsim_int4(*args, *cut)
    else:
        name, code = KERNEL_DENSE, lib.maxsim_dense(
            *args, _DENSE_CODES[toks.dtype], *cut)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cuda_error_string(code).decode()}")
    dispatch.count_launch(name, plan.variant, f"q{nq}.w{nw}.tq{tq}")
    return out
