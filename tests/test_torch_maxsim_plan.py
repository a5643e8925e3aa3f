"""The MaxSim kernels' launch plan (`ops/maxsim.py::launch_plan`), which
the CUDA entry points take as given: which variant a shape takes, how the
(query, candidate) pairs are cut into blocks and warps, and the shared
memory each variant's block needs; and the fragment K order the warp
variant stages its query in (`ops/mma_frag.py::fragment_k_order`) against
an emulation of its loads and of its int8 and int4 widening over every
byte value. All of it runs on the CPU; the
kernels themselves are held against their plain versions on the card by
`tests/test_torch_gpu.py` and `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import maxsim
from elasticsearch_tpu_torch.ops import mma_frag
from elasticsearch_tpu_torch.quant import codec

BF16, INT8, F32, UINT8 = torch.bfloat16, torch.int8, torch.float32, \
    torch.uint8

# (Q, W, Tq, cap, tile width, tiles) of the served paths: the hybrid
# late_interaction leg at batch 1 (int8 at oversample 4: W = 64; int4 at
# oversample 8: W = 100, 64 packed bytes a row; bf16), shorter queries
# (Tq 8 and 16), the batch a combining batcher would form (Q = 64) and the
# kernel phase's Q = 256
SERVED = [(1, 64, 32, 256, 128, INT8), (1, 100, 32, 256, 64, UINT8),
          (1, 64, 32, 256, 128, BF16), (1, 64, 8, 256, 128, INT8),
          (1, 64, 16, 128, 64, UINT8), (64, 64, 32, 256, 128, INT8),
          (256, 64, 32, 256, 128, INT8), (256, 64, 32, 256, 64, UINT8),
          (256, 64, 32, 256, 128, BF16)]


@pytest.mark.parametrize("nq,nw,tq,cap,w,dtype", SERVED)
def test_served_shapes_take_warp(nq, nw, tq, cap, w, dtype):
    """Every served shape takes the warp variant: 8 KB of query fragments
    (4 column tiles x 8 k16 slices of a 128-dim row), 4 warps a block, each
    with a ring of 2 KB load units and 32 candidate spans."""
    plan = maxsim.launch_plan(nq, nw, tq, cap, w, dtype)
    assert plan.variant == maxsim.VARIANT_WARP
    assert plan.smem_bytes == 8192 + 4 * maxsim.WARP_STAGES * 2048 + 512
    assert plan.cpb % maxsim.WARP_WARPS == 0
    assert plan.grid == (-(-nw // plan.cpb), nq)


@pytest.mark.parametrize("nq,nw,tq,w,dtype", [
    (1, 64, 32, 128, F32), (256, 64, 32, 128, F32), (3, 24, 33, 128, INT8),
    (3, 24, 64, 64, UINT8), (3, 24, 128, 768, BF16), (3, 24, 300, 128, INT8),
    (3, 24, 32, 2048, BF16), (3, 24, 32, 1040, INT8)])
def test_f32_and_wide_shapes_take_wmma(nq, nw, tq, w, dtype):
    """f32 tiles, more than 32 query tokens, and query fragments over 64 KB
    (bf16 D=2048; int8 D=1040 rounds up to 1,152 staged dims) take wmma;
    its shared memory stays within a block's 227 KB."""
    plan = maxsim.launch_plan(nq, nw, tq, 100, w, dtype)
    assert plan.variant == maxsim.VARIANT_WMMA
    assert plan.smem_bytes <= maxsim.MAX_SMEM
    assert plan.grid == (-(-nw // plan.cpb), nq)


def test_q1_window_spreads_one_candidate_a_warp():
    """A batch-1 window of 64 runs as one short wave: 16 blocks of 4 warps,
    one candidate each; int4's window of 100 as 25 blocks."""
    plan = maxsim.launch_plan(1, 64, 32, 256, 128, INT8)
    assert plan.cpb == 4 and plan.grid == (16, 1)
    plan = maxsim.launch_plan(1, 100, 32, 256, 64, UINT8)
    assert plan.cpb == 4 and plan.grid == (25, 1)


def test_q256_gives_each_warp_four_candidates():
    """Q=256 x W=64 = 16,384 pairs over TARGET_WARPS warps: 4 a warp, 16 a
    block, 1,024 blocks."""
    plan = maxsim.launch_plan(256, 64, 32, 256, 128, INT8)
    assert plan.cpb == 16 and plan.grid == (4, 256)


def _pairs(plan, nq, nw):
    """The (query, candidate) pairs the kernel's blocks and warps take,
    as csrc/maxsim.cu walks them (warp: warp w of a block takes every 4th
    candidate of the block's run, at most 32; wmma: the block takes its
    run)."""
    seen = []
    for bx in range(plan.grid[0]):
        lo, hi = bx * plan.cpb, min(bx * plan.cpb + plan.cpb, nw)
        for qi in range(plan.grid[1]):
            if plan.variant == maxsim.VARIANT_WMMA:
                seen += [(qi, j) for j in range(lo, hi)]
                continue
            for warp in range(maxsim.WARP_WARPS):
                own = list(range(lo + warp, hi, maxsim.WARP_WARPS))
                assert len(own) <= maxsim.WARP_MAX_CPW
                seen += [(qi, j) for j in own]
    return seen


@pytest.mark.parametrize("nq,nw,tq,dtype", [
    (1, 1, 32, INT8), (1, 64, 32, INT8), (1, 100, 32, UINT8),
    (3, 7, 8, BF16), (256, 64, 32, INT8), (700, 100, 32, UINT8),
    (5000, 64, 32, BF16), (65535, 200, 32, INT8), (9, 37, 128, INT8),
    (300, 64, 32, F32)])
def test_grid_covers_every_pair_once(nq, nw, tq, dtype):
    """Every (query, candidate) pair falls to exactly one warp (or one
    wmma block), whatever the run length and the window's remainder."""
    w = 64 if dtype == UINT8 else 128
    plan = maxsim.launch_plan(nq, nw, tq, 256, w, dtype)
    if nq > 1000:                       # every query is cut alike
        seen = _pairs(plan._replace(grid=(plan.grid[0], 1)), 1, nw)
        assert sorted(seen) == [(0, j) for j in range(nw)]
        return
    seen = _pairs(plan, nq, nw)
    assert len(seen) == nq * nw
    assert set(seen) == {(qi, j) for qi in range(nq) for j in range(nw)}


@pytest.mark.parametrize("w,dtype,slices", [
    (128, BF16, 8), (128, INT8, 8), (64, UINT8, 8), (96, BF16, 6),
    (48, INT8, 4), (16, UINT8, 8), (80, UINT8, 16), (384, UINT8, 48),
    (160, INT8, 12), (1024, BF16, 64)])
def test_live_slices(w, dtype, slices):
    """k16 slices of a row: KPS a whole 128-byte step (bf16 4, int8 8, int4
    16), half of them for a last step of at most 64 bytes."""
    assert mma_frag.live_slices(w, dtype) == slices
    assert mma_frag.fragment_k_order(w, dtype).shape == (slices, 4, 2, 2)


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError, match="no MaxSim launch"):
        maxsim.launch_plan(1, 0, 32, 256, 128, INT8)


# ------------------------------------------------ the warp fragment layout

def _bf16_bits(bits):
    """bf16 bit patterns (uint32 < 2^16) as f32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _widen_int4(x):
    """csrc `int4_pair`: the nibbles at bits 0-3 and 16-19 of x into a
    bf16x2 of 128 + n (a lop3 with 0x000F000F and 0x43004300), then a
    bf16x2 subtract of 136, rounded to bf16. Returns (low, high)."""
    v = (x & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    out = []
    for half in (v & np.uint32(0xFFFF), v >> np.uint32(16)):
        diff = torch.from_numpy(_bf16_bits(half) - np.float32(136.0))
        rounded = diff.to(torch.bfloat16).to(F32).numpy()
        assert (rounded == diff.numpy()).all()      # exact: no rounding
        out.append(rounded)
    return out


def _widen_int8(x):
    """csrc `widen_int8`: each byte of x ^ 0x80808080 into the low byte of
    2^23 (a byte permute with 0x4B000000), one f32 subtract of 8,388,736,
    then the top halves of two such f32 values as one bf16x2 (a byte
    permute, which truncates). Returns the four levels as
    [(lo.low, lo.high), (hi.low, hi.high)]."""
    u = x ^ np.uint32(0x80808080)
    f = [((u >> np.uint32(8 * i)) & np.uint32(0xFF) | np.uint32(0x4B000000))
         .view(np.float32) - np.float32(8388736.0) for i in range(4)]
    top = [_bf16_bits(v.view(np.uint32) >> np.uint32(16)) for v in f]
    for v, t in zip(f, top):
        assert (v == t).all()                        # exact: no truncation
    return [(top[0], top[1]), (top[2], top[3])]


def _a_fragments(rows, w, dtype):
    """An emulation of the warp kernel's loads and widening: rows [n, row
    bytes] uint8 -> [n, live slices, 4 lanes t, 2 registers, 2 halves]
    values. Slice ks is step s = ks // KPS, r = ks % KPS; lane t reads the
    16 bytes at s * 128 + 64 pp + 16 t (pp = r // (KPS / 2); zero past the
    row), and h = r % (KPS / 2) picks the words: bf16 2h and 2h + 1 as they
    are, int8 word h widened, int4 word h // 2 shifted by 8 (h % 2) and
    widened, and widened again 4 bits further."""
    e = {BF16: 8, INT8: 16, UINT8: 32}[dtype]
    kps = e // 2
    n, rb = rows.shape
    ksl = mma_frag.live_slices(w, dtype)
    padded = np.zeros((n, -(-rb // 128) * 128), dtype=np.uint8)
    padded[:, :rb] = rows
    out = np.empty((n, ksl, 4, 2, 2), dtype=np.float32)
    for ks in range(ksl):
        s, r = divmod(ks, kps)
        pp, h = divmod(r, kps // 2)
        for t in range(4):
            off = s * 128 + 64 * pp + 16 * t
            words = np.ascontiguousarray(padded[:, off:off + 16]).view(
                np.uint32)                            # [n, 4]
            if dtype == BF16:
                for reg in range(2):
                    x = words[:, 2 * h + reg]
                    out[:, ks, t, reg, 0] = _bf16_bits(x & np.uint32(0xFFFF))
                    out[:, ks, t, reg, 1] = _bf16_bits(x >> np.uint32(16))
            elif dtype == INT8:
                for reg, pair in enumerate(_widen_int8(words[:, h])):
                    out[:, ks, t, reg] = np.stack(pair, axis=-1)
            else:
                x = words[:, h // 2] >> np.uint32(8 * (h % 2))
                for reg, y in enumerate((x, x >> np.uint32(4))):
                    out[:, ks, t, reg] = np.stack(_widen_int4(y), axis=-1)
    return out


def _rows(rb):
    """Rows of rb bytes that hold every byte value at every byte position
    (rotations of 0..255), plus random rows."""
    rng = np.random.default_rng(rb)
    every = np.arange(256, dtype=np.uint8)
    rows = [np.roll(every, k)[np.arange(rb) % 256] for k in range(256)]
    rows += [rng.integers(0, 256, rb).astype(np.uint8) for _ in range(8)]
    return np.stack(rows)


def _levels(rows, dtype):
    """The codec's values of rows [n, row bytes] uint8 in dim order."""
    t = torch.from_numpy(rows)
    if dtype == BF16:
        return t.view(BF16).to(F32).numpy()
    if dtype == INT8:
        return t.view(INT8).to(F32).numpy()
    lo, hi = codec.int4_planes(t)
    return torch.stack([lo, hi], dim=-1).reshape(len(rows), -1).to(
        F32).numpy()


# (tile width, tiles): ColBERTv2's 128 dims on each tile type (int4: 64
# bytes, half a step), partial steps (int8 48 bytes; int4 80 bytes, whose
# second pieces end inside the row; bf16 96 dims, a step and a half) and
# rows of several steps
ORDERS = [(128, BF16), (128, INT8), (64, UINT8), (48, INT8), (80, UINT8),
          (96, BF16), (256, INT8), (192, UINT8), (16, UINT8)]


@pytest.mark.parametrize("w,dtype", ORDERS)
@pytest.mark.parametrize("check", ["permutation", "widening", "dot"])
def test_fragment_k_order(w, dtype, check):
    """The warp kernel's K order: every dim of the row exactly once (-1
    past it); the emulated loads and widening of every byte value give, at
    each (slice, lane, register, half) the order names a dim, the codec's
    value of that dim (so A, as loaded and widened, and B, as staged, meet
    at the same dims), and 0 (bf16, int8) or -8 (int4) past the row, where
    the staged query is 0; and the dot product over the fragments equals
    the straight one."""
    order = mma_frag.fragment_k_order(w, dtype).numpy()
    dims = 2 * w if dtype == UINT8 else w
    rb = 2 * w if dtype == BF16 else w
    live = order[order >= 0]
    if check == "permutation":
        assert sorted(live.tolist()) == list(range(dims))
        return
    rows = _rows(rb)
    if dtype == BF16:                 # finite bf16 patterns only
        bits = rows.view(np.uint16)
        rows = np.where((bits & 0x7F80) == 0x7F80, bits & 0x3FFF,
                        bits).astype(np.uint16).view(np.uint8)
    levels = _levels(rows, dtype)
    got = _a_fragments(rows, w, dtype)
    if check == "widening":
        assert (got[:, order >= 0] == levels[:, live]).all()
        assert (got[:, order < 0] == (-8.0 if dtype == UINT8 else 0.0)).all()
        return
    rng = np.random.default_rng(w)
    q = rng.standard_normal((5, dims)).astype(np.float32)
    qb = torch.from_numpy(q).to(BF16).to(F32).numpy()
    staged = np.where(order >= 0, qb[:, np.maximum(order, 0)], 0.0)
    permuted = np.einsum("qskrh,nskrh->qn", staged.astype(np.float64),
                         got.astype(np.float64))
    straight = qb.astype(np.float64) @ levels.T.astype(np.float64)
    np.testing.assert_allclose(permuted, straight, rtol=1e-12, atol=1e-9)
