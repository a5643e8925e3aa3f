"""The K order of `csrc/mma_frag.cuh`, written out in Python: how a row of
bf16, int8 or packed-int4 tile values is laid over the k16 slices of
`mma.sync.m16n8k16` fragments when a warp streams it 16 bytes a lane a
128-byte step, and how the query's B fragments are staged to match. The
grouped IVF kernels and the warp MaxSim kernels share that layout; tests
emulate the loads and widenings against it on the CPU.
"""

from __future__ import annotations

import torch

STEP_BYTES = 128             # row bytes a warp loads a step


def piece_values(dtype: torch.dtype) -> int:
    """Tile values a 16-byte piece holds (uint8: packed int4, 32)."""
    return {torch.bfloat16: 8, torch.int8: 16, torch.uint8: 32}[dtype]


def live_slices(w: int, dtype: torch.dtype) -> int:
    """k16 slices of a row of w tile values (uint8: w packed bytes): E / 2
    a whole 128-byte step, half of them for a last step of at most 64
    bytes (its second pieces lie past the row)."""
    rb = 2 * w if dtype == torch.bfloat16 else w
    kps = piece_values(dtype) // 2
    rem = rb % STEP_BYTES
    return (rb // STEP_BYTES) * kps + (0 if rem == 0 else
                                       kps // 2 if rem <= 64 else kps)


def fragment_k_order(w: int, dtype: torch.dtype) -> torch.Tensor:
    """The K order for a row of w tile values (uint8: w packed bytes, 2w
    dims), as the query staging lays out the B fragments (`group_slot`,
    `b_group`): [live slices, 4 lanes t, 2 registers, 2 halves] -> the dim
    each holds, or -1 past the row's dims. Register 0 holds the fragment's
    k = 2t, 2t+1 (A: a0 of row g, a1 of row g + 8), register 1 k = 2t+8,
    2t+9 (a2, a3). Lane t reads pieces t and 4 + t (pp = 0, 1) of a step;
    bf16 and int8 slice pp E/4 + h takes values 4h..4h+3 of its piece,
    int4 slice pp E/4 + 2i + c takes dims (2c, 2c+4) and (2c+1, 2c+5) of
    word i, the pairs that one widening of the word shifted by 8c gives."""
    e = piece_values(dtype)
    int4 = dtype == torch.uint8
    dims = 2 * w if int4 else w
    kps = e // 2
    order = torch.full((live_slices(w, dtype), 4, 2, 2), -1,
                       dtype=torch.int64)
    for gi in range(order.shape[0] * 4):      # the staging loop's groups
        d0 = 8 * (gi >> 1) if int4 else 4 * gi
        pos = d0 % (8 * e)
        pp, t = pos // (4 * e), (pos % (4 * e)) // e
        h = 2 * ((pos % e) // 8) + (gi & 1) if int4 else (pos % e) // 4
        ks = (d0 // (8 * e)) * kps + pp * (e // 4) + h
        a = d0 + 2 * (gi & 1) if int4 else d0
        cell = [[a, a + 4], [a + 1, a + 5]] if int4 else \
            [[a, a + 1], [a + 2, a + 3]]
        order[ks, t] = torch.tensor(
            [[x if x < dims else -1 for x in pair] for pair in cell])
    return order
