"""Vector codecs: the f32, bf16, int8 and int4 rungs of the reference's
ladder.

A copy of the encoders of `elasticsearch_tpu/quant/codec.py` that the port
serves, with the host (numpy) encoders byte-identical to the reference's
and torch twins of its in-trace helpers (the int8 query quantizer and the
int4 plane unpack), each with its packed geometry (`packed_width`,
`row_bytes`) and host decoder (`decode_np`) as the token packer
(`quant/tokens.py`) uses them. The binary rung is not ported yet (see
ROADMAP.md).

    encoding   device matrix          per-row aux      bytes/row @768d
    f32        f32 [N, D]             —                3072
    bf16       bf16 [N, D]            —                1536
    int8       int8 [N, D]            scale f32        768 (+4)
    int4       uint8 [N, D/2]         scale f32        384 (+4)   packed nibbles
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# chunk budget for host encoders: never materialize a second
# corpus-sized f32 temp
_CHUNK_BYTES = 64 << 20


class Encoded(NamedTuple):
    """One host-encoded row block: packed data + per-row aux scales."""

    data: np.ndarray     # [n, D] rows (f32 / bf16 bits as uint16 / int8)
    scales: np.ndarray   # [n] f32 per-row aux (ones when unused)


# encodings whose device matrix is bit-packed (scored via the packed
# planes, served two-phase with exact rescore by default)
PACKED_ENCODINGS = ("int4",)

# the device matrix dtype of each encoding, and back
MATRIX_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8, "int4": torch.uint8}
_ENCODING_BY_DTYPE = {v: k for k, v in MATRIX_DTYPES.items()}


def encoding_of(matrix_dtype: torch.dtype) -> str:
    """The encoding a device matrix of this dtype holds."""
    return _ENCODING_BY_DTYPE.get(matrix_dtype, "f32")


class _Codec:
    """Geometry shared by the rungs: packed columns and bytes per row."""

    name = ""
    packed_np_dtype = np.float32

    def packed_width(self, dims: int) -> int:
        return dims

    def row_bytes(self, dims: int) -> int:
        return self.packed_width(dims) * np.dtype(self.packed_np_dtype).itemsize


class _F32Codec(_Codec):
    name = "f32"

    def encode_np(self, rows: np.ndarray) -> Encoded:
        rows = np.asarray(rows, dtype=np.float32)
        return Encoded(rows, np.ones(len(rows), dtype=np.float32))

    def decode_np(self, data, scales) -> np.ndarray:
        return np.asarray(data, dtype=np.float32)


class _BF16Codec(_Codec):
    """bf16 by round-to-nearest-even; the data is the raw bf16 bit pattern
    as uint16 (numpy has no bfloat16 type)."""

    name = "bf16"
    packed_np_dtype = np.uint16

    def encode_np(self, rows: np.ndarray) -> Encoded:
        rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))
        bits = rows.to(torch.bfloat16).view(torch.int16).numpy()
        return Encoded(bits.view(np.uint16), np.ones(len(bits), dtype=np.float32))

    def decode_np(self, data, scales) -> np.ndarray:
        # a bf16 value is the high half of its f32: widening is exact
        bits = np.ascontiguousarray(data).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)


class _Int8Codec(_Codec):
    """Per-row symmetric int8: scale = max|row|/127 (1e-30 floor)."""

    name = "int8"
    packed_np_dtype = np.int8

    def encode_np(self, rows: np.ndarray) -> Encoded:
        rows = np.asarray(rows, dtype=np.float32)
        n = rows.shape[0]
        q8 = np.empty(rows.shape, dtype=np.int8)
        scales = np.empty((n,), dtype=np.float32)
        chunk = max(1, _CHUNK_BYTES // max(rows.shape[1] * 4, 1))
        for lo in range(0, n, chunk):
            hi = lo + chunk
            block = rows[lo:hi]
            s = np.maximum(np.abs(block).max(axis=-1), 1e-30) / 127.0
            scales[lo:hi] = s
            q8[lo:hi] = np.clip(np.round(block / s[:, None]),
                                -127, 127).astype(np.int8)
        return Encoded(q8, scales)

    def decode_np(self, data, scales) -> np.ndarray:
        return data.astype(np.float32) * np.asarray(scales)[:, None]


class _Int4Codec(_Codec):
    """Packed-nibble symmetric int4: scale = max|row|/7, two dims per
    byte (even dim in the low nibble, odd in the high), levels in
    [-7, 7] stored offset-by-8 so every nibble is a valid level."""

    name = "int4"
    packed_np_dtype = np.uint8

    def packed_width(self, dims: int) -> int:
        if dims % 2:
            raise ValueError(f"int4 encoding requires even dims, got {dims}")
        return dims // 2

    def encode_np(self, rows: np.ndarray) -> Encoded:
        rows = np.asarray(rows, dtype=np.float32)
        n, d = rows.shape
        w = self.packed_width(d)
        packed = np.empty((n, w), dtype=np.uint8)
        scales = np.empty((n,), dtype=np.float32)
        chunk = max(1, _CHUNK_BYTES // max(d * 4, 1))
        for lo in range(0, n, chunk):
            hi = lo + chunk
            block = rows[lo:hi]
            s = np.maximum(np.abs(block).max(axis=-1), 1e-30) / 7.0
            scales[lo:hi] = s
            q = np.clip(np.round(block / s[:, None]), -7, 7).astype(np.int8)
            packed[lo:hi] = ((q[:, 0::2] + 8).astype(np.uint8)
                             | ((q[:, 1::2] + 8).astype(np.uint8) << 4))
        return Encoded(packed, scales)

    def decode_np(self, data, scales) -> np.ndarray:
        data = np.asarray(data)
        lo = (data & 0x0F).astype(np.int8) - 8
        hi = (data >> 4).astype(np.int8) - 8
        n, w = data.shape
        out = np.empty((n, 2 * w), dtype=np.float32)
        out[:, 0::2] = lo
        out[:, 1::2] = hi
        return out * np.asarray(scales)[:, None]


CODECS = {c.name: c for c in (_F32Codec(), _BF16Codec(), _Int8Codec(),
                              _Int4Codec())}


def get(name: str):
    codec = CODECS.get(name)
    if codec is None:
        raise KeyError(f"unknown vector encoding [{name}]; registered: "
                       f"{sorted(CODECS)}")
    return codec


def quantize_queries_int8(queries: torch.Tensor):
    """Per-QUERY symmetric int8 (twin of the reference's
    `quantize_queries_int8_jnp`): (q8 [Q, D] int8, qscale [Q, 1] f32).
    `torch.round` rounds half to even, as `jnp.round` does."""
    queries = queries.to(torch.float32)
    qmax = torch.amax(torch.abs(queries), dim=-1, keepdim=True)
    qscale = torch.clamp(qmax, min=1e-30) / 127.0
    q8 = torch.clamp(torch.round(queries / qscale), -127, 127).to(torch.int8)
    return q8, qscale


def int4_planes(packed: torch.Tensor, dtype=None):
    """Unpack a packed-nibble matrix [..., W] uint8 into its (even, odd)
    level planes [..., W] (values in [-8, 7]; encoders only emit [-7, 7]),
    twin of the reference's `int4_planes_jnp`. With `dtype` the planes are
    cast for the matmul."""
    lo = (packed & 0x0F).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    if dtype is not None:
        lo, hi = lo.to(dtype), hi.to(dtype)
    return lo, hi


def split_query_planes(queries: torch.Tensor):
    """Match a query batch [Q, D] to the int4 plane layout: (even dims
    [Q, D/2], odd dims [Q, D/2]), contiguous."""
    return queries[:, 0::2].contiguous(), queries[:, 1::2].contiguous()


def int4_blocked_dots(queries: torch.Tensor, blocks: torch.Tensor,
                      dtype) -> torch.Tensor:
    """Un-descaled int4 dots for IVF probe tiles: queries [Q, D] f32,
    blocks [Q, C, W] packed uint8 → [Q, C] f32 (twin of the reference's
    `int4_blocked_dots_jnp`; callers multiply the per-row scales in).
    Operands are rounded to `dtype`, then widened: the products of bf16
    values are exact in f32, so the f32 einsum is "bf16 operands, f32
    accumulate"."""
    lo, hi = int4_planes(blocks, dtype)
    qe, qo = split_query_planes(queries)
    f32 = torch.float32
    return (torch.einsum("qd,qcd->qc", qe.to(dtype).to(f32), lo.to(f32))
            + torch.einsum("qd,qcd->qc", qo.to(dtype).to(f32), hi.to(f32)))
