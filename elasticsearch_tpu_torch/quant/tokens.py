"""Token-block packing for late-interaction (multi-vector) fields (port of
`elasticsearch_tpu/quant/tokens.py`, numpy only).

A `rank_vectors` doc stores a ragged [n_tokens, dims] token matrix
(ColBERT-style). This module is the one owner of how those matrices become
device blocks:

* tokens metric-prep FIRST (cosine → per-token unit norm), so MaxSim over
  encoded tokens approximates the mapped similarity and per-segment
  encoding equals whole-corpus encoding byte for byte;
* the feature dim zero-pads up to a LANE (128) multiple BEFORE encoding —
  the MaxSim kernels move whole lane-aligned token rows, and zero tail
  columns add exactly 0.0 to every dot;
* rows then encode through the codec (`quant/codec.py`) with per-TOKEN
  scales: each token row is an independent codec row. Encoded blocks are
  byte-identical to the reference's (bf16 as its uint16 bit pattern).

The pooled per-doc centroid (mean of prepped tokens, re-normalized for
cosine) also comes from here: it is the single vector the coarse retrieval
phase indexes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from elasticsearch_tpu_torch.quant import codec as quant_codec

LANE = 128


def pad_dim(dims: int) -> int:
    """Feature-dim pad target: the next LANE multiple (min one lane)."""
    return max(-(-dims // LANE) * LANE, LANE)


def prep_tokens(tokens: np.ndarray, metric: str) -> np.ndarray:
    """Metric-prep token rows: cosine normalizes per token (zero tokens
    stay zero), dot_product passes through."""
    mat = np.asarray(tokens, dtype=np.float32)
    if metric == "cosine" and mat.size:
        norms = np.linalg.norm(mat, axis=-1, keepdims=True)
        mat = mat / np.maximum(norms, 1e-30)
    return mat


def pool_doc(tokens_prepped: np.ndarray, metric: str) -> np.ndarray:
    """One doc's coarse-phase centroid: mean of its prepped tokens,
    re-normalized for cosine so the coarse corpus holds unit rows."""
    pooled = tokens_prepped.mean(axis=0).astype(np.float32)
    if metric == "cosine":
        pooled = pooled / max(float(np.linalg.norm(pooled)), 1e-30)
    return pooled


def encode_tokens(tokens_prepped: np.ndarray, encoding: str, dims: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Codec-encode prepped token rows at the lane-padded width:
    (data [T, W] packed, scales [T] f32). Tokens encode independently, so
    concatenating blocks is byte-identical to encoding the concatenation."""
    d_pad = pad_dim(dims)
    mat = np.asarray(tokens_prepped, dtype=np.float32)
    if mat.ndim != 2:
        mat = mat.reshape(-1, dims)
    if d_pad != dims:
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], d_pad - dims), dtype=np.float32)],
            axis=1)
    enc = quant_codec.get(encoding).encode_np(mat)
    return enc.data, enc.scales


def decode_tokens(data: np.ndarray, scales: np.ndarray, encoding: str,
                  dims: int) -> np.ndarray:
    """Host decode twin: [T, dims] f32 (lane padding stripped)."""
    full = quant_codec.get(encoding).decode_np(data, scales)
    return np.asarray(full, dtype=np.float32)[:, :dims]


def packed_width(encoding: str, dims: int) -> int:
    """Packed columns per token row at the lane-padded width."""
    return quant_codec.get(encoding).packed_width(pad_dim(dims))


def bytes_per_doc(encoding: str, dims: int, avg_tokens: float) -> int:
    """Resident token-block bytes per doc at `avg_tokens` tokens: the
    encoded rows + per-token scales + the f32 pooled centroid."""
    codec = quant_codec.get(encoding)
    per_token = codec.row_bytes(pad_dim(dims)) + 4
    return int(round(avg_tokens * per_token)) + dims * 4
