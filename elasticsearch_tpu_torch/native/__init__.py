"""ctypes bindings for the host hot loops of the lexical path (port of
`bm25_score`, `intersect_sorted`, `union_sum` and `topk` of
`elasticsearch_tpu/native/__init__.py`).

The C source is the port's own copy, `csrc/es_native.cc`. It is compiled
by `g++` with the reference's flags (`-O3 -fPIC -shared -std=c++17`, so no
FMA contraction and the same f32 roundings) at first use, into
`build/native/` at the root of the checkout; the library's name carries a
hash of the source and the flags, so an edited source never loads a stale
build. Every binding keeps the reference's numpy fallback for a host
without a compiler: that is the reference's own host behaviour, not a
device fallback. `AVAILABLE` says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "es_native.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_lock = threading.Lock()
AVAILABLE = False


def _target() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libes_native-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found for csrc/es_native.cc")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, AVAILABLE, _load_attempted
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib     # a failed build is not retried per call
        _load_attempted = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.es_bm25_score.argtypes = [i32p, f32p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float, f32p]
        lib.es_bm25_score.restype = None
        lib.es_intersect_i64.argtypes = [i64p, ctypes.c_int64, i64p,
                                         ctypes.c_int64, i64p, i64p]
        lib.es_intersect_i64.restype = ctypes.c_int64
        lib.es_union_sum_i64.argtypes = [i64p, f32p, ctypes.c_int64, i64p,
                                         f32p, ctypes.c_int64, i64p, f32p]
        lib.es_union_sum_i64.restype = ctypes.c_int64
        lib.es_topk_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                    i32p]
        lib.es_topk_f32.restype = ctypes.c_int64
        _lib = lib
        AVAILABLE = True
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def bm25_score(freqs: np.ndarray, lengths: np.ndarray, idf: float,
               avg_len: float, k1: float, b: float,
               boost: float) -> np.ndarray:
    """Fused BM25 term scores for one posting list."""
    freqs = np.ascontiguousarray(freqs, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.float32)
    lib = _load()
    if lib is None:
        f = freqs.astype(np.float32)
        tf = f / (f + k1 * (1.0 - b + (b / avg_len if avg_len else 0.0)
                            * lengths))
        return (boost * idf * (k1 + 1.0) * tf).astype(np.float32)
    out = np.empty(len(freqs), dtype=np.float32)
    lib.es_bm25_score(_ptr(freqs, ctypes.c_int32),
                      _ptr(lengths, ctypes.c_float), len(freqs),
                      idf, avg_len, k1, b, boost,
                      _ptr(out, ctypes.c_float))
    return out


def intersect_sorted(a: np.ndarray, b: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Positions (ia, ib) where two sorted unique int64 arrays meet: the
    np.intersect1d(..., return_indices=True) contract."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    lib = _load()
    if lib is None:
        _, ia, ib = np.intersect1d(a, b, assume_unique=True,
                                   return_indices=True)
        return ia, ib
    cap = min(len(a), len(b))
    ia = np.empty(cap, dtype=np.int64)
    ib = np.empty(cap, dtype=np.int64)
    n = lib.es_intersect_i64(_ptr(a, ctypes.c_int64), len(a),
                             _ptr(b, ctypes.c_int64), len(b),
                             _ptr(ia, ctypes.c_int64),
                             _ptr(ib, ctypes.c_int64))
    return ia[:n], ib[:n]


def union_sum(a: np.ndarray, sa: Optional[np.ndarray],
              b: np.ndarray, sb: Optional[np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Union of sorted unique int64 row arrays, summing aligned scores on
    rows present in both (bool-should accumulation)."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    if sa is not None:
        sa = np.ascontiguousarray(sa, dtype=np.float32)
    if sb is not None:
        sb = np.ascontiguousarray(sb, dtype=np.float32)
    lib = _load()
    if lib is None:
        rows = np.union1d(a, b)
        scores = np.zeros(len(rows), dtype=np.float32)
        if sa is not None and len(a):
            scores[np.searchsorted(rows, a)] += sa
        if sb is not None and len(b):
            scores[np.searchsorted(rows, b)] += sb
        return rows, scores
    cap = len(a) + len(b)
    rows = np.empty(cap, dtype=np.int64)
    scores = np.empty(cap, dtype=np.float32)
    null_f32 = ctypes.POINTER(ctypes.c_float)()
    n = lib.es_union_sum_i64(
        _ptr(a, ctypes.c_int64),
        _ptr(sa, ctypes.c_float) if sa is not None else null_f32, len(a),
        _ptr(b, ctypes.c_int64),
        _ptr(sb, ctypes.c_float) if sb is not None else null_f32, len(b),
        _ptr(rows, ctypes.c_int64), _ptr(scores, ctypes.c_float))
    return rows[:n], scores[:n]


def topk(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best scores ordered by (score desc, index asc),
    the tie-break of the reference's shard-level merge."""
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    lib = _load()
    if lib is None:
        # full (score desc, index asc) sort: argpartition would leave the
        # boundary cut nondeterministic on ties
        order = np.lexsort((np.arange(len(scores)), -scores))
        return order[:k].astype(np.int32)
    k = min(k, len(scores))
    out = np.empty(max(k, 0), dtype=np.int32)
    n = lib.es_topk_f32(_ptr(scores, ctypes.c_float), len(scores), k,
                        _ptr(out, ctypes.c_int32))
    return out[:n]
