"""Bucket policy and kernel launch counters (port of the bucket half of
`elasticsearch_tpu/ops/dispatch.py`, with its generation row ladder).

PyTorch runs eagerly, so there is no compile cache here. The policy stays:
query batches pad to pow-2 buckets and k rounds up a fixed ladder, so a
later PR that captures CUDA graphs per bucket finds a closed shape grid.

`LAUNCHES` counts launches of each hand-written kernel; a wrapper adds one
where it launches its kernel and nowhere else, so a run shows which route
it took (`bm25_board` counts one a batch: its two launches). A kernel with more than one variant also counts each launch under
`"<kernel>/<variant>"` in `VARIANT_LAUNCHES`.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# k rounds UP this ladder (then clamps to the corpus/slot count)
K_BUCKETS = (1, 4, 10, 16, 32, 64, 100, 128, 256, 512, 1024)

# query batches pad to pow-2 up to this; beyond it, to multiples of it
MAX_QUERY_BUCKET = 2048


def bucket_queries(n: int) -> int:
    """Query-count bucket: 1, 8, 16, 32, ..., MAX, then multiples of MAX.

    2..7 pad to 8: the reference measured a slow small-M gemm path on
    XLA-CPU for M in 2..7. The rungs are kept for parity with the
    reference until they are measured on the H100."""
    if n <= 1:
        return 1
    if n <= 8:
        return 8
    if n > MAX_QUERY_BUCKET:
        return -(-n // MAX_QUERY_BUCKET) * MAX_QUERY_BUCKET
    p = 8
    while p < n:
        p *= 2
    return p


def bucket_k(k: int, limit: Optional[int] = None) -> int:
    """Round k up the K_BUCKETS ladder, clamped to `limit` (corpus rows)."""
    k = max(int(k), 1)
    kb = K_BUCKETS[-1]
    for b in K_BUCKETS:
        if b >= k:
            kb = b
            break
    else:
        kb = -(-k // K_BUCKETS[-1]) * K_BUCKETS[-1]
    if limit is not None:
        kb = min(kb, int(limit))
        kb = max(kb, min(k, int(limit)))
    return kb


# generational device segments (`segments/`): a sealed generation pads its
# rows to this pow-2 ladder, which also fixes its `k` bucket and its merge
# tier (`segments/generation.py::generation_tier`). The ladder tops out at
# MAX_GEN_ROW_BUCKET (pow-2 padding of a merged base in the millions of rows
# would waste up to half the card's bytes on it); beyond, multiples of it.
GEN_ROW_BUCKET_MIN = 128          # one lane tile (ops/knn.LANE)
MAX_GEN_ROW_BUCKET = 1 << 20


def bucket_gen_rows(n: int) -> int:
    """Row bucket a generation pads to: pow-2 from GEN_ROW_BUCKET_MIN up to
    MAX_GEN_ROW_BUCKET, then multiples of the cap."""
    n = max(int(n), 1)
    if n > MAX_GEN_ROW_BUCKET:
        return -(-n // MAX_GEN_ROW_BUCKET) * MAX_GEN_ROW_BUCKET
    b = GEN_ROW_BUCKET_MIN
    while b < n:
        b *= 2
    return b


def in_gen_row_grid(n: int) -> bool:
    """True when a row count sits on the sealed-generation ladder."""
    return n >= GEN_ROW_BUCKET_MIN and n == bucket_gen_rows(n)


def bucket_headroom(n: int, max_batch: Optional[int] = None) -> int:
    """Free rows left in `n` requests' query bucket: the continuous
    batcher's top-up budget. A batch of n runs padded to
    `bucket_queries(n)` rows either way, so late arrivals up to this many
    ride it at no extra padding work. `max_batch` clamps to a caller's
    batch ceiling."""
    bucket = bucket_queries(n)
    if max_batch is not None:
        bucket = min(bucket, int(max_batch))
    return max(bucket - n, 0)


def is_query_bucket(n: int) -> bool:
    return n >= 1 and n == bucket_queries(n)


def in_k_grid(k: int, limit: Optional[int] = None) -> bool:
    """True when k sits on the ladder or equals the clamp limit."""
    return k in K_BUCKETS or (limit is not None and k == int(limit)) \
        or (k > K_BUCKETS[-1] and k % K_BUCKETS[-1] == 0)


LAUNCHES: Dict[str, int] = {}
VARIANT_LAUNCHES: Dict[str, int] = {}
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str, variant: Optional[str] = None) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
        if variant is not None:
            key = f"{name}/{variant}"
            VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def launches() -> Dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def variant_launches() -> Dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(VARIANT_LAUNCHES)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES.clear()
        VARIANT_LAUNCHES.clear()
