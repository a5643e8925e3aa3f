"""Bucket policy and kernel launch counters (port of the bucket half of
`elasticsearch_tpu/ops/dispatch.py`, with its generation row ladder).

PyTorch runs eagerly, so there is no compile cache here. The policy stays:
query batches pad to pow-2 buckets and k rounds up a fixed ladder, so a
later PR that captures CUDA graphs per bucket finds a closed shape grid.

`LAUNCHES` counts launches of each hand-written kernel; a wrapper adds one
where it launches its kernel and nowhere else, so a run shows which route
it took (`bm25_board` counts one a batch: its two launches). A kernel with more than one variant also counts each launch under
`"<kernel>/<variant>"` in `VARIANT_LAUNCHES`.

The same place feeds the thread-local event trace of a profiled search
(`record_events` ... `drain_events`, the reference's `profile.dispatch`):
an event names the reference's program (`kernel`, e.g. `knn.binned`), the
launch's shape (`bucket`) and the port's own launch (`launch`, e.g.
`knn_binned_bf16/tma`). The reference's `cache` and `compile_ms` describe
XLA's executable cache; eager PyTorch has none, so they are left out.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

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

# the reference's program of each hand kernel (a launch's `kernel` in the
# event trace); a `<kernel>/<variant>` entry wins over the kernel's own,
# and a name not listed (the `aggs.*` ops) is its own program
PROGRAMS = {
    "knn_binned_bf16": "knn.binned",
    "knn_binned_int8": "knn.binned",
    "ivf_fused_dense": "ivf.fused_probe",
    "ivf_fused_int4": "ivf.fused_probe",
    "maxsim_dense": "maxsim.rescore",
    "maxsim_int4": "maxsim.rescore",
    "bm25_board": "bm25.topk",
    "bm25_board/sparse": "sparse.topk",
}
_EVENTS = threading.local()


def count_launch(name: str, variant: Optional[str] = None,
                 bucket: Optional[str] = None) -> None:
    """Count one launch of kernel `name` (on `variant`), and append its
    event to this thread's trace when it records one. `bucket` names the
    launch's shape."""
    key = name if variant is None else f"{name}/{variant}"
    with _LAUNCH_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
        if variant is not None:
            VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1
    events = getattr(_EVENTS, "events", None)
    if events is not None:
        events.append({"kernel": PROGRAMS.get(key, PROGRAMS.get(name, name)),
                       "bucket": bucket, "launch": key})


def record_events(on: bool) -> None:
    """Start (a fresh list) or stop this thread's launch event trace (the
    `profile.dispatch` feed)."""
    _EVENTS.events = [] if on else None


def drain_events() -> List[dict]:
    """This thread's events so far (the trace keeps recording, empty)."""
    events = getattr(_EVENTS, "events", None)
    if events is None:
        return []
    _EVENTS.events = []
    return events


def events_enabled() -> bool:
    """Is THIS thread recording a launch event trace?"""
    return getattr(_EVENTS, "events", None) is not None


def event_count() -> int:
    events = getattr(_EVENTS, "events", None)
    return 0 if events is None else len(events)


def annotate_events(since: int, **fields) -> None:
    """Tag the events appended after index `since` on THIS thread's trace.
    The combining batcher labels a coalesced batch's launches
    (`coalesced_batch: N`): the runner thread launches on behalf of N
    requests, and without the tag a profiled leader's trace would claim
    the followers' launches as its own."""
    events = getattr(_EVENTS, "events", None)
    if events is None:
        return
    for e in events[since:]:
        e.update(fields)


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
