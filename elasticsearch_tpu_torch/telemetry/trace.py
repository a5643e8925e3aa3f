"""Request tracing: spans, the per-node trace ring, thread context (port of
`elasticsearch_tpu/telemetry/trace.py`).

One trace follows ONE request across the layers it crosses (REST parse,
queue wait, the batch's dispatch and its device wait at finalize, query,
fetch and merge) and lands, completed, in a bounded ring served by
`GET _nodes/traces`. Design constraints, in order:

* no device syncs: spans never force a device read. Live spans read
  `time.monotonic_ns()` around host work; device time is attributed from
  durations the serving code already measures at its existing wait points
  (`record_span(name, dur_ns)` is retroactive).
* survives the pipelined batcher: a request's dispatch and finalize may
  run on another request's thread, so context travels on the queue entry
  (captured at enqueue from the submitting thread), not on thread-locals
  alone. A request coalesced into another request's batch does NOT claim
  the batch's device time: the batch LEADER's trace carries the
  dispatch / finalize spans, and followers carry a link
  `{trace_id, span_id, reason: coalesced_follower}` to them.

Sampling: `telemetry.tracing.sample_rate` picks every round(1/rate)-th
request deterministically (a counter, not an RNG: reproducible in tests);
`?trace=true` or a `profile` body forces a trace regardless.

The reference's remote trace segments (`start_remote`, `absorb`) wait for
the cross-node fan-out, which is not ported.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

DEFAULT_SAMPLE_RATE = 0.01
DEFAULT_RING_SIZE = 256


# span and trace ids need only be unique within a ring: 64 bits from a
# process-local generator (seeded from the OS), where the reference's
# `uuid4().hex[:16]` reads the OS's entropy at every call and was most of
# a traced request's host cost (~5 µs an id, ~9 ids a request)
_IDS = random.Random()


def _new_id() -> str:
    return f"{_IDS.getrandbits(64):016x}"


class Span:
    __slots__ = ("span_id", "parent_id", "name", "start_ns", "dur_ns",
                 "status", "attrs")

    def __init__(self, name: str, parent_id: Optional[str],
                 start_ns: int, attrs: Optional[dict] = None):
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.dur_ns: Optional[int] = None   # None = still open
        self.status = "ok"
        self.attrs = attrs or {}

    def to_dict(self) -> dict:
        out = {"span_id": self.span_id, "parent_id": self.parent_id,
               "name": self.name, "start_ns": self.start_ns,
               "dur_ns": self.dur_ns, "status": self.status}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class Trace:
    """One request's trace. Spans append under a lock: the pipelined
    batcher legitimately writes from several threads (submit thread,
    runner thread, finalize thread)."""

    __slots__ = ("trace_id", "node_id", "action", "opaque_id", "forced",
                 "root", "spans", "links", "started_ns", "took_ns",
                 "_open", "_lock")

    def __init__(self, action: str, node_id: str,
                 opaque_id: Optional[str] = None, forced: bool = False,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        self.trace_id = trace_id or _new_id()
        self.node_id = node_id
        self.action = action
        self.opaque_id = opaque_id
        self.forced = forced
        self.spans: List[Span] = []
        self.links: List[dict] = []
        self.started_ns = time.monotonic_ns()
        self.took_ns: Optional[int] = None
        self._open: Dict[str, str] = {}   # span_id -> name (insertion order)
        self._lock = threading.Lock()
        self.root = self.begin_span(action, parent_id=parent_span_id)

    # ----------------------------------------------------------- live spans
    def begin_span(self, name: str, parent_id: Optional[str] = None,
                   **attrs) -> Span:
        """Open a live span NOW. Every begin_span must reach `end_span`
        on all paths (the `span()` context manager, or try/finally)."""
        sp = Span(name, parent_id, time.monotonic_ns(), attrs or None)
        with self._lock:
            self.spans.append(sp)
            self._open[sp.span_id] = name
        return sp

    def end_span(self, sp: Span, status: Optional[str] = None) -> None:
        if sp.dur_ns is None:
            sp.dur_ns = time.monotonic_ns() - sp.start_ns
        if status is not None:
            sp.status = status
        with self._lock:
            self._open.pop(sp.span_id, None)

    # ---------------------------------------------------- retroactive spans
    def record_span(self, name: str, dur_ns: int,
                    parent_id: Optional[str] = None,
                    status: str = "ok", **attrs) -> str:
        """Attach an already-measured duration as a closed span — the
        zero-host-sync path for device-adjacent attribution: the serving
        code measured `dur_ns` at a sync point that already exists, and
        the span is born finished (it can never leak)."""
        sp = Span(name, parent_id, time.monotonic_ns() - max(int(dur_ns), 0),
                  attrs or None)
        sp.dur_ns = max(int(dur_ns), 0)
        sp.status = status
        with self._lock:
            self.spans.append(sp)
        return sp.span_id

    def add_link(self, trace_id: str, span_id: str, reason: str) -> None:
        """Reference a span in ANOTHER trace without claiming its time —
        the coalesced-follower shape: the leader's trace carries the
        batch's device spans, followers carry this link."""
        with self._lock:
            self.links.append({"trace_id": trace_id, "span_id": span_id,
                               "reason": reason})

    # ------------------------------------------------------------ rendering
    def current_span_name(self) -> Optional[str]:
        """Name of the most recently opened, still-open span — what the
        tasks API shows as `current_span` for an in-flight request."""
        with self._lock:
            name = None
            for name in self._open.values():
                pass
            return name

    def span_dicts(self) -> List[dict]:
        with self._lock:
            return [sp.to_dict() for sp in self.spans]

    def top_spans(self, n: int = 3) -> List[dict]:
        """The n longest CLOSED spans (root excluded): where THIS request
        spent its time (`profile.trace`)."""
        with self._lock:
            closed = [sp for sp in self.spans
                      if sp.dur_ns is not None and sp is not self.root]
        closed.sort(key=lambda sp: -(sp.dur_ns or 0))
        return [{"name": sp.name, "dur_ns": sp.dur_ns,
                 **({"node": sp.attrs["node"]} if "node" in sp.attrs
                    else {})}
                for sp in closed[:n]]

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "node": self.node_id,
                "action": self.action, "opaque_id": self.opaque_id,
                "forced": self.forced, "took_ns": self.took_ns,
                "spans": self.span_dicts(),
                "links": list(self.links)}


class Tracer:
    """Sampling decisions + the bounded completed-trace ring.

    Process-wide (`TRACER`), like the launch counters: with several nodes
    in one process each trace carries the node_id it completed on, and the
    ring filters per node at read time."""

    def __init__(self, sample_rate: float = DEFAULT_SAMPLE_RATE,
                 ring_size: int = DEFAULT_RING_SIZE):
        self._lock = threading.Lock()
        self._sample_every = self._every(sample_rate)
        self.sample_rate = sample_rate
        self._req = 0
        self._ring: deque = deque(maxlen=ring_size)
        self.stats = {"started": 0, "sampled": 0, "forced": 0,
                      "completed": 0}

    @staticmethod
    def _every(rate: float) -> int:
        if rate is None or rate <= 0.0:
            return 0
        return max(int(round(1.0 / min(float(rate), 1.0))), 1)

    def configure(self, sample_rate: Optional[float] = None,
                  ring_size: Optional[int] = None) -> None:
        with self._lock:
            if sample_rate is not None:
                self.sample_rate = float(sample_rate)
                self._sample_every = self._every(float(sample_rate))
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(int(ring_size),
                                                          1))

    def should_sample(self) -> bool:
        """Deterministic head sampling: every round(1/rate)-th request."""
        with self._lock:
            if self._sample_every <= 0:
                return False
            self._req += 1
            return self._req % self._sample_every == 0

    # ------------------------------------------------------------ lifecycle
    def start(self, action: str, node_id: str, forced: bool = False,
              opaque_id: Optional[str] = None) -> Optional[Trace]:
        """Root-trace entry (the REST layer). None = not sampled."""
        if not forced and not self.should_sample():
            return None
        with self._lock:
            self.stats["started"] += 1
            self.stats["forced" if forced else "sampled"] += 1
        return Trace(action, node_id, opaque_id=opaque_id, forced=forced)

    def finish(self, trace: Trace, status: Optional[str] = None) -> None:
        trace.end_span(trace.root, status=status)
        trace.took_ns = trace.root.dur_ns
        with self._lock:
            self.stats["completed"] += 1
            self._ring.append(trace)

    # ------------------------------------------------------------- reading
    def traces(self, node_id: Optional[str] = None,
               limit: int = 50) -> List[dict]:
        """Most-recent-first completed traces, optionally filtered to one
        node's (the per-node `_nodes/traces` view)."""
        with self._lock:
            items = list(self._ring)
        out = []
        for tr in reversed(items):
            if node_id is not None and tr.node_id != node_id:
                continue
            out.append(tr.to_dict())
            if len(out) >= max(int(limit), 1):
                break
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {**self.stats, "ring": len(self._ring),
                    "ring_size": self._ring.maxlen,
                    "sample_rate": self.sample_rate}

    def clear(self) -> None:
        """Tests/bench only."""
        with self._lock:
            self._ring.clear()
            for k in self.stats:
                self.stats[k] = 0
            self._req = 0


TRACER = Tracer()


# ---------------------------------------------------------------------------
# Thread-local request context
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    trace: Optional[Trace] = None
    span_id: Optional[str] = None
    task: Optional[Any] = None


_CTX = _Ctx()


def current_trace() -> Optional[Trace]:
    return _CTX.trace


def current_span_id() -> Optional[str]:
    return _CTX.span_id


def current_task() -> Optional[Any]:
    """The live task registered for this thread's in-flight request —
    doubles as the cancellation token the batcher queue observes (any
    object with a truthy `.cancelled` sheds at EDF admission)."""
    return _CTX.task


def capture() -> tuple:
    """Snapshot this thread's context for a cross-thread handoff (the
    queue entry / scheduler hop): (trace, parent_span_id, task)."""
    return (_CTX.trace, _CTX.span_id, _CTX.task)


@contextmanager
def use(trace: Optional[Trace] = None, span_id: Optional[str] = None,
        task: Optional[Any] = None):
    """Install a request context on this thread for the duration of the
    block (a REST handler's body)."""
    prev = (_CTX.trace, _CTX.span_id, _CTX.task)
    _CTX.trace = trace
    _CTX.span_id = span_id if span_id is not None else (
        trace.root.span_id if trace is not None else None)
    _CTX.task = task if task is not None else prev[2]
    try:
        yield
    finally:
        _CTX.trace, _CTX.span_id, _CTX.task = prev


@contextmanager
def span(name: str, **attrs):
    """Live child span under the current context; no-op (yields None)
    when this request isn't traced. The with-shape is the API on purpose:
    it cannot leak."""
    tr = _CTX.trace
    if tr is None:
        yield None
        return
    sp = tr.begin_span(name, parent_id=_CTX.span_id, **attrs)
    prev = _CTX.span_id
    _CTX.span_id = sp.span_id
    try:
        yield sp
    except BaseException:
        tr.end_span(sp, status="error")
        raise
    finally:
        tr.end_span(sp)
        _CTX.span_id = prev


def record_span(name: str, dur_ns: int, status: str = "ok",
                **attrs) -> Optional[str]:
    """Retroactive span on the current trace (None when untraced)."""
    tr = _CTX.trace
    if tr is None:
        return None
    return tr.record_span(name, dur_ns, parent_id=_CTX.span_id,
                          status=status, **attrs)
