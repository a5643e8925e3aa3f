"""Request telemetry: traces, metrics, live tasks (port of
`elasticsearch_tpu/telemetry/`).

* `telemetry.trace`: every search and write request gets a trace
  (sampled by `telemetry.tracing.sample_rate`, forced by `?trace=true` or
  a `profile` body) whose spans cover REST parse, the batcher's queue
  wait, the batch's dispatch and its device wait at finalize, query,
  fetch and merge. Completed traces land in a bounded ring
  (`GET _nodes/traces`).
* `telemetry.metrics`: process-wide counters, gauges and log2-bucket
  latency histograms; `GET _nodes/stats/telemetry` reports live
  p50/p90/p99/p999 of end-to-end search latency, queue wait and device
  dispatch / sync.
* the tasks binding below: `rest_request` registers every instrumented
  REST request with the node's `TaskManager` (action, opaque id, trace
  id, current span); `GET _tasks` lists them live, and `POST
  _tasks/{id}/_cancel` flips the task's `cancelled` flag, which the
  combining batcher's queue observes when it claims a batch (a cancelled
  entry is shed as an expired deadline is, before any launch).

`X-Opaque-ID` threads through all three: the REST layer reads the header
once, and it travels on the task and the trace.

Settings (node-level; process-wide like the launch counters: only an
explicit setting reconfigures, so a second in-process node without one
never changes an earlier node's choice):

    telemetry.tracing.sample_rate   head-sampling rate (default 0.01)
    telemetry.traces.ring_size      completed-trace ring bound (256)
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from elasticsearch_tpu_torch.telemetry import metrics
from elasticsearch_tpu_torch.telemetry import trace as trace_mod
from elasticsearch_tpu_torch.telemetry.metrics import REGISTRY
from elasticsearch_tpu_torch.telemetry.trace import (
    TRACER,
    Trace,
    capture,
    current_span_id,
    current_task,
    current_trace,
    record_span,
    span,
    use,
)

__all__ = [
    "metrics", "trace_mod", "REGISTRY", "TRACER", "Trace",
    "capture", "current_span_id", "current_task", "current_trace",
    "record_span", "span", "use", "rest_request",
    "configure_from_settings", "thread_section",
]


def configure_from_settings(settings: Optional[dict]) -> None:
    """Wire `telemetry.*` node settings into the process-wide tracer.
    Explicit settings only: absent keys leave the current (possibly
    earlier-node-configured) policy untouched."""
    s = settings or {}
    rate = s.get("telemetry.tracing.sample_rate")
    ring = s.get("telemetry.traces.ring_size")
    if rate is not None:
        TRACER.configure(sample_rate=float(rate))
    if ring is not None:
        TRACER.configure(ring_size=int(ring))


@contextmanager
def rest_request(node, action: str, *, opaque_id: Optional[str] = None,
                 force_trace: bool = False, description: str = "",
                 parse_nanos: int = 0):
    """Instrument one REST request end to end: register a live task
    (visible in `GET _tasks`, cancellable out of the batcher queue), open
    a trace when sampled or forced, and install both on the thread so
    every layer below (batcher entries, the query phase) can see them.
    Yields the Trace (or None when unsampled)."""
    tracer = TRACER
    tr = tracer.start(action, node_id=getattr(node, "node_id", "?"),
                      forced=force_trace, opaque_id=opaque_id)
    if tr is not None and parse_nanos:
        tr.record_span("rest.parse", parse_nanos,
                       parent_id=tr.root.span_id)
    tasks = getattr(node, "tasks", None)
    task = None
    if tasks is not None:
        task = tasks.register(action, description=description,
                              opaque_id=opaque_id, trace=tr)
    try:
        with use(trace=tr, task=task):
            yield tr
    except BaseException:
        if tr is not None:
            tracer.finish(tr, status="error")
            tr = None
        raise
    finally:
        if task is not None:
            tasks.unregister(task)
        if tr is not None:
            tracer.finish(tr)


@contextmanager
def thread_section(section: str):
    """Tag the current thread's name with the serving section it is
    executing (`»batcher-drain`, `»batcher-finalize`) for the duration of
    the block, so a stack sampler attributes a busy stack to its subsystem
    even when the work runs on a borrowed submitter thread (the combining
    batcher has no threads of its own: the first submitter in becomes the
    runner). One string assignment each way."""
    t = threading.current_thread()
    prev = t.name
    t.name = f"{prev}»{section}"
    try:
        yield
    finally:
        t.name = prev
