"""Continuous-batching dispatch for vector search (port of
`elasticsearch_tpu/serving/batcher.py`).

* `CombiningBatcher` — a combining-lock queue: the first thread in becomes
  the runner and executes whatever requests accumulated while the previous
  dispatch was in flight. Under load, batch size grows with the load and
  adds no idle latency (an idle submit executes immediately, no timer). On
  that base it schedules:

  - deadline-aware admission: queued requests order earliest-deadline-
    first, and a request is shed at SCHEDULE time, the moment it can no
    longer meet its deadline;
  - in-flight bucket top-up: a drained batch below its query bucket
    (`ops/dispatch.bucket_queries`) is padded to the bucket anyway, so late
    arrivals claim the free rows (within a bounded
    `target_batch_latency_ms` wait) and ride THIS dispatch;
  - pipelining: the executor is a (dispatch_fn, finalize_fn) pair; the
    runner holds the run lock only for the dispatch stage, which launches
    device work and returns without waiting for it, and finalizes (device
    wait, host post-processing) outside the lock, so the next batch's
    launch overlaps this batch's host work. `async_depth` bounds the
    batches in flight un-finalized.

  Each queue entry carries its request's telemetry context, captured
  from the submitting thread at enqueue (`telemetry.capture()`: trace,
  parent span, task), since its batch may run on another request's
  thread. A request whose task was cancelled while it sat queued is shed
  when a runner claims a batch, before any launch (`cancelled_sheds`),
  and `submit(deadline_at=)` tightens the admission deadline with a
  per-request absolute one. The batch's first traced member (its leader)
  carries the `batch.dispatch` and `batch.finalize` spans, and its other
  traced members link to them; a profiled runner's launch events of a
  coalesced batch carry `coalesced_batch: N`. The `serving.queue_wait`,
  `serving.device_dispatch` and `serving.device_sync` histograms time a
  request's wait, a batch's launch stage and its finalize stage (the
  wait on the batch's event and the host work after it); no clock read
  waits on the device.

* `BoundedBatcher` — the same plus admission control: a queue-depth limit
  that answers 429 (`EsRejectedExecutionError`) and a per-request deadline.

Left out of this port: the reference's host-vs-device `CostModel` and its
overhead probe (the port has no host kNN kernel), the compile warmup
thread (PyTorch runs eagerly) and the synchronous single-`execute`
executor (every caller here has a dispatch/finalize pair).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple

from elasticsearch_tpu_torch.common.errors import (
    EsRejectedExecutionError, TaskCancelledError,
)
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.telemetry import metrics as _metrics
from elasticsearch_tpu_torch.telemetry import thread_section as _section
from elasticsearch_tpu_torch.telemetry import trace as _tt


class _QueueEntry:
    """One queued request: payload, future, and its schedule metadata."""

    __slots__ = ("request", "fut", "enqueued", "deadline", "seq", "claimed",
                 "trace", "span_parent", "token")

    def __init__(self, request, fut: Future, enqueued: float,
                 deadline: Optional[float], seq: int):
        self.request = request
        self.fut = fut
        self.enqueued = enqueued
        self.deadline = deadline   # monotonic instant; None = never expires
        self.seq = seq             # arrival order (EDF tie-break)
        self.claimed = False       # a runner owns it (set under _q_lock)
        # the submitting thread's telemetry context: its trace (None =
        # unsampled), parent span id and task (the cancellation token: a
        # truthy `.cancelled` sheds the entry when a batch is claimed)
        self.trace, self.span_parent, self.token = _tt.capture()

    def sort_key(self) -> Tuple[float, int]:
        return (self.deadline if self.deadline is not None else float("inf"),
                self.seq)


def _fresh_sched_stats() -> dict:
    return {"batches": 0, "pipelined_batches": 0, "requests": 0,
            "topups": 0, "deadline_sheds": 0, "cancelled_sheds": 0,
            "overlap_hits": 0,
            "queue_wait_nanos": 0, "dispatch_nanos": 0,
            "finalize_nanos": 0}


class CombiningBatcher:
    """Combining-lock request coalescer with continuous-batching
    scheduling.

    submit() enqueues and then either (a) finds its result already set by
    a concurrent runner, or (b) becomes the runner: drains the queue
    earliest-deadline-first, tops the batch up to its query bucket, and
    executes it. While a runner is dispatching, later submitters queue up:
    their requests form the next batch (or top up this one). No background
    thread, no batching timer, no idle latency.

    The executor is a pair: `dispatch_fn(requests) -> handle` launches
    device work and returns without waiting for it; the runner then
    releases the run lock and `finalize_fn(handle) -> results` (device
    wait + host post-processing) runs outside it, so the next batch's
    dispatch overlaps this batch's host work. `async_depth` bounds the
    batches in flight un-finalized. A poisoned batch is retried one
    request at a time through the pair back to back, under the run lock.

    `sched` counts the scheduler's work: batches, top-ups, schedule-time
    deadline and cancellation sheds, dispatch/finalize overlap hits, and
    cumulative queue-wait / dispatch / finalize time.
    """

    def __init__(self, dispatch_fn: Callable[[Sequence], Any],
                 finalize_fn: Callable[[Any], List],
                 max_batch: int = 256, *,
                 topup: bool = True,
                 target_batch_latency_ms: float = 2.0,
                 async_depth: int = 2):
        self._dispatch_fn = dispatch_fn
        self._finalize_fn = finalize_fn
        # the batch ceiling snaps to a query bucket: a saturated drain hands
        # the executor an exactly-bucket-sized batch (no padding at peak)
        self._max_batch = dispatch.bucket_queries(max_batch)
        self._topup_enabled = bool(topup)
        self._target_ms = float(target_batch_latency_ms)
        self._run_lock = threading.Lock()
        self._q_lock = threading.Lock()
        self._q_cond = threading.Condition(self._q_lock)
        self._queue: List[_QueueEntry] = []
        self._seq = 0
        self._inflight = 0           # dispatched, not yet finalized
        self._depth_sem = threading.BoundedSemaphore(max(1, int(async_depth)))
        self._tls = threading.local()
        self.sched = _fresh_sched_stats()

    # ------------------------------------------------------------ queue
    def pending(self) -> int:
        """Requests queued but not yet claimed by a runner."""
        with self._q_lock:
            return len(self._queue)

    def load(self) -> dict:
        """Live scheduler snapshot: queued entries, in-flight batches, and
        the cumulative pressure counters (`topups`, `overlap_hits`,
        `queue_wait_nanos`) that say whether this batcher runs hot."""
        with self._q_lock:
            return {"pending": len(self._queue),
                    "inflight": self._inflight,
                    "topups": self.sched["topups"],
                    "overlap_hits": self.sched["overlap_hits"],
                    "queue_wait_nanos": self.sched["queue_wait_nanos"]}

    def _deadline_for(self, now: float) -> Optional[float]:
        """Absolute deadline for a request enqueued at `now`; None means
        it never expires (the base batcher has no admission deadline)."""
        return None

    def _admit(self, depth: int, now: float) -> None:
        """Admission hook, called under the queue lock with the current
        queue depth: subclasses refuse (raise) instead of queueing
        without bound."""

    def _enqueue(self, request, fut: Future,
                 deadline_at: Optional[float] = None) -> _QueueEntry:
        """Queue one request (admission may refuse — `_admit`). Returns the
        queue entry. `deadline_at` is a per-request absolute deadline
        (time.monotonic seconds); it tightens, never loosens, the batcher's
        own admission deadline."""
        now = time.monotonic()
        with self._q_cond:
            self._admit(len(self._queue), now)
            deadline = self._deadline_for(now)
            if deadline_at is not None:
                deadline = deadline_at if deadline is None \
                    else min(deadline, deadline_at)
            entry = _QueueEntry(request, fut, now, deadline, self._seq)
            self._seq += 1
            self._queue.append(entry)
            self._q_cond.notify_all()
        return entry

    def _shed(self, entry: _QueueEntry, now: float) -> None:
        """Schedule-time deadline shed: the request can no longer meet its
        deadline, so it is timed out NOW instead of spending device time
        on an answer nobody reads."""
        self.sched["deadline_sheds"] += 1
        if not entry.fut.done():
            waited = (now - entry.enqueued) * 1000.0
            entry.fut.set_exception(EsRejectedExecutionError(
                f"rejected execution: request spent "
                f"{waited:.0f}ms queued, over the admission deadline"))

    def _shed_cancelled(self, entry: _QueueEntry, now: float) -> None:
        """Cancellation shed: the request's task was cancelled
        (`POST _tasks/{id}/_cancel`) while it sat queued, so it leaves the
        queue as an expired deadline does, before any device time is spent
        on an answer nobody will read."""
        self.sched["cancelled_sheds"] += 1
        if entry.trace is not None:
            entry.trace.record_span(
                "queue.wait", int((now - entry.enqueued) * 1e9),
                parent_id=entry.span_parent, status="cancelled")
        if not entry.fut.done():
            entry.fut.set_exception(TaskCancelledError(
                "task cancelled while queued (shed at EDF admission)"))

    def _claim_locked(self, want: int, now: float) -> List[_QueueEntry]:
        """Take up to `want` entries off the queue, earliest deadline
        first, shedding any whose deadline has passed or whose task was
        cancelled. Caller holds `_q_lock`."""
        if not self._queue:
            return []
        # a deadline-less queue is already in seq order: skip the sort
        if any(e.deadline is not None for e in self._queue):
            self._queue.sort(key=_QueueEntry.sort_key)
        claimed: List[_QueueEntry] = []
        keep: List[_QueueEntry] = []
        for entry in self._queue:
            if entry.token is not None \
                    and getattr(entry.token, "cancelled", False):
                self._shed_cancelled(entry, now)
                continue
            if entry.deadline is not None and now > entry.deadline:
                self._shed(entry, now)
                continue
            if len(claimed) < want:
                entry.claimed = True
                wait_ns = int((now - entry.enqueued) * 1e9)
                self.sched["queue_wait_nanos"] += wait_ns
                # host writes only: safe under _q_lock
                _metrics.record("serving.queue_wait", wait_ns)
                if entry.trace is not None:
                    entry.trace.record_span("queue.wait", wait_ns,
                                            parent_id=entry.span_parent)
                claimed.append(entry)
            else:
                keep.append(entry)
        self._queue[:] = keep
        return claimed

    def _drain(self) -> List[_QueueEntry]:
        """Take the next batch off the queue (under the run lock)."""
        with self._q_lock:
            return self._claim_locked(self._max_batch, time.monotonic())

    def _topup(self, batch: List[_QueueEntry]) -> List[_QueueEntry]:
        """In-flight bucket top-up: the drained batch dispatches padded to
        `bucket_queries(len(batch))` rows anyway, so late arrivals claim
        the headroom. With a `target_batch_latency_ms` budget the runner
        briefly waits for arrivals, never past the oldest member's budget;
        an idle single query (bucket 1) never waits at all."""
        if not batch:
            return batch
        target = len(batch) + dispatch.bucket_headroom(len(batch),
                                                       self._max_batch)
        if not self._topup_enabled or len(batch) >= target:
            return batch
        oldest = min(e.enqueued for e in batch)
        budget_until = oldest + self._target_ms / 1000.0
        joined = 0
        with self._q_cond:
            while len(batch) < target:
                now = time.monotonic()
                got = self._claim_locked(target - len(batch), now)
                if got:
                    batch.extend(got)
                    joined += len(got)
                    continue
                remaining = budget_until - now
                if remaining <= 0:
                    break
                self._q_cond.wait(min(remaining, 0.0005))
        if joined:
            self.sched["topups"] += joined
        return batch

    # ------------------------------------------------------------ serving
    @staticmethod
    def _check_results(batch: List[_QueueEntry], results: List) -> None:
        if len(results) != len(batch):
            raise RuntimeError(
                f"batch executor returned {len(results)} results "
                f"for {len(batch)} requests")

    def _set_results(self, batch: List[_QueueEntry], results: List) -> None:
        self._check_results(batch, results)
        for entry, res in zip(batch, results):
            entry.fut.set_result(res)

    def _retry_serially(self, batch: List[_QueueEntry], exc: Exception):
        """One poisoned request (a bad vector, say) must not fail the
        requests that coalesced with it: retry each alone, so only the
        offender gets its error."""
        if len(batch) == 1:
            if not batch[0].fut.done():
                batch[0].fut.set_exception(exc)
            return
        for entry in batch:
            if entry.fut.done():
                continue
            try:
                entry.fut.set_result(self._finalize_fn(
                    self._dispatch_fn([entry.request]))[0])
            except Exception as one_exc:
                entry.fut.set_exception(one_exc)

    @staticmethod
    def _trace_leader(batch: List[_QueueEntry]) -> Optional[_QueueEntry]:
        """The batch's trace LEADER: its first member with a sampled
        trace, which carries the batch-level spans; other traced members
        (followers) link to them instead of claiming device time the whole
        batch shared."""
        for entry in batch:
            if entry.trace is not None:
                return entry
        return None

    def _trace_batch(self, batch: List[_QueueEntry], name: str,
                     dur_ns: int, status: str = "ok") -> None:
        """Record one batch-stage span on the leader's trace and link every
        traced follower to it. Retroactive: the duration was measured
        already."""
        leader = self._trace_leader(batch)
        if leader is None:
            return
        span_id = leader.trace.record_span(
            name, dur_ns, parent_id=leader.span_parent, status=status,
            coalesced=len(batch))
        for entry in batch:
            if entry.trace is not None and entry is not leader:
                entry.trace.add_link(leader.trace.trace_id, span_id,
                                     "coalesced_follower")

    @staticmethod
    def _trace_since(batch: List[_QueueEntry]) -> Optional[int]:
        """Where this batch's launch events start in the runner thread's
        event trace, when the thread records one and the batch coalesced
        requests (else None): the runner launches for every request in the
        batch, and a profiled follower sees an empty list."""
        return (dispatch.event_count()
                if len(batch) > 1 and dispatch.events_enabled() else None)

    @staticmethod
    def _annotate(trace_since: Optional[int], n: int) -> None:
        # on every exit: a poisoned batch's serial retries run on this
        # runner thread too, and their launches are the batch's work
        if trace_since is not None:
            dispatch.annotate_events(trace_since, coalesced_batch=n)

    def _begin_pipelined(self, batch: List[_QueueEntry]):
        """Dispatch stage (under the run lock): launch the batch's device
        work without waiting for it. Returns the finalize context."""
        trace_since = self._trace_since(batch)
        self._depth_sem.acquire()   # bounds in-flight un-finalized batches
        with self._q_lock:
            if self._inflight > 0:
                # a previous batch is still finalizing on another thread
                # while this dispatch starts: the overlap the pipeline
                # exists to create
                self.sched["overlap_hits"] += 1
            self._inflight += 1
        t0 = time.perf_counter_ns()
        handle: Any = None
        err: Optional[BaseException] = None
        try:
            handle = self._dispatch_fn([e.request for e in batch])
        except Exception as exc:
            err = exc
        except BaseException as exc:
            err = exc
            for entry in batch:
                if not entry.fut.done():
                    entry.fut.set_exception(exc)
            self._end_pipelined()
            self._annotate(trace_since, len(batch))
            raise
        finally:
            dt = time.perf_counter_ns() - t0
            self.sched["dispatch_nanos"] += dt
            _metrics.record("serving.device_dispatch", dt)
            self._trace_batch(batch, "batch.dispatch", dt,
                              status="ok" if err is None else "error")
        return batch, handle, err, trace_since

    def _end_pipelined(self) -> None:
        with self._q_lock:
            self._inflight -= 1
        self._depth_sem.release()

    def _finish_pipelined(self, batch: List[_QueueEntry], handle,
                          err: Optional[Exception],
                          trace_since: Optional[int]) -> None:
        """Finalize stage (OUTSIDE the run lock): device wait + host
        post-processing, concurrent with the next batch's dispatch."""
        released = False
        t0 = time.perf_counter_ns()
        results = None

        def land_stage() -> None:
            # the stage's histogram and leader span land BEFORE any future
            # resolves: a submitter woken by set_result may finish its
            # request and ship its trace at once
            dt = time.perf_counter_ns() - t0
            with self._q_lock:   # concurrent finalizes both land here
                self.sched["finalize_nanos"] += dt
            _metrics.record("serving.device_sync", dt)
            self._trace_batch(batch, "batch.finalize", dt,
                              status="ok" if err is None else "error")

        try:
            if err is None:
                try:
                    results = self._finalize_fn(handle)
                    self._check_results(batch, results)
                except Exception as exc:
                    err = exc
                except BaseException as exc:
                    err = exc
                    land_stage()
                    for entry in batch:
                        if not entry.fut.done():
                            entry.fut.set_exception(exc)
                    raise
            land_stage()
            if err is None:
                self._set_results(batch, results)
            else:
                # serial retries run dispatch + finalize back to back
                # under the run lock, so they serialize with other
                # dispatch stages. This batch's depth slot is released
                # FIRST: a runner can block on the slot while holding the
                # run lock, so retrying while still holding it would
                # deadlock at async_depth=1.
                self._end_pipelined()
                released = True
                with self._run_lock:
                    self._retry_serially(batch, err)
        finally:
            if not released:
                self._end_pipelined()
            self._annotate(trace_since, len(batch))

    def batch_meta(self) -> dict:
        """Schedule metadata of the batch THIS thread is executing (set
        just before the executor runs): coalesced size, the longest queue
        wait among its members, and the trace leader's trace and parent
        span (for an executor's finer spans). Consumed on read, so a
        poisoned batch's serial retries on this thread do not count the
        dead batch's metadata again. Empty off a runner thread."""
        meta = getattr(self._tls, "meta", None)
        self._tls.meta = None
        return dict(meta or {})

    def _run_once(self, entry: Optional[_QueueEntry] = None) -> None:
        """One scheduler turn: drain + top up + serve a batch (if any).
        With `entry`, returns immediately once that entry is claimed or
        done instead of competing to run someone else's batch."""
        pending = None
        with self._run_lock:
            if entry is not None and (entry.fut.done() or entry.claimed):
                return
            batch = self._drain()
            if batch:
                batch = self._topup(batch)
            if not batch:
                return
            self.sched["batches"] += 1
            self.sched["requests"] += len(batch)
            now = time.monotonic()
            leader = self._trace_leader(batch)
            self._tls.meta = {
                "coalesced": len(batch),
                "queue_wait_max_nanos": int(max(
                    (now - e.enqueued) for e in batch) * 1e9),
                "trace": leader.trace if leader is not None else None,
                "trace_parent": (leader.span_parent
                                 if leader is not None else None)}
            self.sched["pipelined_batches"] += 1
            # name the sections on the borrowed runner thread, so a stack
            # sampler attributes its time to the batcher
            with _section("batcher-drain"):
                pending = self._begin_pipelined(batch)
        if pending is not None:
            with _section("batcher-finalize"):
                self._finish_pipelined(*pending)

    def submit(self, request, deadline_at: Optional[float] = None):
        """Serve one request; `deadline_at` (time.monotonic seconds) sheds
        it if no runner claims it by then."""
        fut: Future = Future()
        entry = self._enqueue(request, fut, deadline_at=deadline_at)
        while not fut.done():
            if entry.claimed:
                # a runner owns this request; its finalize (possibly on
                # another thread) sets the future
                break
            # block until the current runner releases the run lock, then
            # take over if this request still is not scheduled
            self._run_once(entry)
        return fut.result()


class BoundedBatcher(CombiningBatcher):
    """CombiningBatcher + admission control: overload is shed as HTTP 429
    instead of queueing into the tail.

    * depth limit — a submit that finds `max_queue_depth` requests already
      waiting is rejected immediately with `EsRejectedExecutionError`;
    * deadline — every request carries `enqueue + deadline_ms` as its
      schedule deadline: the queue orders earliest-deadline-first and the
      scheduler sheds a request the moment it can no longer be served in
      time (at drain AND during top-up claims).

    `stats` counts shed requests and the high-water queue depth.
    """

    def __init__(self, dispatch_fn: Callable[[Sequence], Any],
                 finalize_fn: Callable[[Any], List],
                 max_batch: int = 256, max_queue_depth: int = 256,
                 deadline_ms: Optional[float] = None, **kwargs):
        super().__init__(dispatch_fn, finalize_fn, max_batch=max_batch,
                         **kwargs)
        self.max_queue_depth = max_queue_depth
        self.deadline_ms = deadline_ms
        self.stats = {"accepted": 0, "rejected_depth": 0,
                      "shed_deadline": 0, "shed_cancelled": 0,
                      "max_depth_seen": 0}

    def _deadline_for(self, now: float) -> Optional[float]:
        if self.deadline_ms is None:
            return None
        return now + self.deadline_ms / 1000.0

    def _shed(self, entry: _QueueEntry, now: float) -> None:
        self.stats["shed_deadline"] += 1
        self.sched["deadline_sheds"] += 1
        if not entry.fut.done():
            waited = (now - entry.enqueued) * 1000.0
            entry.fut.set_exception(EsRejectedExecutionError(
                f"rejected execution: request spent "
                f"{waited:.0f}ms queued, over the "
                f"{self.deadline_ms:.0f}ms admission deadline"))

    def _shed_cancelled(self, entry: _QueueEntry, now: float) -> None:
        self.stats["shed_cancelled"] += 1
        super()._shed_cancelled(entry, now)

    def _admit(self, depth: int, now: float) -> None:
        if depth >= self.max_queue_depth:
            self.stats["rejected_depth"] += 1
            raise EsRejectedExecutionError(
                f"rejected execution: hybrid search queue is full "
                f"[{depth} >= {self.max_queue_depth}] (queue capacity "
                f"{self.max_queue_depth})")
        self.stats["accepted"] += 1
        if depth + 1 > self.stats["max_depth_seen"]:
            self.stats["max_depth_seen"] = depth + 1
