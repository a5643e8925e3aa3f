"""The port's request telemetry (`elasticsearch_tpu_torch/telemetry/`,
`node_admin.py`, the batcher's telemetry) against the reference's on the
CPU: the histogram math on the same seeded durations, a scripted trace
(spans, links, sampling) giving the same span tree and `top_spans`, the
task manager's errors word for word, and the combining batcher's
cancellation shed, per-request deadline and coalesced-batch trace through
both modules with the same scripted executor."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from elasticsearch_tpu import node_admin as ref_admin
from elasticsearch_tpu.serving import batcher as ref_batcher
from elasticsearch_tpu.telemetry import metrics as ref_metrics
from elasticsearch_tpu.telemetry import trace as ref_trace
from elasticsearch_tpu_torch import node_admin as port_admin
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.serving import batcher as port_batcher
from elasticsearch_tpu_torch.telemetry import metrics as port_metrics
from elasticsearch_tpu_torch.telemetry import trace as port_trace

WAIT = 10.0


def _durations(seed: int, n: int) -> list:
    """Seeded nanosecond durations over many log2 buckets, with 0, 1 and
    exact powers of two among them."""
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.uniform(0, 40, n)).astype(np.int64).tolist()
    return vals + [0, 1, 2, 1024, 1025, -5, 1 << 40]


HIST_CASES = [("bucket_index", seed) for seed in range(3)] + [
    ("percentile", seed) for seed in range(3)] + [
    ("snapshot", seed) for seed in range(3)]


@pytest.mark.parametrize("kind,seed", HIST_CASES,
                         ids=[f"{k}-{s}" for k, s in HIST_CASES])
def test_histogram_math_matches_reference(kind, seed):
    vals = _durations(seed, 500)
    if kind == "bucket_index":
        got = [port_metrics.bucket_index(v) for v in vals]
        assert got == [ref_metrics.bucket_index(v) for v in vals]
        assert [port_metrics.bucket_upper_ns(i) for i in range(64)] == \
            [ref_metrics.bucket_upper_ns(i) for i in range(64)]
    elif kind == "percentile":
        counts = np.random.default_rng(seed).integers(
            0, 50, port_metrics.N_BUCKETS).tolist()
        for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert port_metrics.percentile_from_counts(counts, q) == \
                ref_metrics.percentile_from_counts(counts, q)
        assert port_metrics.percentile_from_counts([0] * 64, 0.5) == 0.0
    else:
        regs = (port_metrics.MetricsRegistry(),
                ref_metrics.MetricsRegistry())
        for reg in regs:
            for v in vals:
                reg.histogram("serving.queue_wait").record(v)
            reg.counter("c").inc(3)
            reg.gauge("serving.inflight_dispatches").inc()
            reg.gauge("serving.inflight_dispatches").dec(0.5)
        assert regs[0].snapshot(raw=True) == regs[1].snapshot(raw=True)
        regs[0].reset()
        assert regs[0].snapshot() == {"counters": {}, "gauges": {},
                                      "histograms": {}}


def _script_trace(mod) -> dict:
    """One scripted tracer run: head sampling one in four over 10
    requests, then a forced trace with live and retroactive spans under
    the thread context, a link, an error span, and the ring's view."""
    tracer = mod.Tracer(sample_rate=0.25, ring_size=3)
    sampled = [tracer.start("a", "n0") is not None for _ in range(10)]
    tr = tracer.start("indices:data/read/search", "n0", forced=True,
                      opaque_id="op-1")
    with mod.use(trace=tr):
        mod.record_span("rest.parse", 700)
        with mod.span("query[x]", index="x"):
            mod.record_span("queue.wait", 5_000)
            mod.record_span("batch.dispatch", 9_000, coalesced=2)
            with pytest.raises(ValueError):
                with mod.span("fetch[x]"):
                    raise ValueError("boom")
        mod.record_span("merge", 300, hits=3)
    tr.add_link("t" * 16, "s" * 16, "coalesced_follower")
    assert mod.current_trace() is None
    tracer.finish(tr)
    for _ in range(4):
        tracer.finish(tracer.start("b", "n1", forced=True))
    ids = {None: None}
    tree = []
    for sp in tr.span_dicts():
        ids[sp["span_id"]] = len(ids) - 1
        tree.append((sp["name"], ids[sp["parent_id"]], sp["status"],
                     sp.get("attrs")))
    top = [(s["name"], s["dur_ns"]) for s in tr.top_spans(3)
           if s["name"] in ("queue.wait", "batch.dispatch", "rest.parse",
                            "merge")]
    return {"sampled": sampled, "tree": tree, "top": top,
            "links": tr.links, "snapshot": tracer.snapshot(),
            "ring_nodes": [t["node"] for t in tracer.traces()],
            "n0": len(tracer.traces(node_id="n0")),
            "dict_keys": sorted(tr.to_dict())}


def test_trace_tree_matches_reference():
    got, want = _script_trace(port_trace), _script_trace(ref_trace)
    assert got == want
    assert got["sampled"].count(True) == 2
    assert got["snapshot"]["ring"] == 3


def test_sampling_settings_only_explicit_ones_reconfigure():
    from elasticsearch_tpu_torch import telemetry
    tracer = port_trace.TRACER
    before = tracer.sample_rate, tracer._ring.maxlen
    try:
        telemetry.configure_from_settings(
            {"telemetry.tracing.sample_rate": "0.5",
             "telemetry.traces.ring_size": 7})
        assert (tracer.sample_rate, tracer._ring.maxlen) == (0.5, 7)
        telemetry.configure_from_settings({})
        assert (tracer.sample_rate, tracer._ring.maxlen) == (0.5, 7)
    finally:
        tracer.configure(sample_rate=before[0], ring_size=before[1])


def _task_errors(mod, node_id: str) -> list:
    tm = mod.TaskManager(node_id)
    a = tm.register("indices:data/read/search", description="indices[a]",
                    opaque_id="op-7")
    b = tm.register("indices:data/write/bulk", cancellable=False)
    out = [sorted(t.task_id for t in tm.list_tasks("indices:data/read/*")),
           sorted(a.to_dict(node_id)), a.to_dict(node_id)["headers"]]
    for call, arg in ((tm.get, f"{node_id}:99"), (tm.get, "other:1"),
                      (tm.cancel, b.task_id)):
        with pytest.raises(Exception) as e:
            call(arg)
        out.append((type(e.value).__name__, e.value.status,
                    e.value.to_dict()))
    assert tm.cancel(a.task_id).cancelled
    tm.unregister(a)
    out.append([t.task_id for t in tm.list_tasks()])
    return out


def test_task_manager_errors_match_reference():
    assert _task_errors(port_admin, "nodeA") == \
        _task_errors(ref_admin, "nodeA")


# ------------------------------------------------------------- the batcher

def _make(mod, dispatch_fn, finalize_fn):
    if mod is ref_batcher:
        return mod.CombiningBatcher(None, dispatch_fn=dispatch_fn,
                                    finalize_fn=finalize_fn)
    return mod.CombiningBatcher(dispatch_fn, finalize_fn)


def _outcome(fut: Future):
    try:
        return ("ok", fut.result(timeout=WAIT))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("error", type(e).__name__, getattr(e, "status", None),
                e.to_dict() if hasattr(e, "to_dict") else str(e))


def _sched(b) -> dict:
    return {k: v for k, v in b.sched.items() if not k.endswith("_nanos")}


def _wait_until(pred) -> None:
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


class _Token:
    cancelled = False


def cancelled_while_queued(mods) -> dict:
    """A runner holds the batch lock; a request queued under a task that
    is cancelled before any runner claims it is shed, never dispatched."""
    mod, tmod, _ = mods
    dispatched = []
    gate, started = threading.Event(), threading.Event()

    def dispatch_fn(reqs):
        dispatched.append(list(reqs))
        if reqs == ["first"]:
            started.set()
            gate.wait(WAIT)
        return list(reqs)

    b = _make(mod, dispatch_fn, lambda h: [f"ok:{r}" for r in h])
    token = _Token()
    futs = {"first": Future(), "queued": Future()}

    def run(name, task):
        with tmod.use(task=task):
            try:
                futs[name].set_result(b.submit(name))
            except Exception as e:  # noqa: BLE001
                futs[name].set_exception(e)

    t1 = threading.Thread(target=run, args=("first", None))
    t1.start()
    assert started.wait(WAIT)
    t2 = threading.Thread(target=run, args=("queued", token))
    t2.start()
    _wait_until(lambda: b.pending() == 1)
    token.cancelled = True
    gate.set()
    for t in (t1, t2):
        t.join(WAIT)
    return {"dispatched": dispatched,
            "outcomes": {n: _outcome(f) for n, f in futs.items()},
            "sched": _sched(b)}


def expired_deadline_at(mods) -> dict:
    """`submit(deadline_at=)` in the past: shed at the claim, no
    dispatch; a deadline in the future serves."""
    mod = mods[0]
    dispatched = []
    b = _make(mod, lambda reqs: dispatched.append(list(reqs)) or list(reqs),
              list)
    futs = {}
    for name, at in (("late", time.monotonic() - 1.0),
                     ("fine", time.monotonic() + 60.0)):
        fut = Future()
        try:
            fut.set_result(b.submit(name, deadline_at=at))
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)
        futs[name] = fut
    out = {n: _outcome(f) for n, f in futs.items()}
    # the shed's message names its measured wait (0ms here)
    return {"dispatched": dispatched, "outcomes": out, "sched": _sched(b)}


def coalesced_trace(mods) -> dict:
    """Three traced requests queue behind a runner and coalesce: the
    first of them (the leader) gets the batch's dispatch and finalize
    spans with `coalesced: 3`, the other two a link to each."""
    mod, tmod, _ = mods
    gate, started = threading.Event(), threading.Event()

    def dispatch_fn(reqs):
        if reqs == ["warm"]:
            started.set()
            gate.wait(WAIT)
        return list(reqs)

    b = _make(mod, dispatch_fn, list)
    tracer = tmod.Tracer(sample_rate=0.0)
    traces = {}

    def run(name, traced):
        tr = tracer.start("search", "n0", forced=True) if traced else None
        traces[name] = tr
        with tmod.use(trace=tr):
            b.submit(name)

    threads = [threading.Thread(target=run, args=("warm", False))]
    threads[0].start()
    assert started.wait(WAIT)
    for i, name in enumerate(("a", "b", "c")):
        threads.append(threading.Thread(target=run, args=(name, True)))
        threads[-1].start()
        _wait_until(lambda i=i: b.pending() == i + 1)
    gate.set()
    for t in threads:
        t.join(WAIT)
    out = {}
    for name in ("a", "b", "c"):
        spans = traces[name].span_dicts()
        out[name] = {
            "spans": sorted((s["name"], s["status"],
                             (s.get("attrs") or {}).get("coalesced"))
                            for s in spans[1:]),
            "links": [(ln["reason"], ln["trace_id"] == traces["a"].trace_id)
                      for ln in traces[name].links]}
    return {"traces": out, "sched": _sched(b)}


BATCHER_SCENARIOS = [cancelled_while_queued, expired_deadline_at,
                     coalesced_trace]
MODS = {"reference": (ref_batcher, ref_trace, ref_metrics),
        "port": (port_batcher, port_trace, port_metrics)}


@pytest.mark.parametrize("scenario", BATCHER_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_batcher_telemetry_matches_reference(scenario):
    got = {name: scenario(mods) for name, mods in MODS.items()}
    assert got["port"] == got["reference"]
    port = got["port"]
    if scenario is cancelled_while_queued:
        assert port["dispatched"] == [["first"]]
        assert port["sched"]["cancelled_sheds"] == 1
        assert port["outcomes"]["queued"] == (
            "error", "TaskCancelledError", 400,
            {"type": "task_cancelled_exception",
             "reason": "task cancelled while queued (shed at EDF "
                       "admission)"})
    elif scenario is expired_deadline_at:
        assert port["dispatched"] == [["fine"]]
        assert port["sched"]["deadline_sheds"] == 1
        assert port["outcomes"]["late"][2] == 429
    else:
        assert port["sched"]["batches"] == 2
        assert ("batch.dispatch", "ok", 3) in port["traces"]["a"]["spans"]
        assert port["traces"]["b"]["links"] == \
            [("coalesced_follower", True)] * 2


def test_batcher_histograms_count_requests_and_batches():
    """`serving.queue_wait` records one a claimed request,
    `serving.device_dispatch` and `serving.device_sync` one a batch (the
    reference's histograms, on the port's process-wide registry)."""
    port_metrics.REGISTRY.reset()
    gate, started = threading.Event(), threading.Event()

    def dispatch_fn(reqs):
        if reqs == [0]:
            started.set()
            gate.wait(WAIT)
        return list(reqs)

    b = port_batcher.CombiningBatcher(dispatch_fn, list)
    threads = [threading.Thread(target=b.submit, args=(0,))]
    threads[0].start()
    assert started.wait(WAIT)
    for i in range(1, 6):
        threads.append(threading.Thread(target=b.submit, args=(i,)))
        threads[-1].start()
    _wait_until(lambda: b.pending() == 5)
    gate.set()
    for t in threads:
        t.join(WAIT)
    snap = port_metrics.snapshot()["histograms"]
    assert snap["serving.queue_wait"]["count"] == b.sched["requests"] == 6
    for name in ("serving.device_dispatch", "serving.device_sync"):
        assert snap[name]["count"] == b.sched["batches"] == 2
        assert snap[name]["p50_nanos"] > 0


def test_coalesced_launch_events_are_annotated():
    """A runner thread that records launch events labels the launches of
    a coalesced batch with its size; a batch of one stays unlabelled."""
    gate, started = threading.Event(), threading.Event()

    def dispatch_fn(reqs):
        if reqs == ["warm"]:
            started.set()
            gate.wait(WAIT)
        dispatch.count_launch("knn_binned_bf16", "tma", f"q{len(reqs)}")
        return list(reqs)

    b = port_batcher.CombiningBatcher(dispatch_fn, list)
    events = {}

    def run(name, record):
        if record:
            dispatch.record_events(True)
        try:
            b.submit(name)
        finally:
            events[name] = dispatch.drain_events()
            dispatch.record_events(False)

    threads = [threading.Thread(target=run, args=("warm", True))]
    threads[0].start()
    assert started.wait(WAIT)
    for name in ("x", "y"):
        threads.append(threading.Thread(target=run, args=(name, True)))
        threads[-1].start()
    _wait_until(lambda: b.pending() == 2)
    gate.set()
    for t in threads:
        t.join(WAIT)
    assert events["warm"] == [{"kernel": "knn.binned", "bucket": "q1",
                               "launch": "knn_binned_bf16/tma"}]
    runner = [e for name in ("x", "y") for e in events[name]]
    assert runner == [{"kernel": "knn.binned", "bucket": "q2",
                       "launch": "knn_binned_bf16/tma",
                       "coalesced_batch": 2}]
    assert not dispatch.events_enabled()
