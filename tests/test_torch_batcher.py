"""The port's combining batcher (`elasticsearch_tpu_torch/serving/batcher.py`)
against the reference's (`elasticsearch_tpu/serving/batcher.py`): each
scenario is scripted once and run through both modules, with executors
gated by `threading.Event`, and must give the same batch sequences, the
same results and errors (by class name, HTTP status and `error.type`) and
the same `sched` / `stats` counters. The time counters (`*_nanos`) differ
by nature; they are checked for sign only.

The port keeps one executor shape, the (dispatch_fn, finalize_fn) pair, so
the reference runs in its pipelined mode here. No scenario here cancels a
task, so both modules' cancellation-shed counters must stay 0
(`tests/test_torch_telemetry.py` holds the shed itself)."""

import threading
import time
from concurrent.futures import Future

import pytest

from elasticsearch_tpu.serving import batcher as ref_batcher
from elasticsearch_tpu_torch.serving import batcher as port_batcher

MODULES = {"reference": ref_batcher, "port": port_batcher}
WAIT = 10.0
# the cancellation shed's counters, 0 in these scenarios
LEFT_OUT = ("cancelled_sheds", "shed_cancelled")


def _make(mod, cls: str, dispatch_fn, finalize_fn=list, **kwargs):
    """A batcher of `mod` over the executor pair; both modules get the
    port's default top-up window unless the scenario sets one."""
    kwargs.setdefault("target_batch_latency_ms", 2.0)
    if mod is ref_batcher:
        return getattr(mod, cls)(None, dispatch_fn=dispatch_fn,
                                 finalize_fn=finalize_fn, **kwargs)
    return getattr(mod, cls)(dispatch_fn, finalize_fn, **kwargs)


def _outcome(fut: Future):
    """A future's value, or its error as (class, status, error.type, and
    the message of an error without a status: a shed's message names its
    measured wait, which differs between runs)."""
    try:
        return ("ok", fut.result(timeout=WAIT))
    except Exception as e:  # noqa: BLE001 - the outcome is what we compare
        err_type = e.to_dict()["type"] if hasattr(e, "to_dict") else None
        return ("error", type(e).__name__, getattr(e, "status", None),
                err_type, str(e) if not hasattr(e, "status") else None)


def _counters(b) -> dict:
    """sched (and a BoundedBatcher's stats) without the time counters,
    after checking those are sane."""
    for key, val in b.sched.items():
        if key.endswith("_nanos"):
            assert val >= 0, (key, val)
    if b.sched["batches"]:
        assert b.sched["dispatch_nanos"] > 0
    out = {k: v for k, v in b.sched.items() if not k.endswith("_nanos")}
    if hasattr(b, "stats"):
        out["stats"] = dict(b.stats)
    for counts in (out, out.get("stats", {})):
        for key in LEFT_OUT:
            assert counts.pop(key, 0) == 0, key
    return out


def _wait_until(pred) -> None:
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


def _join(threads) -> None:
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()


def edf_drain(mod) -> dict:
    """Earliest deadline first; expired entries are shed at schedule time,
    the older deadline first, and the later-deadline entry still serves."""
    executed, shed_order = [], []

    def dispatch_fn(reqs):
        executed.append(list(reqs))
        return list(reqs)

    b = _make(mod, "BoundedBatcher", dispatch_fn, max_batch=1,
              deadline_ms=10_000.0)
    now = time.monotonic()
    futs = {name: Future() for name in ("far", "near", "dead_new",
                                        "dead_old")}
    entries = {name: b._enqueue(name, fut) for name, fut in futs.items()}
    for name, fut in futs.items():
        fut.add_done_callback(lambda f, name=name: shed_order.append(name)
                              if f.exception() else None)
    entries["dead_new"].deadline = now - 1.0
    entries["dead_old"].deadline = now - 2.0
    entries["near"].deadline = now + 1.0
    entries["far"].deadline = now + 100.0
    b._run_once()
    first = {"executed": [list(x) for x in executed],
             "counters": _counters(b)}
    b._run_once()
    return {"first": first, "executed": executed, "shed_order": shed_order,
            "outcomes": {n: _outcome(f) for n, f in futs.items()},
            "counters": _counters(b)}


def topup_to_bucket(mod) -> dict:
    """5 queued requests dispatch padded to bucket 8 anyway: 3 late
    arrivals within the window ride the same dispatch."""
    batches = []

    def dispatch_fn(reqs):
        batches.append(list(reqs))
        return list(reqs)

    b = _make(mod, "CombiningBatcher", dispatch_fn,
              lambda h: [r * 10 for r in h], topup=True,
              target_batch_latency_ms=2000.0)
    futs = [Future() for _ in range(8)]
    for i in range(5):
        b._enqueue(i, futs[i])

    def late():
        time.sleep(0.02)
        for i in range(5, 8):
            b._enqueue(i, futs[i])

    t = threading.Thread(target=late)
    t.start()
    b._run_once()
    _join([t])
    return {"batches": batches, "outcomes": [_outcome(f) for f in futs],
            "counters": _counters(b)}


def idle_single_never_waits(mod) -> dict:
    """A lone request has no bucket headroom (bucket 1): the top-up window
    adds no latency."""
    b = _make(mod, "CombiningBatcher", list, topup=True,
              target_batch_latency_ms=500.0)
    t0 = time.monotonic()
    got = b.submit("solo")
    assert time.monotonic() - t0 < 0.25
    return {"got": got, "counters": _counters(b)}


def coalesce_behind_runner(mod) -> dict:
    """While a runner dispatches (under the run lock), 11 submitters queue;
    they form the next batch as one."""
    batches = []
    gate, started = threading.Event(), threading.Event()

    def dispatch_fn(reqs):
        batches.append(sorted(reqs))
        if reqs == ["warm"]:
            started.set()
            gate.wait(WAIT)
        return reqs

    b = _make(mod, "CombiningBatcher", dispatch_fn,
              lambda h: [f"ok:{r}" for r in h])
    results = {}

    def run(r):
        results[r] = b.submit(r)

    threads = [threading.Thread(target=run, args=("warm",))]
    threads[0].start()
    assert started.wait(WAIT)
    for i in range(11):
        threads.append(threading.Thread(target=run, args=(i,)))
        threads[-1].start()
    _wait_until(lambda: b.pending() == 11)
    gate.set()
    _join(threads)
    return {"batches": batches, "results": results,
            "counters": _counters(b)}


def pipelined_overlap(mod) -> dict:
    """Batch 1 finalizes outside the run lock while batch 2 dispatches."""
    started, release = threading.Event(), threading.Event()

    def finalize_fn(handle):
        started.set()
        if handle == [1]:
            release.wait(WAIT)
        return [r * 10 for r in handle]

    b = _make(mod, "CombiningBatcher", list, finalize_fn, topup=False)
    results = {}

    def worker(i):
        results[i] = b.submit(i)

    t1 = threading.Thread(target=worker, args=(1,))
    t1.start()
    assert started.wait(WAIT)
    t2 = threading.Thread(target=worker, args=(2,))
    t2.start()
    _join([t2])            # batch 2 dispatched and finalized meanwhile
    during = {"results": dict(results), "overlap": b.sched["overlap_hits"],
              "inflight": b.load()["inflight"]}
    release.set()
    _join([t1])
    return {"during": during, "results": results, "counters": _counters(b)}


def _poisoned(mod, stage: str) -> dict:
    """A batch that fails in `stage` retries each request alone: only the
    offender gets the error."""
    calls = []

    def run_stage(name, reqs):
        calls.append((name, list(reqs)))
        if name == stage and "bad" in reqs:
            raise ValueError("poisoned")
        return list(reqs)

    b = _make(mod, "CombiningBatcher",
              lambda reqs: run_stage("dispatch", reqs),
              lambda h: [f"ok:{r}" for r in run_stage("finalize", h)],
              topup=False, async_depth=1)
    f_bad = Future()
    b._enqueue("bad", f_bad)
    got = b.submit("good")
    return {"got": got, "bad": _outcome(f_bad), "calls": calls,
            "counters": _counters(b)}


def poisoned_in_dispatch(mod) -> dict:
    return _poisoned(mod, "dispatch")


def poisoned_in_finalize(mod) -> dict:
    return _poisoned(mod, "finalize")


def error_reaches_every_waiter(mod) -> dict:
    """A dispatch that always fails fails every request of the batch,
    after the serial retries."""
    calls = []

    def dispatch_fn(reqs):
        calls.append(list(reqs))
        raise RuntimeError("boom")

    b = _make(mod, "CombiningBatcher", dispatch_fn)
    followers = [Future() for _ in range(3)]
    for i, f in enumerate(followers):
        b._enqueue(f"f{i}", f)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit("lead")
    return {"calls": calls, "followers": [_outcome(f) for f in followers],
            "counters": _counters(b)}


def depth_429_and_deadline(mod) -> dict:
    """A full queue refuses at once with a 429; queued requests past their
    deadline are shed with a 429 when the scheduler next runs."""
    executed = []

    def dispatch_fn(reqs):
        executed.append(list(reqs))
        return list(reqs)

    b = _make(mod, "BoundedBatcher", dispatch_fn, max_batch=4,
              max_queue_depth=2, deadline_ms=50.0, topup=False)
    futs = [Future(), Future()]
    for i, f in enumerate(futs):
        b._enqueue(i, f)
    refused = Future()
    try:
        b._enqueue(2, refused)
    except Exception as e:  # noqa: BLE001 - compared as an outcome
        refused.set_exception(e)
    time.sleep(0.08)
    b._run_once()
    late = b.submit("fresh")
    return {"refused": _outcome(refused),
            "queued": [_outcome(f) for f in futs], "late": late,
            "executed": executed, "counters": _counters(b)}


def batch_ceiling_snaps_to_bucket(mod) -> dict:
    """max_batch 6 snaps to its query bucket, 8: a saturated queue drains
    in bucket-sized batches."""
    batches = []

    def dispatch_fn(reqs):
        batches.append(list(reqs))
        return list(reqs)

    b = _make(mod, "CombiningBatcher", dispatch_fn, max_batch=6,
              topup=False)
    futs = [Future() for _ in range(20)]
    for i, f in enumerate(futs):
        b._enqueue(i, f)
    while b.pending():
        b._run_once()
    return {"batches": batches, "outcomes": [_outcome(f) for f in futs],
            "counters": _counters(b)}


def async_depth_bounds_inflight(mod) -> dict:
    """At async_depth 1 a second batch is claimed but does not dispatch
    until the first has finalized."""
    dispatched = []
    started, release = threading.Event(), threading.Event()

    def dispatch_fn(reqs):
        dispatched.append(list(reqs))
        return list(reqs)

    def finalize_fn(handle):
        if handle == [1]:
            started.set()
            release.wait(WAIT)
        return [r * 10 for r in handle]

    b = _make(mod, "CombiningBatcher", dispatch_fn, finalize_fn,
              topup=False, async_depth=1)
    results = {}

    def worker(i):
        results[i] = b.submit(i)

    threads = [threading.Thread(target=worker, args=(1,))]
    threads[0].start()
    assert started.wait(WAIT)
    threads.append(threading.Thread(target=worker, args=(2,)))
    threads[1].start()
    _wait_until(lambda: b.pending() == 0)   # batch 2 is claimed
    time.sleep(0.05)
    during = {"dispatched": [list(x) for x in dispatched],
              "results": dict(results), "inflight": b.load()["inflight"]}
    release.set()
    _join(threads)
    return {"during": during, "dispatched": dispatched, "results": results,
            "counters": _counters(b)}


SCENARIOS = [edf_drain, topup_to_bucket, idle_single_never_waits,
             coalesce_behind_runner, pipelined_overlap, poisoned_in_dispatch,
             poisoned_in_finalize, error_reaches_every_waiter,
             depth_429_and_deadline, batch_ceiling_snaps_to_bucket,
             async_depth_bounds_inflight]

# what each scenario must show, on top of the two modules agreeing
EXPECT = {
    "edf_drain": lambda r: (
        r["first"]["executed"] == [["near"]]
        and r["executed"] == [["near"], ["far"]]
        and r["shed_order"] == ["dead_old", "dead_new"]
        and r["counters"]["stats"]["shed_deadline"] == 2
        and r["outcomes"]["dead_old"][2] == 429),
    "topup_to_bucket": lambda r: (
        r["batches"] == [list(range(8))]
        and r["counters"]["topups"] == 3 and r["counters"]["batches"] == 1),
    "idle_single_never_waits": lambda r: (
        r["got"] == "solo" and r["counters"]["topups"] == 0),
    "coalesce_behind_runner": lambda r: (
        r["batches"] == [["warm"], list(range(11))]
        and r["counters"]["requests"] == 12),
    "pipelined_overlap": lambda r: (
        r["during"]["results"] == {2: 20} and r["during"]["overlap"] == 1
        and r["results"] == {1: 10, 2: 20}
        and r["counters"]["pipelined_batches"] == 2),
    "poisoned_in_dispatch": lambda r: (
        r["got"] == "ok:good" and r["bad"][1] == "ValueError"
        and r["calls"] == [("dispatch", ["bad", "good"]),
                           ("dispatch", ["bad"]), ("dispatch", ["good"]),
                           ("finalize", ["good"])]),
    "poisoned_in_finalize": lambda r: (
        r["got"] == "ok:good" and r["bad"][1] == "ValueError"
        and r["calls"] == [("dispatch", ["bad", "good"]),
                           ("finalize", ["bad", "good"]),
                           ("dispatch", ["bad"]), ("finalize", ["bad"]),
                           ("dispatch", ["good"]), ("finalize", ["good"])]),
    "error_reaches_every_waiter": lambda r: (
        len(r["calls"]) == 5
        and all(o[1] == "RuntimeError" for o in r["followers"])),
    "depth_429_and_deadline": lambda r: (
        r["refused"][1:4] == ("EsRejectedExecutionError", 429,
                              "es_rejected_execution_exception")
        and all(o[2] == 429 for o in r["queued"])
        and r["executed"] == [["fresh"]]
        and r["counters"]["stats"]["rejected_depth"] == 1
        and r["counters"]["stats"]["shed_deadline"] == 2),
    "batch_ceiling_snaps_to_bucket": lambda r: (
        r["batches"] == [list(range(8)), list(range(8, 16)),
                         list(range(16, 20))]
        and r["outcomes"] == [("ok", i) for i in range(20)]),
    "async_depth_bounds_inflight": lambda r: (
        r["during"] == {"dispatched": [[1]], "results": {},
                        "inflight": 1}
        and r["dispatched"] == [[1], [2]]
        and r["results"] == {1: 10, 2: 20}
        and r["counters"]["overlap_hits"] == 0),
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_batcher_matches_reference(scenario):
    got = {name: scenario(mod) for name, mod in MODULES.items()}
    assert got["port"] == got["reference"]
    assert EXPECT[scenario.__name__](got["port"]), got["port"]
