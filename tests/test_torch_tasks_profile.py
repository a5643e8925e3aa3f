"""The search `profile`, `timeout` / `terminate_after`, the tasks API and
the trace ring through both REST layers on the CPU
(`tests/torch_rest_pair.py`), on the same seeded documents: identical hits
and profile structure for a kNN body (flat, two shards, int8 and IVF with
the reference's trained layout carried over), a hybrid body and an
aggregation body; a profiled body never served from either rung of the
request cache; `_tasks` listing an in-flight search with its
`X-Opaque-ID`; a queued search cancelled through `_tasks/{id}/_cancel`
shed before any launch with the reference's status and error; and
`GET _nodes/traces` after `?trace=true` with the reference's span names.

Profile times must be positive but are not compared. The launch event
lists (`dispatch`) are left out of the comparison: on CPU tensors the
port's kernel wrappers run their plain versions, which are not launches,
while the reference's events name the XLA programs it ran."""

import json
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu.telemetry import metrics as ref_metrics
from elasticsearch_tpu.telemetry import trace as ref_trace
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.telemetry import metrics as port_metrics
from elasticsearch_tpu_torch.telemetry import trace as port_trace
from tests.torch_rest_pair import Pair, profile_skeleton, raw, same_profile

D = 16
N = 700
WAIT = 10.0


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch,
             settings={"search.aggs.cost_router": "false"})
    p.ref_node.settings["search.aggs.cost_router"] = "false"
    yield p
    p.close()


def _mapping(options=None, shards=1, settings=None) -> dict:
    vec = {"type": "dense_vector", "dims": D, "similarity": "cosine"}
    if options:
        vec["index_options"] = options
    return {"settings": {"number_of_shards": shards, **(settings or {})},
            "mappings": {"properties": {
                "vec": vec, "t": {"type": "text"},
                "tag": {"type": "keyword"}, "n": {"type": "long"}}}}


def _docs(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((10, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 10, n)]
            + 0.4 * rng.standard_normal((n, D))).astype(np.float32)
    words = ["alpha", "beta", "gamma", "delta", "eta"]
    ops = []
    for i in range(n):
        ops += [{"index": {"_id": f"d{i}"}},
                {"vec": vecs[i].tolist(),
                 "t": " ".join(rng.choice(words, 4)),
                 "tag": str(rng.choice(["red", "green", "blue"])),
                 "n": int(rng.integers(0, 50))}]
    return rng, ops


def load(pair, name: str, options=None, shards=1, settings=None, seed=0):
    """The same documents in both layers; an IVF field's layout trained by
    the reference is staged into the port's store before its refresh."""
    rng, ops = _docs(seed)
    body = _mapping(options, shards, settings)
    ivf = bool(options) and options["type"].endswith("ivf")
    if not ivf:
        pair.same("PUT", f"/{name}", body)
        pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        pair.same("POST", f"/{name}/_refresh")
        return rng
    assert pair.ref("PUT", f"/{name}", body)[0] == 200
    assert not pair.ref("POST", f"/{name}/_bulk", ops, True)[1]["errors"]
    assert pair.ref("POST", f"/{name}/_refresh")[0] == 200
    layouts = pair.ref_node.indices.indices[name].shards[0] \
        .vector_store.export_ivf_layout()
    assert pair.port("PUT", f"/{name}", body)[0] == 200
    pair.port_node.index(name).store.restore_ivf_layout(layouts)
    assert not pair.port("POST", f"/{name}/_bulk", ops, True)[1]["errors"]
    assert pair.port("POST", f"/{name}/_refresh")[0] == 200
    return rng


def _knn(qv, k=5, **extra) -> dict:
    return {"knn": {"field": "vec", "query_vector": list(map(float, qv)),
                    "k": k, "num_candidates": 50}, **extra}


KNN_CASES = {
    "flat": (None, 1, None),
    "flat_2_shards": (None, 2, None),
    "int8_flat": ({"type": "int8_flat"}, 1, None),
    "ivf": ({"type": "ivf"}, 1, {"index.knn.nlist": 16,
                                 "index.knn.nprobe": 4}),
    "int8_ivf": ({"type": "int8_ivf"}, 1, {"index.knn.nlist": 16,
                                           "index.knn.nprobe": 4}),
}


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_profile_knn_matches_reference(pair, case):
    options, shards, settings = KNN_CASES[case]
    rng = load(pair, "v", options, shards, settings)
    for _ in range(2):
        qv = rng.standard_normal(D)
        wp, gp = same_profile(pair, "/v/_search",
                              _knn(qv, size=5, profile=True,
                                   request_cache=False))
    knn = gp["shards"][0]["knn"]
    assert knn["columnar"]["mode"] == "full"
    if case.endswith("ivf"):
        assert knn["engine"] == "tpu_ivf"
        assert all(knn["breakdown"][k] > 0
                   for k in ("route_nanos", "score_nanos", "merge_nanos"))
    # the plain versions on CPU tensors are not launches
    assert not gp["shards"][0].get("dispatch")


def test_profile_hybrid_matches_reference(pair):
    rng = load(pair, "h")
    body = {"rank": {"rrf": {}}, "query": {"match": {"t": "alpha"}},
            **_knn(rng.standard_normal(D)), "size": 7, "profile": True}
    # the reference's fused hybrid response has no `_shards`
    wp, gp = same_profile(pair, "/h/_search", body, hits_only=True)
    hy = gp["hybrid"]
    assert [leg["type"] for leg in hy["legs"]] == ["lexical_device",
                                                   "knn_device"]
    assert hy["cache"] == {"rung": "device_request", "served": False,
                           "policy": "profile_bypass"}
    for key in ("queue_wait_nanos", "device_dispatch_nanos",
                "device_sync_nanos"):
        assert hy["breakdown"][key] >= 0
    assert hy["scheduler"]["pipelined_batches"] >= 1


AGG_BODY = {"size": 0, "profile": True,
            "query": {"range": {"n": {"gte": 5}}},
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "mean": {"avg": {"field": "n"}}}}


def _engine_less(prof):
    """The skeleton less each aggregation's engine and fallback reason."""
    out = profile_skeleton(prof)
    for shard in out.get("shards", []):
        for e in shard["aggregations"]:
            e.pop("engine", None)
            e.pop("fallback_reason", None)
    return out


@pytest.mark.parametrize("rung", ["host", "device"])
def test_profile_aggs_match_reference(pair, rung):
    """Both layers' host paths (device aggregations off) answer the same
    profile, with no `engine`; with the device rung on, the port's
    entries read engine `device` with a positive `collect`. The
    reference's device rung imports `jax.experimental.enable_x64`, which
    the installed JAX lacks, so it serves from its host walkers
    (`device_error`) and only its entries' other fields are compared."""
    load(pair, "g")
    if rung == "host":
        for node in (pair.ref_node, pair.port_node):
            node.settings["search.aggs.device_enabled"] = "false"
        wp, gp = same_profile(pair, "/g/_search", AGG_BODY)
        assert all("engine" not in e
                   for e in gp["shards"][0]["aggregations"])
        return
    wp, gp = same_profile(pair, "/g/_search", AGG_BODY,
                          skeleton=_engine_less)
    entries = gp["shards"][0]["aggregations"]
    assert [(e["type"], e["description"], e["engine"]) for e in entries] \
        == [("terms", "tags", "device"), ("avg", "mean", "device")]
    assert all(e["breakdown"]["collect"] > 0 for e in entries)


def test_profiled_bodies_are_never_served_from_the_cache(pair):
    """A kNN body (device rung), a `size: 0` body (host rung) and a hybrid
    body (the hybrid device rung), each sent twice with `profile`: no
    rung serves or stores them, and each profile says which rung it
    bypassed. The unprofiled body after them misses, then hits."""
    rng = load(pair, "c")
    caches = pair.port_node.caches
    qv = rng.standard_normal(D)
    bodies = [(_knn(qv, size=4), "device_request"),
              ({"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}},
               "shard_request")]
    for body, rung in bodies:
        for _ in range(2):
            status, got = pair.port("POST", "/c/_search",
                                    dict(body, profile=True))
            assert status == 200
            assert got["profile"]["shards"][0]["cache"] == \
                {"rung": rung, "hit": False}
        assert caches.stats()["request_cache"]["hit_count"] == 0
    hybrid = {"rank": {"rrf": {}}, "query": {"match": {"t": "beta"}},
              **_knn(qv), "profile": True}
    launches = []
    ex = pair.port_node._hybrid_executor(pair.port_node.index("c"))
    orig = ex.batcher._dispatch_fn
    ex.batcher._dispatch_fn = lambda bodies: launches.append(1) or \
        orig(bodies)
    for _ in range(2):
        assert pair.port("POST", "/c/_search", hybrid)[0] == 200
    assert len(launches) == 2
    assert caches.stats()["request_cache"]["hit_count"] == 0
    for _ in range(2):
        assert pair.port("POST", "/c/_search", bodies[0][0])[0] == 200
    assert caches.stats()["request_cache"]["hit_count"] == 1


@pytest.mark.parametrize("key,value", [
    ("timeout", "1ms"), ("timeout", "30s"), ("terminate_after", 1),
    ("terminate_after", 1000)])
def test_timeout_and_terminate_after_match_reference(pair, key, value):
    rng = load(pair, "t")
    for body in ({"query": {"match": {"t": "gamma"}}, "size": 20},
                 _knn(rng.standard_normal(D), size=5)):
        want, got = pair.same("POST", "/t/_search", dict(body, **{key: value}))
        assert got["timed_out"] is False
        plain = pair.port("POST", "/t/_search", body)[1]
        assert [h["_id"] for h in plain["hits"]["hits"]] == \
            [h["_id"] for h in got["hits"]["hits"]]


def _blocked_search(pair, name: str, body: dict, opaque: str):
    """Hold the port index batcher's run lock, send `body` on a thread
    with an `X-Opaque-ID`, and wait until it is queued. Returns (the
    batcher, the thread, its result holder)."""
    batcher = pair.port_node.index(name).vector_store._batcher
    batcher._run_lock.acquire()
    out = {}

    def run():
        out["resp"] = pair.port_rc.dispatch(
            "POST", f"/{name}/_search", {}, raw(body),
            {"x-opaque-id": opaque})

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + WAIT
    while batcher.pending() != 1:
        assert time.monotonic() < deadline, "the search never queued"
        time.sleep(0.002)
    return batcher, t, out


def _search_task(tasks: dict) -> dict:
    (task,) = [t for t in tasks.values()
               if t["action"] == "indices:data/read/search"]
    return task


def test_tasks_list_an_inflight_search_with_its_opaque_id(pair):
    rng = load(pair, "q")
    body = _knn(rng.standard_normal(D), request_cache=False)
    batcher, t, out = _blocked_search(pair, "q", body, "dash-42")
    try:
        status, listed = pair.port_rc.dispatch(
            "GET", "/_tasks", {"actions": "*search"}, b"",
            {"x-opaque-id": "lister"})
        assert status == 200
        (section,) = listed["nodes"].values()
        task = _search_task(section["tasks"])
        assert task["headers"] == {"X-Opaque-Id": "dash-42"}
        assert task["description"] == "indices[q]"
        assert task["cancellable"] and not task["cancelled"]
        status, one = pair.port("GET", f"/_tasks/{task['node']}:{task['id']}")
        assert status == 200 and one["completed"] is False
        assert one["task"]["headers"] == {"X-Opaque-Id": "dash-42"}
        # every key of the reference's task rendering
        ref_task = pair.ref_node.tasks.register(
            "indices:data/read/search", opaque_id="x")
        assert set(task) | {"trace_id"} >= set(
            ref_task.to_dict(pair.ref_node.node_id))
        pair.ref_node.tasks.unregister(ref_task)
        # the list itself, with the caller's header, as in the reference
        status, everything = pair.port_rc.dispatch(
            "GET", "/_tasks", {"group_by": "none"}, b"",
            {"x-opaque-id": "lister"})
        lists = [x for x in everything["tasks"]
                 if x["action"] == "cluster:monitor/tasks/lists"]
        assert lists[0]["headers"] == {"X-Opaque-Id": "lister"}
    finally:
        batcher._run_lock.release()
    t.join(WAIT)
    assert out["resp"][0] == 200
    status, after = pair.port("GET", "/_tasks", query={"actions": "*search"})
    assert not any(x["action"] == "indices:data/read/search"
                   for sec in after["nodes"].values()
                   for x in sec["tasks"].values())


def _ref_blocked_search(pair, name: str, body: dict):
    """The reference's counterpart of `_blocked_search`: its shard store
    makes the field's batcher at the first search, whose run lock is held
    while the next search queues."""
    assert pair.ref("POST", f"/{name}/_search", body)[0] == 200
    store = pair.ref_node.indices.indices[name].shards[0].vector_store
    (batcher,) = store._batchers.values()
    batcher._run_lock.acquire()
    out = {}

    def run():
        out["resp"] = pair.ref_rc.dispatch("POST", f"/{name}/_search", {},
                                           raw(body), "application/json",
                                           {"x-opaque-id": "c"})

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + WAIT
    while batcher.pending() != 1:
        assert time.monotonic() < deadline, "the search never queued"
        time.sleep(0.002)
    return batcher, t, out


@pytest.mark.parametrize("route", ["one", "all"])
def test_cancelled_queued_search_is_shed_as_in_the_reference(pair, route):
    """`POST _tasks/{id}/_cancel` (or `_tasks/_cancel?actions=`) of a
    search queued in the index batcher: the batcher sheds it when it next
    claims a batch, before any dispatch, with the reference's 400."""
    rng = load(pair, "x")
    body = _knn(rng.standard_normal(D), request_cache=False)
    results = {}
    for side in ("reference", "port"):
        if side == "port":
            batcher, t, out = _blocked_search(pair, "x", body, "c")
            calls = []
            store = pair.port_node.index("x").vector_store
            orig = store._dispatch_batch
            store._dispatch_batch = lambda reqs: calls.append(reqs) or \
                orig(reqs)
            dispatch.reset_launches()
            send = pair.port
        else:
            batcher, t, out = _ref_blocked_search(pair, "x", body)
            send = pair.ref
        try:
            _, listed = send("GET", "/_tasks", query={"actions": "*search"})
            (section,) = listed["nodes"].values()
            task = _search_task(section["tasks"])
            tid = f"{task['node']}:{task['id']}"
            if route == "one":
                status, resp = send("POST", f"/_tasks/{tid}/_cancel")
            else:
                status, resp = send("POST", "/_tasks/_cancel",
                                    query={"actions": "*search"})
            assert status == 200
            (cancelled,) = [x for sec in resp["nodes"].values()
                            for x in sec["tasks"].values()]
            assert cancelled["cancelled"] is True
        finally:
            batcher._run_lock.release()
        t.join(WAIT)
        results[side] = (out["resp"], batcher.sched["cancelled_sheds"])
    (want, w_sheds), (got, g_sheds) = results["reference"], results["port"]
    assert got == want
    assert got[0] == 400
    assert got[1]["error"]["type"] == "task_cancelled_exception"
    assert w_sheds == g_sheds == 1
    assert calls == [] and dispatch.launches() == {}
    status, err = pair.port("POST", "/_tasks/nope:1/_cancel")
    assert (status, err) == pair.ref("POST", "/_tasks/nope:1/_cancel")
    assert status == 404


def test_task_errors_match_reference(pair):
    for path, method in (("/_tasks/zz:3", "GET"),
                         ("/_tasks/zz:3/_cancel", "POST")):
        assert pair.port(method, path) == pair.ref(method, path)
    for node in (pair.port_node, pair.ref_node):
        status, body = (pair.port if node is pair.port_node
                        else pair.ref)("GET", f"/_tasks/{node.node_id}:77")
        assert status == 404
        assert body["error"]["reason"] == (
            f"task [{node.node_id}:77] isn't running and hasn't stored its "
            f"results")
    assert pair.port("POST", "/_tasks/_cancel",
                     query={"actions": "nothing*"}) == \
        pair.ref("POST", "/_tasks/_cancel", query={"actions": "nothing*"})


def test_trace_ring_has_the_reference_span_names(pair):
    """`?trace=true` forces a trace; `GET _nodes/traces` lists it first,
    with the reference's span names for a kNN search and a `size: 0`
    search, and a write's trace."""
    rng = load(pair, "r")
    port_trace.TRACER.clear()
    ref_trace.TRACER.clear()
    names = {}
    for side, send in (("reference", pair.ref), ("port", pair.port)):
        send("POST", "/r/_search",
             _knn(rng.standard_normal(D), request_cache=False),
             query={"trace": "true"})
        send("POST", "/r/_search", {"size": 0}, query={"trace": "true"})
        send("PUT", "/r/_doc/new", {"n": 3}, query={"trace": "true"})
        status, ring = send("GET", "/_nodes/traces")
        assert status == 200
        (section,) = ring["nodes"].values()
        names[side] = [(t["action"], sorted(s["name"] for s in t["spans"]))
                       for t in section["traces"]]
        assert ring["_nodes"] == {"total": 1, "successful": 1, "failed": 0}
    assert names["port"] == names["reference"]
    assert "batch.finalize" in names["port"][2][1]


def test_nodes_stats_telemetry_matches_reference_section(pair):
    """`GET _nodes/stats/telemetry`: the registry's histograms and the
    tracer's counters after the same requests, as the reference's
    `_nodes/stats` renders its `telemetry` section; other metrics are a
    400 that names them."""
    rng = load(pair, "s")
    port_metrics.REGISTRY.reset()
    ref_metrics.REGISTRY.reset()
    port_trace.TRACER.clear()
    ref_trace.TRACER.clear()
    for _ in range(3):
        body = _knn(rng.standard_normal(D), request_cache=False)
        pair.same("POST", "/s/_search", body, query={"trace": "true"})
    pair.same("POST", "/s/_search", {"query": {"match": {"t": "eta"}}})
    status, got = pair.port("GET", "/_nodes/stats/telemetry")
    assert status == 200
    (section,) = got["nodes"].values()
    gt = section["telemetry"]
    _, full = pair.ref("GET", "/_nodes/stats")
    (ref_section,) = full["nodes"].values()
    wt = ref_section["telemetry"]
    assert set(gt) == set(wt) == {"counters", "gauges", "histograms",
                                  "tracing"}
    assert gt["gauges"] == wt["gauges"]
    assert {k: v for k, v in gt["tracing"].items() if k != "sample_rate"} \
        == {k: v for k, v in wt["tracing"].items() if k != "sample_rate"}
    # the reference's `dispatch.compile` times XLA compiles; eager
    # PyTorch has none
    wt["histograms"].pop("dispatch.compile", None)
    assert sorted(gt["histograms"]) == sorted(wt["histograms"])
    for name, h in gt["histograms"].items():
        assert set(h) == set(wt["histograms"][name])
        assert h["count"] == wt["histograms"][name]["count"], name
    assert gt["histograms"]["search.took"]["count"] == 4
    assert gt["histograms"]["serving.queue_wait"]["count"] == 3
    status, err = pair.port("GET", "/_nodes/stats/jvm")
    assert status == 400 and "[_nodes/stats/jvm]" in \
        err["error"]["reason"]
    status, err = pair.port("GET", "/_nodes/stats/telemetri")
    assert status == 400 and "did you mean [telemetry]" in \
        err["error"]["reason"]
    assert json.dumps(got)  # plain JSON
