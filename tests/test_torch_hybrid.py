"""Hybrid `rank: {rrf}` search with a `knn` leg on a dense_vector field and a
`late_interaction` leg on a rank_vectors field, through the port's REST
layer on the CPU and the reference `Node` on the same PUT, `_bulk`,
`_refresh` and `_search` sequence.

RRF depends only on each leg's ranks, so the fused `_score`s must be equal
as f64, the hit `_id`s equal, and `hits.total` equal. The reference's host
mirror is switched off so its kNN leg serves from its device route."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import late_interaction as ref_late
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import maxsim
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.hybrid_plan import compile_plan
from elasticsearch_tpu_torch.vectors import late_interaction as port_late

D_EMB, D_COL = 32, 16


def _raw(body, ndjson=False):
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return b"" if body is None else json.dumps(body).encode()


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with the same 60 docs (one without tokens, one without
    a vector) in index `h`; yields (reference dispatch, port dispatch,
    port node, docs)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    ref = RefNode(str(tmp_path_factory.mktemp("ref")))
    port = Node(device="cpu")
    ref_rc, port_rc = RefController(), RestController()
    ref_register(ref_rc, ref)
    register_all(port_rc, port)

    def ref_req(method, path, body=None, ndjson=False):
        return ref_rc.dispatch(method, path, {}, _raw(body, ndjson),
                               "application/json")

    def port_req(method, path, body=None, ndjson=False):
        return port_rc.dispatch(method, path, {}, _raw(body, ndjson))

    rng = np.random.default_rng(31)
    topics = rng.standard_normal((8, D_COL)).astype(np.float32)
    emb = rng.standard_normal((60, D_EMB)).astype(np.float32)
    cols = [(topics[i % 8] + 0.5 * rng.standard_normal(
        (int(rng.integers(2, 7)), D_COL))).astype(np.float32)
        for i in range(60)]
    bulk = []
    for i in range(60):
        doc = {"tag": f"t{i % 3}"}
        if i != 13:
            doc["emb"] = emb[i].tolist()
        if i != 29:
            doc["colv"] = cols[i].tolist()
        bulk += [{"index": {"_id": f"d{i}"}}, doc]
    create = {"settings": {"number_of_shards": 1, "number_of_replicas": 0},
              "mappings": {"properties": {
                  "emb": {"type": "dense_vector", "dims": D_EMB,
                          "similarity": "cosine"},
                  "colv": {"type": "rank_vectors", "dims": D_COL},
                  "tag": {"type": "keyword"}}}}
    for req in (ref_req, port_req):
        assert req("PUT", "/h", create)[0] == 200
        status, resp = req("POST", "/h/_bulk", bulk, ndjson=True)
        assert status == 200 and not resp["errors"]
        assert req("POST", "/h/_refresh")[0] == 200
    yield ref_req, port_req, port, emb, cols
    ref.close()
    mp.undo()


def _hybrid(emb, cols, i, k=None, size=10, **extra):
    knn = {"field": "emb", "query_vector": (emb[i] + 0.1).tolist(),
           "num_candidates": 30}
    li = {"field": "colv", "query_tokens": (cols[i] + 0.05).tolist()}
    if k is not None:
        knn["k"] = li["k"] = k
    return {"rank": {"rrf": {}}, "size": size,
            "sub_searches": [{"query": {"knn": knn}},
                             {"query": {"late_interaction": li}}], **extra}


def _same(want, got):
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
    assert [h["_score"] for h in gh] == [h["_score"] for h in wh]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]
    for g, w in zip(gh, wh):
        assert g.get("_source") == w.get("_source")


@pytest.mark.parametrize("case", [
    dict(i=3), dict(i=11, k=5, size=20), dict(i=40, k=25, size=7),
    dict(i=0, _source=False), dict(i=7, _source=["tag"]),
    dict(i=21, rank={"rrf": {"rank_constant": 10, "rank_window_size": 4}}),
])
def test_hybrid_matches_reference_node(nodes, case):
    ref_req, port_req, port, emb, cols = nodes
    body = _hybrid(emb, cols, **case)
    s1, want = ref_req("POST", "/h/_search", body)
    s2, got = port_req("POST", "/h/_search", body)
    assert s1 == s2 == 200, (want, got)
    assert got["hits"]["hits"]
    _same(want, got)


def test_k_defaults_to_10_in_both_legs(nodes):
    """Without `k`, each leg ranks 10 rows: 20 fused rows less the rows
    both legs found; `num_candidates` does not widen the knn leg."""
    ref_req, port_req, port, emb, cols = nodes
    body = _hybrid(emb, cols, 5, size=30)
    body["sub_searches"][0]["query"]["knn"]["num_candidates"] = 40
    want = ref_req("POST", "/h/_search", body)[1]
    got = port_req("POST", "/h/_search", body)[1]
    _same(want, got)
    plan = compile_plan(body, port.index("h").mapper_service)
    assert [t.k for t in plan.legs] == [10, 10]
    assert plan.legs[0].num_candidates == 40
    assert 10 < got["hits"]["total"]["value"] <= 20


def test_query_plus_knn_form(nodes):
    ref_req, port_req, port, emb, cols = nodes
    searches = port._hybrid["h"].stats["searches"] if "h" in port._hybrid \
        else 0
    for i in (2, 9, 33):
        body = {"rank": {"rrf": {}},
                "query": {"late_interaction": {
                    "field": "colv", "query_tokens": cols[i].tolist()}},
                "knn": {"field": "emb", "query_vector": emb[i].tolist(),
                        "k": 10}}
        _same(ref_req("POST", "/h/_search", body)[1],
              port_req("POST", "/h/_search", body)[1])
    ex = port._hybrid["h"]
    assert ex.stats["searches"] == searches + 3
    assert ex.late.stats["searches"] >= 3


def test_wide_query_takes_the_device_leg(nodes, monkeypatch):
    """A leg of 132 query tokens runs the coarse search and the MaxSim
    rescore like any other: the port's kernels take any token count. The
    reference walks such a leg on the host only because its TPU kernel has
    a compile grid capped at 128 tokens; with that cap lifted it takes its
    device path as well, and the two nodes agree."""
    ref_req, port_req, port, emb, cols = nodes
    monkeypatch.setattr(ref_late, "MAX_QUERY_TOKENS", 1 << 10)
    rescored, rescore = [], maxsim.maxsim_rescore
    monkeypatch.setattr(port_late.maxsim, "maxsim_rescore",
                        lambda ids, q, *a: rescored.append(q.shape)
                        or rescore(ids, q, *a))
    rng = np.random.default_rng(32)
    wide = rng.standard_normal((132, D_COL)).tolist()
    body = _hybrid(emb, cols, 8)
    body["sub_searches"][1]["query"]["late_interaction"]["query_tokens"] = wide
    _same(ref_req("POST", "/h/_search", body)[1],
          port_req("POST", "/h/_search", body)[1])
    assert [tuple(shape)[:2] for shape in rescored] == [(1, 256)]


def test_plain_late_interaction_query_matches_reference(nodes):
    ref_req, port_req, port, emb, cols = nodes
    body = {"query": {"late_interaction": {
        "field": "colv", "query_tokens": (cols[4] - 0.1).tolist(),
        "boost": 2.0}}, "size": 12}
    s1, want = ref_req("POST", "/h/_search", body)
    s2, got = port_req("POST", "/h/_search", body)
    assert s1 == s2 == 200
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] \
        == [h["_id"] for h in want["hits"]["hits"]]
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               [h["_score"] for h in want["hits"]["hits"]],
                               rtol=1e-6)


@pytest.mark.parametrize("sub", [
    {"match": {"tag": "t1"}},
    {"term": {"tag": "t1"}},
    {"knn": {"field": "emb", "query_vector": [0.0] * D_EMB,
             "filter": {"match": {"tag": "t1"}}}},
    {"knn": {"field": "colv", "query_vector": [0.0] * D_COL}},
    {"late_interaction": {"field": "emb", "query_tokens": [[0.0] * D_EMB]}},
])
def test_unported_sub_search_is_a_400(nodes, sub):
    """A sub-search the port serves answers as the reference does: `match`
    and `term` on a keyword field run as generic legs, and a `match`
    filter of a kNN leg is parsed. A `knn` or `late_interaction`
    sub-search on a field of another type stays a 400 naming it."""
    ref_req, port_req, _port, emb, cols = nodes
    body = _hybrid(emb, cols, 1)
    body["sub_searches"][0] = {"query": sub}
    s1, want = ref_req("POST", "/h/_search", body)
    status, resp = port_req("POST", "/h/_search", body)
    kind = next(iter(sub))
    if kind in ("match", "term") or "filter" in sub.get("knn", {}):
        assert s1 == status == 200, (want, resp)
        _same(want, resp)
    else:
        assert status == 400, resp
        assert f"sub-search [{kind}] is not supported" \
            in resp["error"]["reason"]
    query = {"query": {"match": {"tag": "t1"}}}
    s1, want = ref_req("POST", "/h/_search", query)
    status, resp = port_req("POST", "/h/_search", query)
    assert s1 == status == 200
    _same(want, resp)


def _concurrently(port, calls, monkeypatch):
    """Run each call on its own thread through the index's hybrid batcher,
    the first one's dispatch held until the rest have queued behind it,
    so they form one batch. Returns their results or errors."""
    import threading
    import time
    ex = port._hybrid_executor(port.index("h"))
    inner = ex.batcher._dispatch_fn
    started, gate = threading.Event(), threading.Event()

    def held(bodies):
        if not started.is_set():
            started.set()
            assert gate.wait(10)
        return inner(bodies)

    monkeypatch.setattr(ex.batcher, "_dispatch_fn", held)
    out = [None] * len(calls)

    def run(i):
        try:
            out[i] = calls[i]()
        except Exception as e:  # noqa: BLE001 - returned to the test
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    threads[0].start()
    assert started.wait(10)
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + 10
    while ex.batcher.pending() < len(calls) - 1:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    gate.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return out


def test_concurrent_submit_equals_sequential_one_dispatch_a_leg(
        nodes, monkeypatch):
    """8 concurrent bodies give the sequential answers (and the
    reference's); the 7 that coalesced ran one knn and one MaxSim
    dispatch between them."""
    ref_req, port_req, port, emb, cols = nodes
    # each body opts out of the request cache: the test counts dispatches
    bodies = [dict(_hybrid(emb, cols, i, k=8), request_cache=False)
              for i in range(30, 38)]
    sequential = [port_req("POST", "/h/_search", b) for b in bodies]
    ex = port._hybrid_executor(port.index("h"))
    store = port.index("h").store
    calls = {"knn": 0, "maxsim": 0}

    def counted(kind, fn):
        def run(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(store, "search_many_async",
                        counted("knn", store.search_many_async))
    monkeypatch.setattr(ex.late, "search_batch",
                        counted("maxsim", ex.late.search_batch))
    stats0 = dict(ex.stats)
    got = _concurrently(port, [
        (lambda b=b: port_req("POST", "/h/_search", b)) for b in bodies],
        monkeypatch)
    for body, (s0, want), (s1, resp) in zip(bodies, sequential, got):
        assert s0 == s1 == 200
        _same(want, resp)
        _same(ref_req("POST", "/h/_search", body)[1], resp)
    assert calls == {"knn": 2, "maxsim": 2}
    assert ex.stats["batches"] - stats0["batches"] == 2
    assert ex.stats["searches"] - stats0["searches"] == 8
    assert ex.stats["max_batch_seen"] >= 7
    for key in ("queue_wait_nanos", "dispatch_nanos", "sync_nanos"):
        assert ex.stats[key] > stats0[key]


def test_poisoned_body_fails_alone_in_a_batch(nodes, monkeypatch):
    """A body whose knn vector has the wrong dims fails the batch it
    coalesced into; the serial retry gives it its 400 and the others
    their answers."""
    _ref_req, port_req, port, emb, cols = nodes
    # each body opts out of the request cache: they must reach the batch
    bodies = [dict(_hybrid(emb, cols, i), request_cache=False)
              for i in (40, 41, 42)]
    bad = dict(_hybrid(emb, cols, 43), request_cache=False)
    bad["sub_searches"][0]["query"]["knn"]["query_vector"] = [0.5] * 3
    sequential = [port_req("POST", "/h/_search", b) for b in bodies]
    got = _concurrently(port, [
        (lambda b=b: port_req("POST", "/h/_search", b))
        for b in [bodies[0], bad] + bodies[1:]], monkeypatch)
    status, resp = got[1]
    assert status == 400
    assert resp["error"]["type"] == "illegal_argument_exception"
    for (s0, want), (s1, resp) in zip(sequential, [got[0]] + got[2:]):
        assert s0 == s1 == 200
        _same(want, resp)
