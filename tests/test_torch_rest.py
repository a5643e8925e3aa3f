"""The whole slice: the port's REST server on the CPU against the reference
`Node` (in-process, one shard) on the same PUT, `_bulk`, `_refresh` and
`_search { knn }` sequence. Hit `_id`s must match where the reference's
score gaps exceed 1e-4, and `_score`s agree within 1e-4. The reference's
int8 host mirror is switched off so it serves from its device route."""

import http.client
import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.server import build_server

D = 16


def _raw(body, ndjson=False):
    if body is None:
        return b""
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return json.dumps(body).encode()


class RefClient:
    def __init__(self, node):
        self.node = node
        self.rc = RefController()
        ref_register(self.rc, node)

    def req(self, method, path, body=None, ndjson=False):
        return self.rc.dispatch(method, path, {}, _raw(body, ndjson),
                                "application/json")


class PortClient:
    def __init__(self, node):
        self.node = node
        self.rc = RestController()
        register_all(self.rc, node)

    def req(self, method, path, body=None, ndjson=False):
        return self.rc.dispatch(method, path, {}, _raw(body, ndjson))


@pytest.fixture
def clients(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_store.native, "AVAILABLE", False)
    ref = RefNode(str(tmp_path / "data"))
    yield RefClient(ref), PortClient(Node(device="cpu"))
    ref.close()


INDICES = {
    "cos": {"type": "dense_vector", "dims": D, "similarity": "cosine"},
    "dot": {"type": "dense_vector", "dims": D, "similarity": "dot_product"},
    "l2": {"type": "dense_vector", "dims": D, "similarity": "l2_norm"},
    "i8": {"type": "dense_vector", "dims": D, "similarity": "cosine",
           "index_options": {"type": "int8_flat", "rescore": True}},
}


@pytest.mark.parametrize("name", sorted(INDICES))
def test_knn_search_matches_reference_node(clients, name):
    rng = np.random.default_rng(sum(map(ord, name)))
    vecs = rng.standard_normal((300, D)).astype(np.float32)
    bulk = []
    for i, v in enumerate(vecs):
        bulk += [{"index": {"_id": f"doc{i}"}},
                 {"v": v.tolist(), "tag": f"t{i % 3}"}]
    create = {"settings": {"number_of_shards": 1, "number_of_replicas": 0},
              "mappings": {"properties": {"v": INDICES[name],
                                          "tag": {"type": "keyword"}}}}
    for c in clients:
        assert c.req("PUT", f"/{name}", create)[0] == 200
        status, resp = c.req("POST", f"/{name}/_bulk", bulk, ndjson=True)
        assert status == 200 and not resp["errors"]
        # an update replaces doc5 everywhere
        assert c.req("PUT", f"/{name}/_doc/doc5",
                     {"v": (vecs[9] * 2).tolist(), "tag": "new"})[0] == 200
        assert c.req("POST", f"/{name}/_refresh")[0] == 200

    ref, port = clients
    for q in rng.standard_normal((4, D)).astype(np.float32):
        body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                        "num_candidates": 50}, "size": 10}
        s1, want = ref.req("POST", f"/{name}/_search", body)
        s2, got = port.req("POST", f"/{name}/_search", body)
        assert s1 == s2 == 200
        assert got["hits"]["total"] == want["hits"]["total"]
        wh, gh = want["hits"]["hits"], got["hits"]["hits"]
        assert len(gh) == len(wh) == 10
        ws = np.array([h["_score"] for h in wh])
        gs = np.array([h["_score"] for h in gh])
        np.testing.assert_allclose(gs, ws, atol=1e-4)
        assert abs(got["hits"]["max_score"] - want["hits"]["max_score"]) < 1e-4
        gap = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                         np.abs(np.diff(ws, append=-np.inf)))
        for j in np.nonzero(gap > 1e-4)[0]:
            assert gh[j]["_id"] == wh[j]["_id"]
            assert gh[j]["_index"] == name
            assert gh[j]["_source"] == wh[j]["_source"]
    for c in clients:
        status, doc = c.req("GET", f"/{name}/_doc/doc5")
        assert status == 200 and doc["_version"] == 2
        assert doc["_source"]["tag"] == "new"


def test_errors_follow_reference_shape(clients):
    ref, port = clients
    for c in clients:
        c.req("PUT", "/e", {"mappings": {"properties": {
            "v": {"type": "dense_vector", "dims": 4}}}})
    for method, path, body in (
            ("POST", "/missing/_search", {"knn": {}}),
            ("PUT", "/e", {}),
            ("PUT", "/bad", {"mappings": {"properties": {
                "v": {"type": "dense_vector"}}}}),
            ("PUT", "/e/_doc/1", {"v": [1, 2]})):
        s1, want = ref.req(method, path, body)
        s2, got = port.req(method, path, body)
        assert s1 == s2, (path, want, got)
        assert got["error"]["type"] == want["error"]["type"]
        assert got["status"] == s1 and got["error"]["root_cause"]
    # a body key outside the slice is the reference's unknown-key 400
    status, got = port.req("POST", "/e/_search", {"foo": 1})
    assert status == 400 and got["error"]["type"] == "parsing_exception"
    # a type once refused (percolator) maps as the reference maps it
    body = {"mappings": {"properties": {"x": {"type": "percolator"}}}}
    assert ref.req("PUT", "/t", body) == port.req("PUT", "/t", body)


def test_source_disabled_and_http_round_trip():
    node, server = build_server(device="cpu", port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)

        def req(method, path, body=None, ndjson=False):
            conn.request(method, path, body=_raw(body, ndjson),
                         headers={"content-type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        assert req("GET", "/")[0] == 200
        assert req("PUT", "/s", {"mappings": {
            "_source": {"enabled": False},
            "properties": {"v": {"type": "dense_vector", "dims": 3}}}})[0] == 200
        status, resp = req("POST", "/s/_bulk", [
            {"index": {"_id": "a"}}, {"v": [1, 0, 0]},
            {"index": {"_id": "b"}}, {"v": [0, 1, 0]},
            {"index": {"_id": "c"}}, {"v": [1, 2]}], ndjson=True)
        assert status == 200 and resp["errors"]
        assert [next(iter(i.values()))["status"] for i in resp["items"]] \
            == [201, 201, 400]
        req("POST", "/s/_refresh")
        status, resp = req("POST", "/s/_search", {"knn": {
            "field": "v", "query_vector": [0.9, 0.1, 0], "k": 2}})
        hits = resp["hits"]["hits"]
        assert status == 200 and [h["_id"] for h in hits] == ["a", "b"]
        assert all("_source" not in h for h in hits)
        assert "_source" not in req("GET", "/s/_doc/a")[1]
    finally:
        server.stop()


# ---------------------------------------------------------------- tpu_ivf
#
# IVF indices over HTTP-shaped requests: the reference node trains its
# layout at refresh; its store's `export_ivf_layout` is staged into the
# port's store before the port's refresh, so both serve from the same
# partitions and an explicit `index.knn.nprobe`.

IVF_INDICES = {
    f"{t}-{sim}": {"type": "dense_vector", "dims": D, "similarity": sim,
                   "index_options": {"type": t}}
    for t in ("ivf", "int8_ivf", "int4_ivf")
    for sim in ("cosine", "dot_product", "l2_norm")
}
IVF_SETTINGS = {"number_of_shards": 1, "number_of_replicas": 0,
                "index.knn.nlist": 16, "index": {"knn": {"nprobe": 2}}}


def _ref_store(ref, name):
    return ref.node.indices.indices[name].shards[0].vector_store


def _load_ivf_pair(clients, name, field, vecs):
    ref, port = clients
    create = {"settings": IVF_SETTINGS,
              "mappings": {"properties": {"v": field}}}
    bulk = []
    for i, v in enumerate(vecs):
        bulk += [{"index": {"_id": f"doc{i}"}}, {"v": v.tolist()}]
    assert ref.req("PUT", f"/{name}", create)[0] == 200
    assert not ref.req("POST", f"/{name}/_bulk", bulk, ndjson=True)[1]["errors"]
    assert ref.req("POST", f"/{name}/_refresh")[0] == 200
    layouts = _ref_store(ref, name).export_ivf_layout()
    assert set(layouts) == {"v"}
    assert port.req("PUT", f"/{name}", create)[0] == 200
    store = port.node.index(name).store
    store.restore_ivf_layout(layouts)
    assert not port.req("POST", f"/{name}/_bulk", bulk,
                        ndjson=True)[1]["errors"]
    assert port.req("POST", f"/{name}/_refresh")[0] == 200
    assert store.knn_stats["ivf_restores"] == 1
    assert store.knn_stats["ivf_trains"] == 0
    return _ref_store(ref, name), store


def _same_hits(want, got):
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(wh)
    ws = np.array([h["_score"] for h in wh])
    gs = np.array([h["_score"] for h in gh])
    np.testing.assert_allclose(gs, ws, atol=1e-4)
    gap = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                     np.abs(np.diff(ws, append=-np.inf)))
    for j in np.nonzero(gap > 1e-4)[0]:
        assert gh[j]["_id"] == wh[j]["_id"]


def _clustered_docs(seed, n=700):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((10, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 10, n)]
            + 0.4 * rng.standard_normal((n, D))).astype(np.float32)
    return rng, vecs


@pytest.mark.parametrize("name", sorted(IVF_INDICES))
def test_ivf_knn_search_matches_reference_node(clients, name):
    rng, vecs = _clustered_docs(sum(map(ord, name)))
    ref_store_, store = _load_ivf_pair(clients, name, IVF_INDICES[name], vecs)
    ref, port = clients
    for q in vecs[rng.integers(0, len(vecs), 3)] + 0.2 * rng.standard_normal(
            (3, D)):
        body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                        "num_candidates": 20}, "size": 10}
        s1, want = ref.req("POST", f"/{name}/_search", body)
        s2, got = port.req("POST", f"/{name}/_search", body)
        assert s1 == s2 == 200
        _same_hits(want, got)
        assert store.last_knn_phases["nprobe"] == \
            ref_store_.last_knn_phases["nprobe"] == 2
    stats = store.knn_stats
    assert stats["ivf_searches"] == 3 and stats["fallback_searches"] == 0
    assert stats["fused_probe_searches"] == (0 if "l2" in name else 3)


def test_num_candidates_widens_nprobe_like_reference(clients):
    """num_candidates beyond nprobe x cap widens probing to the next pow-2
    rung, as the reference's router does; the port's kNN query used to
    drop it, probing 2 partitions where the reference probed 8."""
    name = "widen"
    field = {"type": "dense_vector", "dims": D, "similarity": "cosine",
             "index_options": {"type": "ivf"}}
    rng, vecs = _clustered_docs(77)
    ref_store_, store = _load_ivf_pair(clients, name, field, vecs)
    cap = store.field("v").router.index.cap
    ref, port = clients
    q = vecs[5] + 0.3 * rng.standard_normal(D)
    nprobes = []
    for nc in (10, 2 * cap + 1, 5 * cap):
        body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                        "num_candidates": nc}}
        want = ref.req("POST", f"/{name}/_search", body)[1]
        got = port.req("POST", f"/{name}/_search", body)[1]
        _same_hits(want, got)
        assert store.last_knn_phases["nprobe"] == \
            ref_store_.last_knn_phases["nprobe"]
        nprobes.append(store.last_knn_phases["nprobe"])
    assert nprobes == [2, 4, 8]


def test_num_candidates_below_k_clamps_like_reference(clients):
    """num_candidates < k is not an error: the reference's KnnQuery raises
    it to k, and both packages answer 200 with the same hits."""
    name = "clamp"
    field = {"type": "dense_vector", "dims": D, "similarity": "cosine",
             "index_options": {"type": "ivf"}}
    rng, vecs = _clustered_docs(91)
    _load_ivf_pair(clients, name, field, vecs)
    ref, port = clients
    q = vecs[11] + 0.3 * rng.standard_normal(D)
    body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                    "num_candidates": 5}}
    s1, want = ref.req("POST", f"/{name}/_search", body)
    s2, got = port.req("POST", f"/{name}/_search", body)
    assert s1 == s2 == 200
    assert len(got["hits"]["hits"]) == 10
    _same_hits(want, got)


def test_knn_settings_validation_matches_reference(clients):
    ref, port = clients
    for i, (settings, props) in enumerate((
            ({"index.knn.engine": "hnsw"}, None),
            ({"index": {"knn": {"nlist": 0}}}, None),
            ({"knn.nlist": "many"}, None),
            ({"index.knn.nprobe": -1}, None),
            ({"index": {"knn": {"nprobe": "most"}}}, None),
            (None, {"type": "int4_flat"}),
            (None, {"type": "int4_ivf", "nlist": 0}),
            (None, {"type": "ivf", "nprobe": "x"}),
            (None, {"type": "hnsw"}))):
        field = {"type": "dense_vector", "dims": 5 if props else 4}
        if props:
            field["index_options"] = props
        body = {"mappings": {"properties": {"v": field}}}
        if settings:
            body["settings"] = settings
        s1, want = ref.req("PUT", f"/bad{i}", body)
        s2, got = port.req("PUT", f"/bad{i}", body)
        assert s1 == s2 == 400, (settings, props, want, got)
        assert got["error"]["type"] == want["error"]["type"]
        if props is None or props["type"] != "hnsw":
            # the unknown-type message lists the rungs each package serves
            assert got["error"]["reason"] == want["error"]["reason"]
    for settings in ({"index.knn.engine": "tpu_ivf", "index.knn.nprobe": 8},
                     {"index": {"knn": {"engine": "tpu",
                                        "nprobe": "auto"}}}):
        body = {"settings": settings, "mappings": {"properties": {
            "v": {"type": "dense_vector", "dims": 4}}}}
        assert port.req("PUT", "/good", body)[0] == 200
        store = port.node.index("good").store
        assert store.knn_engine == settings.get(
            "index.knn.engine", "tpu")
        port.node.indices.pop("good")


def test_hybrid_queue_at_depth_1_answers_429_like_reference(clients):
    """With one request in the runner's held dispatch and one queued, a
    third hybrid request finds the queue full at depth 1: a 429 with the
    reference's error body; the other two are served."""
    import threading
    import time
    from elasticsearch_tpu.search.hybrid_plan import (
        HybridExecutor as RefHybridExecutor)
    from elasticsearch_tpu_torch.search.hybrid_plan import HybridExecutor
    ref, port = clients
    rng = np.random.default_rng(61)
    create = {"settings": {"number_of_shards": 1, "number_of_replicas": 0},
              "mappings": {"properties": {
                  "emb": {"type": "dense_vector", "dims": D,
                          "similarity": "cosine"},
                  "colv": {"type": "rank_vectors", "dims": 8}}}}
    bulk = []
    for i in range(40):
        bulk += [{"index": {"_id": str(i)}},
                 {"emb": rng.standard_normal(D).tolist(),
                  "colv": rng.standard_normal((3, 8)).tolist()}]
    body = {"rank": {"rrf": {}}, "size": 5, "sub_searches": [
        {"query": {"knn": {"field": "emb",
                           "query_vector": rng.standard_normal(D).tolist(),
                           "k": 5}}},
        {"query": {"late_interaction": {
            "field": "colv",
            "query_tokens": rng.standard_normal((2, 8)).tolist()}}}]}
    executors = {
        "ref": lambda svc: RefHybridExecutor(
            ref.node, svc, max_batch=2, max_queue_depth=1,
            deadline_ms=None),
        "port": lambda svc: HybridExecutor(
            svc, "cpu", max_batch=2, max_queue_depth=1, deadline_ms=None)}
    seen = {}
    for name, client in (("ref", ref), ("port", port)):
        assert client.req("PUT", "/h", create)[0] == 200
        assert not client.req("POST", "/h/_bulk", bulk, ndjson=True)[1][
            "errors"]
        assert client.req("POST", "/h/_refresh")[0] == 200
        svc = (client.node.indices.indices if name == "ref"
               else client.node.indices)["h"]
        ex = executors[name](svc)
        inner = ex.batcher._dispatch_fn
        started, gate = threading.Event(), threading.Event()

        def held(bodies, inner=inner, started=started, gate=gate):
            started.set()
            assert gate.wait(10)
            return inner(bodies)

        ex.batcher._dispatch_fn = held
        client.node._hybrid["h"] = ex
        statuses = []
        first = threading.Thread(target=lambda: statuses.append(
            client.req("POST", "/h/_search", body)[0]))
        first.start()
        assert started.wait(10)
        queued = threading.Thread(target=lambda: statuses.append(
            client.req("POST", "/h/_search", body)[0]))
        queued.start()
        deadline = time.monotonic() + 10
        while ex.batcher.pending() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        status, resp = client.req("POST", "/h/_search", body)
        gate.set()
        for t in (first, queued):
            t.join(10)
            assert not t.is_alive()
        seen[name] = (status, resp["status"], resp["error"]["type"],
                      resp["error"]["root_cause"][0]["type"], statuses,
                      ex.batcher.stats["rejected_depth"])
    assert seen["port"] == seen["ref"]
    assert seen["port"] == (429, 429, "es_rejected_execution_exception",
                            "es_rejected_execution_exception", [200, 200],
                            1)


def test_32_http_clients_at_once_get_the_sequential_answers():
    """32 clients connect at once (the listen backlog holds them) and send
    4 knn searches each on keep-alive connections: every answer is the
    one the same query got alone (ids where scores are clear of ties: a
    batch runs at another query bucket than a single query), and the
    store served them in fewer batches than requests."""
    import threading
    node, server = build_server(device="cpu", port=0)
    server.start()
    rng = np.random.default_rng(67)
    vecs = rng.standard_normal((500, D)).astype(np.float32)
    queries = rng.standard_normal((16, D)).astype(np.float32)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)

        def req(conn, method, path, body=None, ndjson=False):
            conn.request(method, path, body=_raw(body, ndjson),
                         headers={"content-type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        assert req(conn, "PUT", "/c", {"mappings": {"properties": {
            "v": {"type": "dense_vector", "dims": D}}}})[0] == 200
        bulk = []
        for i, v in enumerate(vecs):
            bulk += [{"index": {"_id": str(i)}}, {"v": v.tolist()}]
        assert not req(conn, "POST", "/c/_bulk", bulk, ndjson=True)[1][
            "errors"]
        req(conn, "POST", "/c/_refresh")

        def body(qi):
            # opted out of the request cache: the store must batch them
            return {"knn": {"field": "v", "query_vector": queries[qi].tolist(),
                            "k": 5}, "request_cache": False}

        alone = [req(conn, "POST", "/c/_search", body(qi))[1]
                 for qi in range(16)]
        conn.close()
        store = node.index("c").vector_store
        sched0 = store.scheduler_stats()
        barrier = threading.Barrier(32)
        got, errors = {}, []

        def client(c):
            try:
                mine = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=30)
                barrier.wait(10)
                for r in range(4):
                    qi = (c + r) % 16
                    status, resp = req(mine, "POST", "/c/_search", body(qi))
                    got[(c, r)] = (qi, status, resp)
                mine.close()
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert not errors and len(got) == 128
        for qi, status, resp in got.values():
            assert status == 200
            _same_hits(alone[qi], resp)
        sched = store.scheduler_stats()
        assert sched["requests"] - sched0["requests"] == 128
        assert sched["batches"] - sched0["batches"] < 128
    finally:
        server.stop()
