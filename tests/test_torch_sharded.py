"""Multi-shard indices through the port on the CPU, against the reference
`Node` on the same numpy-seeded documents and bodies.

Documents are routed by murmur3 of their routing value or `_id` (both
packages' `cluster/routing.py`), every shard keeps its own engine and
vector store, a search reads one combined reader (rows rebased by
shard_id * 2^40), each shard's store gets its own filter rows, and a
stable host merge takes the top k with ties broken by shard order.

The reference takes its mesh path for an index of 2 to 8 shards on the 8
CPU devices the test configuration gives JAX: one exact bf16 program over
every shard, whatever the field's encoding. The port has one card and
runs the per-shard path, so these tests patch the reference's
`_MultiShardVectorStore._mesh_state` to None (its behaviour on a host with
fewer devices than shards), except the one flat index that keeps the mesh
path, where both sides are exact. The IVF indices load one segment a
shard (the reference serves more segments, or a tombstone, through its
generational route) and carry each shard's trained layout from the
reference into the port's same shard. `int4_ivf` answers no filtered
request here: a filter sends it to its int4 flat corpus, whose bf16
scoring the reference cannot run on the CPU.

Tolerances are those of the existing parity tests: `_score`s within 1e-5
(flat, int8 + rescore, the mesh path; 1e-4 for IVF), hit ids equal where
the reference's scores are more than 1e-4 apart, totals and `_shards`
equal, hybrid RRF hits and scores equal."""

import json

import numpy as np
import pytest

from elasticsearch_tpu.cluster import routing as ref_routing
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.node import _MultiShardVectorStore as RefMultiStore
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.cluster import routing
from elasticsearch_tpu_torch.indices.service import SHARD_ROW_SPACE
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController

D, K = 16, 10
COLORS = ["red", "green", "blue"]
SHARDS = [3, 8]
RUNGS = {
    "flat": {"type": "flat"},
    "int8": {"type": "int8_flat", "rescore": True},
    "int8ivf": {"type": "int8_ivf"},
    "int4ivf": {"type": "int4_ivf"},
}
FILTERS = {
    "term": {"term": {"color": "red"}},
    "range": {"range": {"width": {"gte": 300, "lt": 900}}},
    "bool": {"bool": {"filter": [{"term": {"color": "blue"}},
                                 {"term": {"safe": True}}],
                      "must_not": [{"range": {"width": {"lt": 200}}}]}},
}
# Murmur3HashFunctionTests.java's known values, the reference's own check
KNOWN_HASHES = {
    "hell": 0x5A0CB7C3, "hello": 0xD7C31989, "hello w": 0x22AB2984,
    "hello wo": 0xDF0CA123, "hello wor": 0xE7744D61,
    "The quick brown fox jumps over the lazy dog": 0xE07DB09C,
    "The quick brown fox jumps over the lazy cog": 0x4E63D2AD,
}


def _raw(body, ndjson=False):
    if body is None:
        return b""
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return json.dumps(body).encode()


def _mapping(options=None):
    vec = {"type": "dense_vector", "dims": D, "similarity": "cosine"}
    if options is not None:
        vec["index_options"] = options
    return {"properties": {"v": vec, "color": {"type": "keyword"},
                           "width": {"type": "integer"},
                           "safe": {"type": "boolean"}}}


def _docs(seed, n):
    """n documents: clustered vectors, a color, a width, a safe flag."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 12, n)]
            + 0.4 * rng.standard_normal((n, D))).astype(np.float32)
    docs = [{"v": vecs[i].tolist(), "color": COLORS[int(rng.integers(3))],
             "width": int(rng.integers(0, 1200)),
             "safe": bool(rng.random() < 0.7)} for i in range(n)]
    return rng, vecs, docs


class Pair:
    """Both packages' REST layers over one node each."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port
        self.ref_rc, self.port_rc = RefController(), RestController()
        ref_register(self.ref_rc, ref)
        register_all(self.port_rc, port)

    def ref_req(self, method, path, body=None, ndjson=False, query=None):
        return self.ref_rc.dispatch(method, path, dict(query or {}),
                                    _raw(body, ndjson), "application/json")

    def port_req(self, method, path, body=None, ndjson=False, query=None):
        return self.port_rc.dispatch(method, path, dict(query or {}),
                                     _raw(body, ndjson))

    def both(self, method, path, body=None, ndjson=False, query=None):
        return (self.ref_req(method, path, body, ndjson, query),
                self.port_req(method, path, body, ndjson, query))

    def ok(self, method, path, body=None, ndjson=False, query=None):
        (s1, r1), (s2, r2) = self.both(method, path, body, ndjson, query)
        assert s1 == s2 and s1 in (200, 201), (r1, r2)
        if isinstance(r1, dict) and "errors" in r1:
            assert not r1["errors"] and not r2["errors"], (r1, r2)
        return r1, r2

    def carry_layouts(self, name):
        """Each shard's trained IVF layout, reference → port (the two
        packages' k-means RNGs differ)."""
        ref_svc = self.ref.indices.indices[name]
        for ref_shard, shard in zip(ref_svc.shards,
                                    self.port.index(name).shards):
            shard.vector_store.restore_ivf_layout(
                ref_shard.vector_store.export_ivf_layout())


MESH_INDEX = "meshflat"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    mesh_state = RefMultiStore._mesh_state
    # the per-shard path everywhere but the one index that keeps the mesh
    mp.setattr(RefMultiStore, "_mesh_state",
               lambda self, field: mesh_state(self, field)
               if self.svc.name == MESH_INDEX else None)
    ref = RefNode(str(tmp_path_factory.mktemp("ref")))
    p = Pair(ref, Node(device="cpu"))
    yield p
    ref.close()
    mp.undo()


@pytest.fixture(scope="module")
def knn_indices(pair):
    """One index a (shard count, rung): 600 documents a shard. Flat rungs
    get two segments a shard and three updates (tombstones); IVF rungs one
    segment a shard, each shard's layout carried over."""
    queries = {}
    for shards in SHARDS:
        n = 600 * shards
        rng, vecs, docs = _docs(shards, n)
        queries[shards] = (vecs[rng.integers(0, n, 3)]
                           + 0.3 * rng.standard_normal((3, D))).astype(
                               np.float32)
        for rung, options in RUNGS.items():
            name = f"{rung}{shards}"
            ivf = rung.endswith("ivf")
            pair.ok("PUT", f"/{name}", {
                "settings": {"number_of_shards": shards,
                             "number_of_replicas": 0, "index.knn.nlist": 8},
                "mappings": _mapping(options)})
            cuts = ((0, n),) if ivf else ((0, n // 2), (n // 2, n))
            for lo, hi in cuts:
                bulk = []
                for i in range(lo, hi):
                    bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
                s1, r1 = pair.ref_req("POST", f"/{name}/_bulk", bulk,
                                      ndjson=True)
                assert s1 == 200 and not r1["errors"]
                if ivf:
                    pair.ref_req("POST", f"/{name}/_refresh")
                    pair.carry_layouts(name)
                s2, r2 = pair.port_req("POST", f"/{name}/_bulk", bulk,
                                       ndjson=True)
                assert s2 == 200 and not r2["errors"]
                if ivf:
                    pair.port_req("POST", f"/{name}/_refresh")
                else:
                    pair.ok("POST", f"/{name}/_refresh")
            if not ivf:
                for i in (5, 77, n - 3):
                    pair.ok("PUT", f"/{name}/_doc/d{i}",
                            dict(docs[i], color="red", width=999))
                pair.ok("POST", f"/{name}/_refresh")
    return queries


def _same_hits(want, got, tol=1e-5):
    """Same total and `_shards`, ids equal where the reference's `_score`
    gaps exceed 1e-4, `_score`s within `tol`."""
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got["_shards"] == want["_shards"]
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(wh)
    if not wh:
        return
    ws = np.array([h["_score"] for h in wh])
    gs = np.array([h["_score"] for h in gh])
    np.testing.assert_allclose(gs, ws, atol=tol)
    gap = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                     np.abs(np.diff(ws, append=-np.inf)))
    for j in np.nonzero(gap > 1e-4)[0]:
        assert gh[j]["_id"] == wh[j]["_id"]


def _knn(q, **extra):
    return dict({"field": "v", "query_vector": q.tolist(), "k": K,
                 "num_candidates": 50}, **extra)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("num_shards", [1, 3, 5, 8, 1024])
def test_shard_id_for_matches_reference(num_shards):
    """2,000 keys: decimal ids, random ids with non-ASCII (BMP and astral)
    characters, and explicit routing values; the vectorized form too."""
    rng = np.random.default_rng(num_shards)
    keys = [str(i) for i in range(1000)]
    for _ in range(800):
        n = int(rng.integers(0, 14))
        keys.append("".join(chr(int(c)) for c in rng.integers(32, 0x2FFF, n)))
    keys += [f"user-{i}" for i in range(150)]
    keys += ["😀", "a😀b", "ß", "routing/ü", "", "0", "-1"] * 5
    keys += [f"r{i}" for i in range(2000 - len(keys))]
    want = [ref_routing.shard_id_for(k, num_shards) for k in keys]
    assert [routing.shard_id_for(k, num_shards) for k in keys] == want
    np.testing.assert_array_equal(routing.shard_ids_for(keys, num_shards),
                                  want)


@pytest.mark.parametrize("text", sorted(KNOWN_HASHES))
def test_murmur3_known_values(text):
    want = KNOWN_HASHES[text]
    assert routing.hash_routing(text) & 0xFFFFFFFF == want
    assert ref_routing.hash_routing(text) & 0xFFFFFFFF == want


def test_multi_node_layout_matches_reference():
    """`tests/test_multi_node.py` lays its documents out by
    `shard_id_for(str(i), 3)`: the port places them alike."""
    assert [routing.shard_id_for(str(i), 3) for i in range(60)] \
        == [ref_routing.shard_id_for(str(i), 3) for i in range(60)]


def test_chip_smoke_routing_tables_are_the_reference():
    """`chip_smoke.py` gates serve_sharded's placement on tables written
    into it: the known murmur3 values and the reference's shard of 8 for
    sampled ids and routing values."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.KNOWN_MURMUR3 == KNOWN_HASHES
    assert smoke.REF_SHARD_OF_8 == {
        key: ref_routing.shard_id_for(key, 8) for key in smoke.REF_SHARD_OF_8}
    assert smoke.SHARDS == 8


@pytest.mark.parametrize("shards", [0, 1025, -1])
def test_number_of_shards_out_of_bounds_is_the_reference_400(pair, shards):
    body = {"settings": {"number_of_shards": shards}}
    (s1, want), (s2, got) = pair.both("PUT", f"/bad{shards + 2}", body)
    assert s1 == s2 == 400
    assert got["error"]["type"] == want["error"]["type"]
    assert got["error"]["reason"] == want["error"]["reason"]


def test_index_many_places_documents_as_bulk_does(pair):
    """`IndexService.index_many(vectors=)` sends each id to the shard
    `_bulk` sends it to: the reference loaded over `_bulk`, the port from
    arrays, the same ids in each shard and the same hits."""
    rng, vecs, docs = _docs(5, 900)
    name = "arrays"
    pair.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 5},
                                "mappings": _mapping()})
    bulk = []
    for i in range(900):
        bulk += [{"index": {"_id": str(i)}}, {"v": docs[i]["v"]}]
    assert not pair.ref_req("POST", f"/{name}/_bulk", bulk,
                            ndjson=True)[1]["errors"]
    svc = pair.port.index(name)
    res = svc.index_many([str(i) for i in range(900)], vectors={"v": vecs})
    assert [r.doc_id for r in res] == [str(i) for i in range(900)]
    pair.ok("POST", f"/{name}/_refresh")
    ref_svc = pair.ref.indices.indices[name]
    for ref_shard, shard in zip(ref_svc.shards, svc.shards):
        got = sorted(shard.engine.version_map)
        assert got == sorted(ref_shard.engine.version_map)
        assert got == sorted(
            str(i) for i in range(900)
            if routing.shard_id_for(str(i), 5) == shard.shard_id)
    assert svc.doc_count() == 900
    for q in vecs[:3] + 0.1:
        (s1, want), (s2, got) = pair.both("POST", f"/{name}/_search",
                                          {"knn": _knn(q), "size": K})
        assert s1 == s2 == 200
        _same_hits(want, got)


# ---------------------------------------------------------------- kNN parity

@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_knn_matches_reference(pair, knn_indices, shards, rung):
    name = f"{rung}{shards}"
    tol = 1e-4 if rung.endswith("ivf") else 1e-5
    for q in knn_indices[shards]:
        (s1, want), (s2, got) = pair.both(
            "POST", f"/{name}/_search", {"knn": _knn(q), "size": K})
        assert s1 == s2 == 200, (want, got)
        assert got["_shards"]["total"] == shards
        _same_hits(want, got, tol)
    if rung.endswith("ivf"):
        for shard in pair.port.index(name).shards:
            stats = shard.vector_store.knn_stats
            assert stats["ivf_searches"] >= 3
            assert stats["fallback_searches"] == 0
            assert stats["ivf_trains"] == 0 and stats["ivf_restores"] == 1


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("rung", ["flat", "int8", "int8ivf"])
@pytest.mark.parametrize("fname", sorted(FILTERS))
def test_filtered_knn_matches_reference(pair, knn_indices, shards, rung,
                                        fname):
    name = f"{rung}{shards}"
    for q in knn_indices[shards]:
        body = {"knn": _knn(q, filter=FILTERS[fname]), "size": K}
        (s1, want), (s2, got) = pair.both("POST", f"/{name}/_search", body)
        assert s1 == s2 == 200, (want, got)
        _same_hits(want, got)
        # every shard's store saw only its own rows' filter
        for shard in pair.port.index(name).shards:
            if rung.endswith("ivf"):
                assert shard.vector_store.last_knn_phases[
                    "fallback_reason"] == "filtered"


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", ["list", "with_query", "query_alone"])
def test_knn_list_query_and_query_alone_match_reference(pair, knn_indices,
                                                       shards, case):
    qs = knn_indices[shards]
    body = {"size": 20}
    if case == "list":
        body["knn"] = [_knn(qs[0]), _knn(qs[1], k=5, filter=FILTERS["term"],
                                         boost=2.0)]
    elif case == "with_query":
        body.update(knn=_knn(qs[2]), query={"bool": {
            "filter": {"term": {"safe": True}},
            "should": {"range": {"width": {"lt": 100}}}}})
    else:
        body["query"] = {"bool": {"filter": [FILTERS["range"]],
                                  "should": [FILTERS["term"]]}}
    for rung in ("flat", "int8"):
        (s1, want), (s2, got) = pair.both(
            "POST", f"/{rung}{shards}/_search", body)
        assert s1 == s2 == 200, (want, got)
        _same_hits(want, got)
        if case == "query_alone":
            assert [h["_id"] for h in got["hits"]["hits"]] \
                == [h["_id"] for h in want["hits"]["hits"]]


@pytest.mark.parametrize("rung", ["flat", "int8ivf"])
def test_concurrent_searches_share_one_batch_on_every_shard(
        pair, knn_indices, rung):
    """8 concurrent `_search {knn}` requests on a 3-shard index: the first
    runs alone, held until the other 7 queue in the index's batcher; they
    then run as one batch, one dispatch a shard, and every answer equals
    the reference's. On the flat index filtered and unfiltered requests
    share the batch (a filter in an IVF batch sends the whole batch to the
    exhaustive corpus, which would better the reference's IVF answers)."""
    import threading
    import time
    name = f"{rung}3"
    svc = pair.port.index(name)
    multi = svc.vector_store
    rng = np.random.default_rng(29)
    qs = (knn_indices[3][rng.integers(0, 3, 8)]
          + 0.1 * rng.standard_normal((8, D))).astype(np.float32)
    bodies = [{"knn": _knn(q, filter=FILTERS["term"])
               if rung == "flat" and i % 3 == 1 else _knn(q), "size": K}
              for i, q in enumerate(qs)]
    wants = [pair.ref_req("POST", f"/{name}/_search", b)[1] for b in bodies]
    started, gate = threading.Event(), threading.Event()
    dispatch = multi._dispatch_batch

    def held(requests):
        if not started.is_set():
            started.set()
            assert gate.wait(10)
        return dispatch(requests)

    multi._dispatch_batch = held
    sched0 = multi.scheduler_stats()
    searches0 = [s.vector_store.knn_stats["searches"] for s in svc.shards]
    got = [None] * len(bodies)

    def run(i):
        got[i] = pair.port_req("POST", f"/{name}/_search", bodies[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    try:
        threads[0].start()
        assert started.wait(10)
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 10
        while multi._batcher.pending() < 7:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        gate.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    finally:
        del multi._dispatch_batch
    for want, (status, resp) in zip(wants, got):
        assert status == 200
        _same_hits(want, resp, 1e-4 if rung.endswith("ivf") else 1e-5)
    sched = multi.scheduler_stats()
    assert (sched["batches"] - sched0.get("batches", 0),
            sched["requests"] - sched0.get("requests", 0)) == (2, 8)
    assert [s.vector_store.knn_stats["searches"] - n
            for s, n in zip(svc.shards, searches0)] == [2, 2, 2]


def test_hybrid_rrf_with_late_interaction_matches_reference(pair):
    """`rank: {rrf}` with a (filtered) knn leg and a late_interaction leg on
    a 3-shard index: the same fused hits and scores as the reference."""
    rng = np.random.default_rng(11)
    name = "hy3"
    pair.ok("PUT", f"/{name}", {
        "settings": {"number_of_shards": 3, "number_of_replicas": 0},
        "mappings": {"properties": {
            "emb": {"type": "dense_vector", "dims": D,
                    "similarity": "cosine"},
            "colv": {"type": "rank_vectors", "dims": 8},
            "tag": {"type": "keyword"}}}})
    bulk = []
    for i in range(120):
        bulk += [{"index": {"_id": f"h{i}"}},
                 {"emb": rng.standard_normal(D).astype(np.float32).tolist(),
                  "colv": rng.standard_normal(
                      (int(rng.integers(1, 5)), 8)).astype(
                          np.float32).tolist(),
                  "tag": f"t{i % 4}"}]
    pair.ok("POST", f"/{name}/_bulk", bulk, ndjson=True)
    pair.ok("POST", f"/{name}/_refresh")
    for filt in (None, {"term": {"tag": "t1"}},
                 {"bool": {"must_not": {"term": {"tag": "t2"}}}}):
        knn = {"field": "emb", "k": 8, "num_candidates": 20,
               "query_vector": rng.standard_normal(D).tolist()}
        if filt is not None:
            knn["filter"] = filt
        body = {"rank": {"rrf": {}}, "size": 10, "sub_searches": [
            {"query": {"knn": knn}},
            {"query": {"late_interaction": {
                "field": "colv",
                "query_tokens": rng.standard_normal((2, 8)).tolist()}}}]}
        (s1, want), (s2, got) = pair.both("POST", f"/{name}/_search", body)
        assert s1 == s2 == 200, (want, got)
        # the reference's fused hybrid response carries no `_shards`; the
        # port's counts the index's shards
        assert got["_shards"] == {"total": 3, "successful": 3, "skipped": 0,
                                  "failed": 0}
        assert got["hits"]["total"] == want["hits"]["total"]
        assert [h["_id"] for h in got["hits"]["hits"]] \
            == [h["_id"] for h in want["hits"]["hits"]]
        assert [h["_score"] for h in got["hits"]["hits"]] \
            == [h["_score"] for h in want["hits"]["hits"]]
        assert [h.get("_source") for h in got["hits"]["hits"]] \
            == [h.get("_source") for h in want["hits"]["hits"]]


def test_reference_mesh_path_agrees_within_exact_tolerance(pair):
    """A flat 8-shard index the reference serves through its mesh program
    (one exact bf16 scan over every shard) and the port shard by shard."""
    rng, vecs, docs = _docs(21, 2000)
    pair.ok("PUT", f"/{MESH_INDEX}", {"settings": {"number_of_shards": 8},
                                      "mappings": _mapping()})
    bulk = []
    for i in range(2000):
        bulk += [{"index": {"_id": f"m{i}"}}, docs[i]]
    pair.ok("POST", f"/{MESH_INDEX}/_bulk", bulk, ndjson=True)
    pair.ok("POST", f"/{MESH_INDEX}/_refresh")
    ref_svc = pair.ref.indices.indices[MESH_INDEX]
    assert RefMultiStore(ref_svc)._mesh_state("v") is not None
    for q in vecs[rng.integers(0, 2000, 4)] + 0.3:
        for extra in ({}, {"filter": FILTERS["bool"]}):
            (s1, want), (s2, got) = pair.both(
                "POST", f"/{MESH_INDEX}/_search",
                {"knn": _knn(q, **extra), "size": K})
            assert s1 == s2 == 200
            _same_hits(want, got)


# ------------------------------------------------------------ writes, GET

def test_writes_and_gets_by_routing_match_reference(pair):
    """PUT with `?routing=`, `_bulk` with `routing` in the metadata, GET
    with and without routing, `_routing` in GET and in hits, the
    reference's 400 for `_routing` in bulk metadata."""
    name = "rt"
    pair.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 5},
                                "mappings": _mapping()})
    rng, vecs, docs = _docs(9, 40)
    for i in range(10):
        r1, r2 = pair.ok("PUT", f"/{name}/_doc/p{i}", docs[i],
                         query={"routing": f"user{i % 3}"})
        assert r2 == r1
    bulk = []
    for i in range(10, 40):
        meta = {"_id": f"b{i}"}
        if i % 2:
            meta["routing"] = f"user{i % 4}"
        bulk += [{"index": meta}, docs[i]]
    r1, r2 = pair.ok("POST", f"/{name}/_bulk", bulk, ndjson=True)
    for a, b in zip(r1["items"], r2["items"]):
        (op_a, va), = a.items()
        (op_b, vb), = b.items()
        assert op_a == op_b and va["status"] == vb["status"]
        for key in ("_id", "_version", "result", "_seq_no", "_shards"):
            assert va[key] == vb[key], key
    # each document lies in the shard its routing names
    svc = pair.port.index(name)
    for i in range(40):
        doc_id = f"p{i}" if i < 10 else f"b{i}"
        key = (f"user{i % 3}" if i < 10 else
               f"user{i % 4}" if i % 2 else doc_id)
        assert doc_id in svc.shards[
            routing.shard_id_for(key, 5)].engine.version_map
    for i in list(range(10)) + list(range(10, 40, 7)):
        doc_id = f"p{i}" if i < 10 else f"b{i}"
        key = f"user{i % 3}" if i < 10 else f"user{i % 4}"
        for query in ({"routing": key}, {}, {"routing": "elsewhere"}):
            (s1, want), (s2, got) = pair.both(
                "GET", f"/{name}/_doc/{doc_id}", query=query)
            assert (s1, want) == (s2, got)
    pair.ok("POST", f"/{name}/_refresh")
    (s1, want), (s2, got) = pair.both(
        "POST", f"/{name}/_search", {"knn": _knn(vecs[3]), "size": 20})
    assert s1 == s2 == 200
    _same_hits(want, got)
    assert [h.get("_routing") for h in got["hits"]["hits"]] \
        == [h.get("_routing") for h in want["hits"]["hits"]]
    assert any("_routing" in h for h in got["hits"]["hits"])
    (s1, want), (s2, got) = pair.both(
        "POST", f"/{name}/_bulk",
        [{"index": {"_id": "x", "_routing": "u"}}, {"color": "red"}],
        ndjson=True)
    assert s1 == s2 == 400
    assert got["error"] == want["error"]


def test_bulk_over_two_indices_routes_each_index_in_one_call(
        pair, monkeypatch):
    """One `_bulk` over a 3-shard and a 5-shard index, `index` and `create`
    actions interleaved, routed and unrouted: the items match the
    reference's (each shard's seq_nos in the request's order), each
    document lies in the reference's shard, and the port hashed each
    index's documents in one `shard_ids_for` call."""
    from elasticsearch_tpu_torch import node as port_node
    calls = []
    hashed = port_node.shard_ids_for

    def counted(keys, num_shards):
        calls.append((len(keys), num_shards))
        return hashed(keys, num_shards)

    monkeypatch.setattr(port_node, "shard_ids_for", counted)
    for name, shards in (("bx3", 3), ("bx5", 5)):
        pair.ok("PUT", f"/{name}", {"settings": {"number_of_shards": shards},
                                    "mappings": _mapping()})
    rng, vecs, docs = _docs(13, 60)
    bulk = []
    for i in range(60):
        meta = {"_index": "bx3" if i % 3 else "bx5", "_id": f"m{i}"}
        if i % 4 == 1:
            meta["routing"] = f"tenant{i % 7}"
        bulk += [{"create" if i % 5 == 0 else "index": meta}, docs[i]]
    r1, r2 = pair.ok("POST", "/_bulk", bulk, ndjson=True)
    for a, b in zip(r1["items"], r2["items"]):
        (op_a, va), = a.items()
        (op_b, vb), = b.items()
        assert op_a == op_b and va["status"] == vb["status"]
        for key in ("_index", "_id", "_version", "result", "_seq_no"):
            assert va.get(key) == vb.get(key), key
    assert sorted(calls) == [(20, 5), (40, 3)]
    for name in ("bx3", "bx5"):
        ref_svc = pair.ref.indices.indices[name]
        for ref_shard, shard in zip(ref_svc.shards,
                                    pair.port.index(name).shards):
            assert sorted(shard.engine.version_map) \
                == sorted(ref_shard.engine.version_map)


@pytest.mark.parametrize("bad", [
    {"width": "wide"},                      # an unparseable integer
    {"v": [1.0] * (D - 1)},                 # a vector of the wrong dims
])
def test_bulk_item_that_fails_to_parse_takes_a_seq_no(pair, bad):
    """A `_bulk` over a 3-shard index with one document that fails to
    parse in the middle: the bad item takes a seq_no on the shard it
    routes to, as the reference's primary gives it one before it parses,
    so every item's `_seq_no`, `status` and `result` equal the
    reference's."""
    name = "bad" + str(len(bad["v"]) if "v" in bad else 0)
    pair.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 3},
                                "mappings": _mapping()})
    _rng, _vecs, docs = _docs(17, 30)
    bulk = []
    for i in range(30):
        doc = dict(docs[i], **bad) if i == 14 else docs[i]
        bulk += [{"index": {"_id": f"s{i}"}}, doc]
    (s1, r1), (s2, r2) = pair.both("POST", f"/{name}/_bulk", bulk,
                                   ndjson=True)
    assert s1 == s2 == 200 and r1["errors"] and r2["errors"]
    for a, b in zip(r1["items"], r2["items"]):
        (op_a, va), = a.items()
        (op_b, vb), = b.items()
        assert op_a == op_b
        for key in ("status", "result", "_seq_no", "_id"):
            assert va.get(key) == vb.get(key), (key, va, vb)
    assert "error" in r2["items"][14]["index"]


def test_doc_refresh_makes_only_its_shard_searchable(pair):
    """A document written with `?refresh=true` refreshes its own shard: the
    other shards' unrefreshed documents stay out of searches."""
    name = "rf"
    pair.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 3},
                                "mappings": _mapping()})
    _rng, _vecs, docs = _docs(13, 40)
    bulk = []
    for i in range(20):
        bulk += [{"index": {"_id": f"a{i}"}}, docs[i]]
    pair.ok("POST", f"/{name}/_bulk", bulk, ndjson=True)
    pair.ok("POST", f"/{name}/_refresh")
    for i in range(20, 39):
        pair.ok("PUT", f"/{name}/_doc/a{i}", docs[i])
    r1, r2 = pair.ok("PUT", f"/{name}/_doc/a39", docs[39],
                     query={"refresh": "true"})
    assert r1 == r2 and r2["forced_refresh"] is True
    target = routing.shard_id_for("a39", 3)
    want_ids = {f"a{i}" for i in range(20)} | {
        f"a{i}" for i in range(20, 40)
        if routing.shard_id_for(f"a{i}", 3) == target}
    body = {"query": {"match_all": {}}, "size": 100}
    (s1, want), (s2, got) = pair.both("POST", f"/{name}/_search", body)
    assert s1 == s2 == 200
    assert {h["_id"] for h in got["hits"]["hits"]} == want_ids
    assert {h["_id"] for h in want["hits"]["hits"]} == want_ids
    assert got["hits"]["total"] == want["hits"]["total"]
    assert len(want_ids) < 40


def test_ties_break_by_shard_order(pair):
    """Duplicate vectors placed on different shards (two a shard, by
    routing): the tied hits come back in the reference's order, shard by
    shard, and the top k keeps the lower shards' copies."""
    name = "tie"
    pair.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 3},
                                "mappings": _mapping()})
    keys = {}
    for j in range(200):
        keys.setdefault(routing.shard_id_for(f"k{j}", 3), f"k{j}")
        if len(keys) == 3:
            break
    v = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    rng, _vecs, docs = _docs(17, 30)
    bulk = []
    for i, doc in enumerate(docs):
        bulk += [{"index": {"_id": f"o{i}"}}, doc]
    # copies on shards 2, 1, 0, in that order of ids
    for s in (2, 1, 0):
        for c in range(2):
            bulk += [{"index": {"_id": f"dup{s}{c}", "routing": keys[s]}},
                     {"v": v.tolist(), "color": "red"}]
    pair.ok("POST", f"/{name}/_bulk", bulk, ndjson=True)
    pair.ok("POST", f"/{name}/_refresh")
    for k in (3, 4, 6, 8):
        body = {"knn": {"field": "v", "query_vector": v.tolist(), "k": k,
                        "num_candidates": k}, "size": k}
        (s1, want), (s2, got) = pair.both("POST", f"/{name}/_search", body)
        assert s1 == s2 == 200
        want_ids = [h["_id"] for h in want["hits"]["hits"]]
        assert [h["_id"] for h in got["hits"]["hits"]] == want_ids
        dups = [i for i in want_ids if i.startswith("dup")]
        assert dups == sorted(dups)[:len(dups)]
        assert dups[0] == "dup00"


# ------------------------------------------------------- `_source`, tokens

@pytest.mark.parametrize("shards", [1, 3])
def test_source_comes_back_as_sent(pair, shards):
    name = f"src{shards}"
    pair.ok("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {
            "v": {"type": "dense_vector", "dims": 4,
                  "similarity": "cosine"},
            "kw": {"type": "keyword"},
            "c": {"type": "rank_vectors", "dims": 2}}}})
    sources = {"s1": {"v": [0.1, 0.2, 0.3, 0.4], "kw": "x"},
               "s2": {"kw": "y", "v": [1, 0.5, 0.25, 0.125],
                      "c": [[0.1, 0.7], [0.3, 0.3]]},
               "s3": {"c": [[1, 2]], "kw": ["a", "b"], "v": [3, 1, 2, 0.3]}}
    for doc_id, src in sources.items():
        pair.ok("PUT", f"/{name}/_doc/{doc_id}", src)
        (s1, want), (s2, got) = pair.both("GET", f"/{name}/_doc/{doc_id}")
        assert (s1, want) == (s2, got)
        assert list(got["_source"]) == list(src)
        assert got["_source"] == src
    pair.ok("POST", f"/{name}/_refresh")
    (s1, want), (s2, got) = pair.both("POST", f"/{name}/_search", {
        "knn": {"field": "v", "query_vector": [0.1, 0.2, 0.3, 0.4],
                "k": 3}})
    assert s1 == s2 == 200
    assert [h["_source"] for h in got["hits"]["hits"]] \
        == [h["_source"] for h in want["hits"]["hits"]]
    assert [list(h["_source"]) for h in got["hits"]["hits"]] \
        == [list(h["_source"]) for h in want["hits"]["hits"]]
    for doc_id in sources:
        (s1, want), (s2, got) = pair.both("GET", f"/{name}/_doc/{doc_id}")
        assert (s1, want) == (s2, got)


@pytest.mark.parametrize("case", ["empty", "ragged", "flat_vector"])
def test_rank_vectors_values_match_reference(pair, case):
    """`[]` indexes a document without tokens (201); ragged rows and a flat
    vector are the reference's 400 `mapper_parsing_exception`."""
    name = f"rv{case}".replace("_", "")
    pair.ok("PUT", f"/{name}", {
        "settings": {"number_of_shards": 3},
        "mappings": {"properties": {
            "c": {"type": "rank_vectors", "dims": 2}}}})
    value = {"empty": [], "ragged": [[1, 2], [3]],
             "flat_vector": [1, 2]}[case]
    (s1, want), (s2, got) = pair.both("PUT", f"/{name}/_doc/1", {"c": value})
    assert s1 == s2, (want, got)
    if case == "empty":
        assert s2 == 201
        assert got == want
        (s1, want), (s2, got) = pair.both("GET", f"/{name}/_doc/1")
        assert (s1, want) == (s2, got)
        assert got["_source"] == {"c": []}
    else:
        assert s2 == 400
        assert got["error"]["type"] == want["error"]["type"] \
            == "mapper_parsing_exception"
        assert got["error"]["reason"] == want["error"]["reason"]


# --------------------------------------------------------- rows and readers

def test_combined_reader_rebases_rows_and_is_memoized():
    """Rows of shard s start at s * 2^40 (int64), the reader is the same
    object until a shard refreshes, and a term filter and a knn search on
    the last shards of a 1024-shard index stay in the combined space (the
    stores only ever see their own rows)."""
    node = Node(device="cpu")
    node.create_index("wide", {
        "settings": {"number_of_shards": 1024},
        "mappings": _mapping()})
    svc = node.index("wide")
    ids = [str(i) for i in range(5000)]
    far = [i for i in ids if routing.shard_id_for(i, 1024) >= 1000][:12]
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((len(far), D)).astype(np.float32)
    svc.index_many(far, sources=[{"color": "red" if j % 2 else "blue"}
                                 for j in range(len(far))],
                   vectors={"v": vecs})
    svc.refresh()
    reader = svc.combined_reader()
    assert svc.combined_reader() is reader
    rows = reader.live_global_rows()
    assert rows.dtype == np.int64 and len(rows) == len(far)
    assert rows.min() >= 1000 * SHARD_ROW_SPACE
    for row in rows:
        shard = svc.shard_of_row(row)
        assert reader.get_id(int(row)) in shard.engine.version_map
        assert shard.shard_id == int(row) // SHARD_ROW_SPACE
    resp = node.search("wide", {
        "knn": {"field": "v", "query_vector": vecs[3].tolist(), "k": 5,
                "filter": {"term": {"color": "red"}}}, "size": 5})
    assert resp["_shards"]["total"] == 1024
    hits = resp["hits"]["hits"]
    assert hits[0]["_id"] == far[3]
    assert len(hits) == 5 and all(
        far.index(h["_id"]) % 2 for h in hits)
    node.index_doc("wide", far[0], {"color": "green"}, refresh="true")
    assert svc.combined_reader() is not reader
    with pytest.raises(ValueError, match="1024 shards"):
        svc.engine


def test_search_many_merges_like_search():
    """The batched scatter-gather (every shard launched before any lands)
    gives each query the answer of a one-query search."""
    from elasticsearch_tpu_torch.node import _MultiShardVectorStore
    node = Node(device="cpu")
    node.create_index("sm", {"settings": {"number_of_shards": 4},
                             "mappings": _mapping()})
    svc = node.index("sm")
    rng, vecs, docs = _docs(23, 400)
    svc.index_many([f"d{i}" for i in range(400)], sources=docs)
    svc.refresh()
    reader = svc.combined_reader()
    store = _MultiShardVectorStore(svc)
    qs = list(vecs[:5] + 0.2)
    filters = [None, reader.live_global_rows()[::3], None,
               np.zeros(0, dtype=np.int64), reader.live_global_rows()[:50]]
    batch = store.search_many("v", qs, K, filter_rows=filters, reader=reader)
    for q, fr, (rows, scores) in zip(qs, filters, batch):
        one_rows, one_scores = store.search("v", q, K, filter_rows=fr,
                                            reader=reader)
        np.testing.assert_allclose(scores, one_scores, atol=1e-6)
        np.testing.assert_array_equal(rows, one_rows)
        if fr is not None:
            assert np.isin(rows, fr).all()
    assert len(batch[3][0]) == 0
