"""Hybrid BM25 + kNN `rank: {rrf}` search (BASELINE config 3's body)
through the port's REST layer on the CPU against the reference `Node`, on
the same PUT, `_bulk`, `_refresh` and `_search` sequence, at 1 and 3
shards: `query` + `knn` and `sub_searches` forms, `operator: and`,
minimum_should_match, a `term` lexical leg, a generic `range` leg, text
that analyzes to nothing, a `sparse_vector` on the text field (a generic
leg with no hits), pagination and rank parameters. RRF depends
only on each leg's ranks, so the fused `_score`s must be equal as f64,
the hit `_id`s equal, and `hits.total` equal. Concurrent bodies that form
one batch give their sequential answers with one BM25 board a text field
for the batch."""

import json
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController

D = 16
N_DOCS = 240
VOCAB = 120


def _raw(body, ndjson=False):
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return b"" if body is None else json.dumps(body).encode()


def _text(rng, n):
    p = 1.0 / np.arange(1, VOCAB + 1)
    p /= p.sum()
    return " ".join(f"w{r}" for r in rng.choice(VOCAB, n, p=p))


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request, tmp_path_factory):
    """Both nodes with the same documents in index `hb`: a text body, a
    second text field under the english analyzer, a vector, an integer;
    two segments and updates; yields (reference dispatch, port dispatch,
    port node, vectors)."""
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

    rng = np.random.default_rng(51)
    emb = rng.standard_normal((N_DOCS, D)).astype(np.float32)
    docs = []
    for i in range(N_DOCS):
        doc = {"body": _text(rng, int(rng.integers(1, 30))),
               "title": " ".join(rng.choice(
                   ["running", "runs", "engines", "searching", "fox"], 2)),
               "emb": emb[i].tolist(), "n": int(rng.integers(0, 100))}
        if i % 31 == 4:
            del doc["emb"]
        if i % 37 == 9:
            del doc["body"]
        docs.append(doc)
    create = {"settings": {"number_of_shards": request.param},
              "mappings": {"properties": {
                  "body": {"type": "text"},
                  "title": {"type": "text", "analyzer": "english"},
                  "emb": {"type": "dense_vector", "dims": D,
                          "similarity": "cosine"},
                  "n": {"type": "integer"}}}}
    for req in (ref_req, port_req):
        assert req("PUT", "/hb", create)[0] == 200
        for lo, hi in ((0, 150), (150, N_DOCS)):
            bulk = []
            for i in range(lo, hi):
                bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
            status, resp = req("POST", "/hb/_bulk", bulk, ndjson=True)
            assert status == 200 and not resp["errors"]
            assert req("POST", "/hb/_refresh")[0] == 200
        for i in (2, 160):
            assert req("PUT", f"/hb/_doc/d{i}", docs[i + 1])[0] in (200, 201)
        assert req("POST", "/hb/_refresh")[0] == 200
    yield ref_req, port_req, port, emb
    ref.close()
    mp.undo()


def _knn(emb, i, k=10):
    return {"field": "emb", "query_vector": (emb[i] + 0.2).tolist(),
            "k": k, "num_candidates": 40}


def _body(emb, i, match=None, **extra):
    return {"query": {"match": {"body": match or f"w1 w{i % 30} w{i % 7}"}},
            "knn": _knn(emb, i), "rank": {"rrf": {}}, **extra}


def _subs(emb, i, *queries, **extra):
    return {"sub_searches": [{"query": q} for q in queries]
            + [{"query": {"knn": _knn(emb, i)}}], "rank": {"rrf": {}},
            **extra}


def _same(want, got):
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
    assert [h["_score"] for h in gh] == [h["_score"] for h in wh]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]
    for g, w in zip(gh, wh):
        assert g.get("_source") == w.get("_source")


CASES = {
    "query_knn": lambda e: _body(e, 3),
    "repeated_and_oov": lambda e: _body(e, 4, match="w2 zzz w2 w9"),
    "and": lambda e: _body(e, 5, match={"query": "w1 w3", "operator": "and"}),
    "msm": lambda e: _body(e, 6, match={"query": "w1 w4 w5 w8",
                                        "minimum_should_match": "75%"}),
    "boost": lambda e: _body(e, 7, match={"query": "w3 w11", "boost": 2.0}),
    "empty_text": lambda e: _body(e, 8, match="!!! ??"),
    "english": lambda e: _subs(e, 9, {"match": {"title": "run engine"}}),
    "sub_searches": lambda e: _subs(e, 10, {"match": {"body": "w2 w6"}}),
    "term_leg": lambda e: _subs(e, 11, {"term": {"body": "w3"}}),
    "two_lexical": lambda e: _subs(e, 12, {"match": {"body": "w1 w13"}},
                                   {"match": {"title": "fox"}}),
    "generic_range": lambda e: _subs(e, 13, {"match": {"body": "w5"}},
                                     {"range": {"n": {"gte": 40}}}),
    "generic_bool": lambda e: _subs(e, 14, {"bool": {
        "must": {"match": {"body": "w1"}},
        "filter": {"range": {"n": {"lt": 70}}}}}),
    "generic_phrase": lambda e: _subs(e, 15, {"match_phrase": {
        "body": {"query": "w0 w1", "slop": 1}}}),
    "sparse_on_text": lambda e: _subs(e, 20, {"sparse_vector": {
        "field": "body", "query_vector": {"w1": 1.0}}}),
    "page": lambda e: _body(e, 16, size=5, **{"from": 3}),
    "deep": lambda e: _body(e, 17, size=60),
    "rank_params": lambda e: dict(_body(e, 18), rank={"rrf": {
        "rank_constant": 5, "rank_window_size": 7}}),
    "source": lambda e: _body(e, 19, _source=["n"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_bm25_matches_reference_node(nodes, case):
    ref_req, port_req, _port, emb = nodes
    body = CASES[case](emb)
    s1, want = ref_req("POST", "/hb/_search", body)
    s2, got = port_req("POST", "/hb/_search", body)
    assert s1 == s2 == 200, (want, got)
    _same(want, got)


def test_unparsed_sub_search_is_a_400(nodes):
    """No kind is left unparsed any more: `nested`, `prefix` and
    `more_like_this`, each once such a kind, are generic legs that answer
    as the reference."""
    ref_req, port_req, _port, emb = nodes
    for leg in ({"nested": {"path": "body", "query": {"match_all": {}}}},
                {"prefix": {"body": "w1"}},
                {"more_like_this": {"fields": ["body"], "like": "w1 w2 w1",
                                    "min_term_freq": 1,
                                    "min_doc_freq": 1}}):
        body = _subs(emb, 1, leg)
        s1, want = ref_req("POST", "/hb/_search", body)
        s2, got = port_req("POST", "/hb/_search", body)
        assert s1 == s2 == 200, (want, got)
        _same(want, got)


def _concurrently(port, calls, monkeypatch):
    """Run each call on its own thread through the index's hybrid batcher,
    the first one's dispatch held until the rest have queued behind it,
    so they form one batch. Returns their results."""
    ex = port._hybrid_executor(port.index("hb"))
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
        out[i] = calls[i]()

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


def test_concurrent_bodies_share_one_board_a_text_field(nodes, monkeypatch):
    """Nine bodies in two batches (the first held alone, eight queued
    behind it) give their sequential answers; the second batch scores its
    `body` legs in one board and its `title` legs in another."""
    _ref_req, port_req, port, emb = nodes
    names = ["query_knn", "repeated_and_oov", "and", "msm", "boost",
             "empty_text", "two_lexical", "generic_range", "page"]
    # each body opts out of the request cache: the test counts boards
    bodies = [dict(CASES[n](emb), request_cache=False) for n in names]
    want = [port_req("POST", "/hb/_search", b)[1] for b in bodies]
    boards = []
    board = bm25.bm25_board
    monkeypatch.setattr(bm25, "bm25_board", lambda ps, *a, **k: (
        boards.append(ps.shape[0] - 1), board(ps, *a, **k))[1])
    ex = port._hybrid_executor(port.index("hb"))
    batches = ex.stats["batches"]
    got = _concurrently(port, [
        (lambda b=b: port.search("hb", b)) for b in bodies], monkeypatch)
    for w, g in zip(want, got):
        _same(w, g)
    assert ex.stats["batches"] - batches == 2
    # batch 1: one body, one board; batch 2: the `body` legs of the seven
    # bodies with one (the empty text binds to no leg) and the `title`
    # leg, two boards
    assert len(boards) == 3
    assert boards[0] == 1
