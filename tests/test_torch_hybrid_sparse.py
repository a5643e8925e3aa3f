"""Learned-sparse search through the port's REST layer on the CPU against
the reference `Node`, on the same PUT, `_bulk`, `_refresh` and `_search`
sequence, at 1 and 3 shards: hybrid `rank: {rrf}` bodies with
`sparse_vector` and `weighted_tokens` sub-searches beside `knn` and
`match` (boosts, a 300-token body, which the reference sends to its host
walker and the port to the board, an empty token map, a sparse kind on a
text field), plain `sparse_vector`, `weighted_tokens` and `rank_feature`
queries (`rank_feature` inside `bool` too), `_source` as sent, and the
mappers' errors. RRF depends only on each leg's ranks, so the fused
`_score`s must be equal as f64; plain queries' `_score`s are the f32
scores, equal bit for bit. Concurrent bodies that form one batch give
their sequential answers with one board a feature-map field."""

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
from elasticsearch_tpu_torch.ops import bm25, sparse
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController

D = 16
N_DOCS = 240
VOCAB = 150


def _raw(body, ndjson=False):
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return b"" if body is None else json.dumps(body).encode()


def _fmap(rng, lo, hi, vocab=VOCAB):
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    toks = rng.choice(vocab, int(rng.integers(lo, hi)), replace=False, p=p)
    w = np.maximum(rng.uniform(0.0, 3.0, len(toks)).astype(np.float32), 1e-3)
    return {f"t{t}": float(x) for t, x in zip(toks, w)}


MAPPING = {"properties": {
    "tokens": {"type": "rank_features"},
    "legacy": {"type": "sparse_vector"},
    "pop": {"type": "rank_feature"},
    "body": {"type": "text"},
    "emb": {"type": "dense_vector", "dims": D, "similarity": "cosine"},
    "n": {"type": "integer"}}}


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request, tmp_path_factory):
    """Both nodes with the same documents in index `sp`: a feature map, a
    legacy sparse_vector map on some, a rank_feature, a text body, a
    vector, an integer; two segments and updates; yields (reference
    dispatch, port dispatch, port node, vectors)."""
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

    rng = np.random.default_rng(61)
    emb = rng.standard_normal((N_DOCS, D)).astype(np.float32)
    docs = []
    for i in range(N_DOCS):
        doc = {"tokens": _fmap(rng, 3, 40),
               "body": " ".join(rng.choice(["alpha", "beta", "gamma",
                                            "delta", "eps"], 3)),
               "pop": float(rng.uniform(0.5, 50.0)),
               "emb": emb[i].tolist(), "n": int(rng.integers(0, 100))}
        if i % 5 == 1:
            doc["legacy"] = _fmap(rng, 1, 6)
        if i % 31 == 4:
            del doc["tokens"]
        if i % 37 == 9:
            doc["tokens"] = {}
        docs.append(doc)
    create = {"settings": {"number_of_shards": request.param},
              "mappings": MAPPING}
    for req in (ref_req, port_req):
        assert req("PUT", "/sp", create)[0] == 200
        for lo, hi in ((0, 150), (150, N_DOCS)):
            bulk = []
            for i in range(lo, hi):
                bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
            status, resp = req("POST", "/sp/_bulk", bulk, ndjson=True)
            assert status == 200 and not resp["errors"]
            assert req("POST", "/sp/_refresh")[0] == 200
        for i in (2, 160):
            assert req("PUT", f"/sp/_doc/d{i}", docs[i + 1])[0] in (200, 201)
        assert req("POST", "/sp/_refresh")[0] == 200
    yield ref_req, port_req, port, emb
    ref.close()
    mp.undo()


def _same(want, got):
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
    assert [h["_score"] for h in gh] == [h["_score"] for h in wh]
    assert got["hits"]["max_score"] == want["hits"]["max_score"]
    for g, w in zip(gh, wh):
        assert g.get("_source") == w.get("_source")


def _concurrently(port, index, calls, monkeypatch):
    """Run each call on its own thread through the index's hybrid batcher,
    the first one's dispatch held until the rest have queued behind it,
    so they form one batch. Returns their results."""
    ex = port._hybrid_executor(port.index(index))
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


def _knn(emb, i, k=10):
    return {"field": "emb", "query_vector": (emb[i] + 0.2).tolist(),
            "k": k, "num_candidates": 40}


def _q(i, n=12, lo=0.2, hi=2.0):
    rng = np.random.default_rng(1000 + i)
    toks = rng.choice(VOCAB + 20, n, replace=False)
    return {f"t{t}": float(rng.uniform(lo, hi)) for t in toks}


def _sv(tokens, field="tokens", **extra):
    return {"sparse_vector": {"field": field, "query_vector": tokens,
                              **extra}}


def _wt(tokens, field="tokens", **extra):
    return {"weighted_tokens": {field: {"tokens": tokens, **extra}}}


def _subs(emb, i, *queries, **extra):
    return {"sub_searches": [{"query": q} for q in queries]
            + [{"query": {"knn": _knn(emb, i)}}], "rank": {"rrf": {}},
            **extra}


HYBRID = {
    "sparse_vector": lambda e: _subs(e, 3, _sv(_q(3))),
    "weighted_tokens": lambda e: _subs(e, 4, _wt(_q(4))),
    "boosts": lambda e: _subs(e, 5, _sv(_q(5), boost=2.5)),
    "wt_boost": lambda e: _subs(e, 6, _wt(_q(6), boost=0.3)),
    "query_and_knn": lambda e: {"query": _sv(_q(7)), "knn": _knn(e, 7),
                                "rank": {"rrf": {}}},
    "wide_300": lambda e: _subs(e, 8, _sv(_q(8, n=VOCAB + 20)
                                          | {f"x{j}": 1.0
                                             for j in range(130)})),
    "empty_map": lambda e: _subs(e, 9, _sv({})),
    "empty_wt": lambda e: _subs(e, 10, _wt({})),
    "oov_only": lambda e: _subs(e, 11, _sv({"never": 2.0})),
    "legacy_field": lambda e: _subs(e, 12, _sv(_q(12), field="legacy")),
    "two_sparse_and_match": lambda e: _subs(
        e, 13, _sv(_q(13)), _wt(_q(14), boost=1.5),
        {"match": {"body": "alpha gamma"}}),
    "text_field_is_generic": lambda e: _subs(
        e, 14, _sv({"alpha": 1.0}, field="body")),
    "generic_rank_feature": lambda e: _subs(
        e, 15, _sv(_q(15)), {"rank_feature": {"field": "pop"}}),
    "page": lambda e: _subs(e, 16, _sv(_q(16)), size=5, **{"from": 3}),
    "source": lambda e: _subs(e, 17, _sv(_q(17)), _source=["tokens", "n"]),
    "rank_params": lambda e: dict(_subs(e, 18, _sv(_q(18))), rank={"rrf": {
        "rank_constant": 5, "rank_window_size": 7}}),
}


@pytest.mark.parametrize("case", sorted(HYBRID))
def test_hybrid_sparse_matches_reference_node(nodes, case):
    ref_req, port_req, _port, emb = nodes
    body = HYBRID[case](emb)
    s1, want = ref_req("POST", "/sp/_search", body)
    s2, got = port_req("POST", "/sp/_search", body)
    assert s1 == s2 == 200, (want, got)
    _same(want, got)


def test_sparse_legs_take_the_board_at_any_width(nodes, monkeypatch):
    """Each sparse leg runs through `bm25_board` with the sparse variant,
    the 300-token body too; a text field's sparse kind binds to no board
    (a generic leg with no hits)."""
    _ref_req, port_req, _port, emb = nodes
    seen = []
    board = bm25.bm25_board
    monkeypatch.setattr(bm25, "bm25_board", lambda ps, *a, **k: (
        seen.append((ps.shape[0] - 1, k.get("variant"))),
        board(ps, *a, **k))[1])
    # (case, the boards' queries and variants): a body's two sparse legs
    # on one field share one board
    for case, boards in (
            ("wide_300", [(1, sparse.VARIANT)]),
            ("two_sparse_and_match", [(1, None), (2, sparse.VARIANT)]),
            ("text_field_is_generic", []), ("empty_map", [])):
        seen.clear()
        # opted out of the request cache: an earlier test sent the body
        status, _resp = port_req("POST", "/sp/_search",
                                 dict(HYBRID[case](emb), request_cache=False))
        assert status == 200
        assert seen == boards


PLAIN = {
    "sparse_vector": {"query": _sv(_q(21)), "size": 20},
    "weighted_tokens": {"query": _wt(_q(22), boost=2.0), "size": 20},
    "sv_boost": {"query": _sv(_q(23), boost=0.7)},
    "legacy": {"query": _sv(_q(24), field="legacy"), "size": 30},
    "wide": {"query": _sv(_q(25, n=VOCAB + 20)), "size": 50},
    "sv_on_text": {"query": _sv({"alpha": 1.0}, field="body")},
    "rank_feature": {"query": {"rank_feature": {"field": "pop"}}},
    "rf_saturation": {"query": {"rank_feature": {
        "field": "pop", "saturation": {"pivot": 8.0}, "boost": 2.0}}},
    "rf_log": {"query": {"rank_feature": {
        "field": "pop", "log": {"scaling_factor": 4.0}}}, "size": 15},
    "rf_sigmoid": {"query": {"rank_feature": {
        "field": "pop", "sigmoid": {"pivot": 10.0, "exponent": 0.7}}}},
    "rf_linear": {"query": {"rank_feature": {"field": "pop",
                                             "linear": {}}}},
    "rf_feature": {"query": {"rank_feature": {"field": "tokens.t1"}},
                   "size": 25},
    "rf_feature_log": {"query": {"rank_feature": {
        "field": "tokens.t3", "log": {"scaling_factor": 2.0}}}},
    "rf_in_bool": {"query": {"bool": {
        "must": {"match": {"body": "alpha"}},
        "should": [{"rank_feature": {"field": "pop", "boost": 0.5}},
                   _sv(_q(26))],
        "filter": {"range": {"n": {"gte": 20}}}}}, "size": 20},
    "sparse_in_bool": {"query": {"bool": {
        "should": [_sv(_q(27)), _wt(_q(28))],
        "must_not": {"rank_feature": {"field": "tokens.t0"}}}}},
    "source_as_sent": {"query": _sv({"t1": 1.0, "t2": 1.0}), "size": 40},
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_plain_queries_match_reference_node(nodes, case):
    ref_req, port_req, _port, _emb = nodes
    s1, want = ref_req("POST", "/sp/_search", PLAIN[case])
    s2, got = port_req("POST", "/sp/_search", PLAIN[case])
    assert s1 == s2 == 200, (want, got)
    _same(want, got)
    if case not in ("sv_on_text",):
        assert got["hits"]["hits"]


SOURCE_SPECS = {
    "feature": ["tokens.t1", "n"],
    "pattern": "tok*",
    "empty_map_drops": ["tokens", "n"],
    "includes_excludes": {"includes": ["tokens", "legacy"],
                          "excludes": ["tokens.t0", "tokens.t2"]},
    "excludes_only": {"excludes": ["emb", "tokens"]},
    "nothing": [],
}


@pytest.mark.parametrize("case", sorted(SOURCE_SPECS))
def test_source_filter_matches_reference_node(nodes, case):
    """`_source` includes, patterns and excludes over feature maps: leaf
    paths filtered, an object left empty dropped, as the reference's
    fetch phase filters them."""
    ref_req, port_req, _port, _emb = nodes
    body = {"query": {"ids": {"values": ["d9", "d1", "d46", "d100"]}},
            "_source": SOURCE_SPECS[case]}
    s1, want = ref_req("POST", "/sp/_search", body)
    s2, got = port_req("POST", "/sp/_search", body)
    assert s1 == s2 == 200, (want, got)
    _same(want, got)
    assert json.dumps([h["_source"] for h in got["hits"]["hits"]]) \
        == json.dumps([h["_source"] for h in want["hits"]["hits"]])


def test_get_returns_the_map_as_sent(nodes):
    ref_req, port_req, _port, _emb = nodes
    for doc_id in ("d0", "d9", "d161", "d4"):
        s1, want = ref_req("GET", f"/sp/_doc/{doc_id}")
        s2, got = port_req("GET", f"/sp/_doc/{doc_id}")
        assert s1 == s2 == 200
        assert got["_source"] == want["_source"]
        assert json.dumps(got["_source"]) == json.dumps(want["_source"])


MAPPER_ERRORS = {
    "features_not_object": {"tokens": [1.0, 2.0]},
    "features_scalar": {"tokens": 3.5},
    "legacy_not_object": {"legacy": "x"},
    "negative_rank_feature": {"pop": -1.5},
    "negative_allowed": {"neg": -2.0},
    "zero_rank_feature": {"pop": 0},
    "features_string_weights": {"tokens": {"a": "1.5", "b": 2}},
}


@pytest.mark.parametrize("case", sorted(MAPPER_ERRORS))
def test_mapper_errors_match_reference(tmp_path, case):
    mapping = {"properties": {
        "tokens": {"type": "rank_features"},
        "legacy": {"type": "sparse_vector"},
        "pop": {"type": "rank_feature"},
        "neg": {"type": "rank_feature", "positive_score_impact": False}}}
    ref = RefNode(str(tmp_path))
    port = Node(device="cpu")
    ref_rc, port_rc = RefController(), RestController()
    ref_register(ref_rc, ref)
    register_all(port_rc, port)
    try:
        for rc in (ref_rc, port_rc):
            args = ("PUT", "/e", {}, _raw({"mappings": mapping}))
            status = (rc.dispatch(*args, "application/json") if rc is ref_rc
                      else rc.dispatch(*args))[0]
            assert status == 200
        body = _raw(MAPPER_ERRORS[case])
        s1, want = ref_rc.dispatch("PUT", "/e/_doc/1", {}, body,
                                   "application/json")
        s2, got = port_rc.dispatch("PUT", "/e/_doc/1", {}, body)
        assert s1 == s2, (want, got)
        if s1 >= 400:
            assert got["error"]["type"] == want["error"]["type"]
            assert got["error"]["reason"] == want["error"]["reason"]
            return
        for rc, req_ct in ((ref_rc, ("application/json",)), (port_rc, ())):
            rc.dispatch("POST", "/e/_refresh", {}, b"", *req_ct)
        s1, want = ref_rc.dispatch("GET", "/e/_doc/1", {}, b"",
                                   "application/json")
        s2, got = port_rc.dispatch("GET", "/e/_doc/1", {}, b"")
        assert got["_source"] == want["_source"]
        query = _raw({"query": {"rank_feature": {"field": "tokens.b"}}}
                     if "tokens" in MAPPER_ERRORS[case] else
                     {"query": {"rank_feature": {
                         "field": next(iter(MAPPER_ERRORS[case])),
                         "linear": {}}}})
        s1, want = ref_rc.dispatch("POST", "/e/_search", {}, query,
                                   "application/json")
        s2, got = port_rc.dispatch("POST", "/e/_search", {}, query)
        assert s1 == s2 == 200
        _same(want, got)
    finally:
        ref.close()


def test_concurrent_bodies_share_one_board_a_feature_field(nodes,
                                                           monkeypatch):
    """Nine bodies in two batches (the first held alone, eight queued
    behind it) give their sequential answers; the second batch scores its
    `tokens` legs in one board and its `legacy` leg in another."""
    _ref_req, port_req, port, emb = nodes
    names = ["sparse_vector", "weighted_tokens", "boosts", "wt_boost",
             "wide_300", "empty_map", "legacy_field", "oov_only", "page"]
    # each body opts out of the request cache: the test counts boards
    bodies = [dict(HYBRID[n](emb), request_cache=False) for n in names]
    want = [port_req("POST", "/sp/_search", b)[1] for b in bodies]
    boards = []
    board = bm25.bm25_board
    monkeypatch.setattr(bm25, "bm25_board", lambda ps, *a, **k: (
        boards.append(ps.shape[0] - 1), board(ps, *a, **k))[1])
    ex = port._hybrid_executor(port.index("sp"))
    batches = ex.stats["batches"]
    got = _concurrently(port, "sp", [
        (lambda b=b: port.search("sp", b)) for b in bodies], monkeypatch)
    for w, g in zip(want, got):
        _same(w, g)
    assert ex.stats["batches"] - batches == 2
    assert len(boards) == 3
    assert boards[0] == 1


@pytest.mark.parametrize("dtype", ["fp16", "bf16"])
def test_impact_dtype_setting_as_the_reference(tmp_path, dtype):
    """`index.sparse.impact_dtype` and `index.lexical.impact_dtype`: bf16
    lays the impacts out as bf16 for the board; a value the reference does
    not know is read as f32, as the reference reads it, and answers as the
    reference does."""
    ref = RefNode(str(tmp_path))
    port = Node(device="cpu")
    ref_rc, port_rc = RefController(), RestController()
    ref_register(ref_rc, ref)
    register_all(port_rc, port)
    rng = np.random.default_rng(71)
    create = {"settings": {"index.sparse.impact_dtype": dtype,
                           "index.lexical.impact_dtype": dtype},
              "mappings": {"properties": {
                  "tokens": {"type": "rank_features"},
                  "body": {"type": "text"}}}}
    bulk = []
    for i in range(120):
        bulk += [{"index": {"_id": f"d{i}"}},
                 {"tokens": _fmap(rng, 3, 30),
                  "body": " ".join(rng.choice(["alpha", "beta", "gamma"],
                                              2))}]
    try:
        for rc, ct in ((ref_rc, ("application/json",)), (port_rc, ())):
            assert rc.dispatch("PUT", "/dt", {}, _raw(create), *ct)[0] == 200
            assert rc.dispatch("POST", "/dt/_bulk", {}, _raw(bulk, True),
                               *ct)[0] == 200
            rc.dispatch("POST", "/dt/_refresh", {}, b"", *ct)
        ex = port._hybrid_executor(port.index("dt"))
        assert ex.sparse.dtype == ex.lexical.dtype \
            == ("bf16" if dtype == "bf16" else "f32")
        if dtype == "bf16":
            return
        body = _raw({"sub_searches": [{"query": _sv(_q(40))},
                                      {"query": {"match": {"body": "beta"}}}],
                     "rank": {"rrf": {}}})
        s1, want = ref_rc.dispatch("POST", "/dt/_search", {}, body,
                                   "application/json")
        s2, got = port_rc.dispatch("POST", "/dt/_search", {}, body)
        assert s1 == s2 == 200
        _same(want, got)
    finally:
        ref.close()
