"""Filtered kNN and the rest of the `knn` body through the port on the CPU,
against the reference `Node` on the same documents and bodies.

Documents (made from a seed with numpy) carry a vector and keyword,
numeric and boolean metadata, some of it multi-valued; some documents
have no vector, and updates tombstone rows. Each filter kind runs on each
rung: `flat`, `int8_flat` + rescore, `ivf` and `int8_ivf` (one segment
each; a filter sends them to their exhaustive corpus:
`fallback_reason: filtered` in both packages), `ivf` and `int8_ivf` again
in two segments with three updates once the merge thread has compacted
the tombstoned base (the generational route: each generation's leg
masked on the exact route) over REST, and `int4_flat` + rescore through the stores at f32 (the
reference's int4 scoring at bf16 does not run on the CPU). Hits must
have the same ids in the same order except among scores that tie within
1e-4, and scores within the exact route's tolerance (2e-5 of the raw
similarity at bf16, 1e-5 at f32). Also: `knn` lists, `knn` + `query`, a
filtered hybrid leg, the fast mask against `np.isin`, a batch mixing
filtered and unfiltered requests against the reference's `search_many`,
and a refresh between filter evaluation and dispatch."""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.search.queries import SearchContext as RefContext
from elasticsearch_tpu.search.queries import parse_query as ref_parse
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.index import mapping
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.search.knn_query import KnnQuery
from elasticsearch_tpu_torch.search.queries import SearchContext, parse_query
from elasticsearch_tpu_torch.vectors.store import VectorStoreShard, filter_mask

D, K, N = 16, 10, 640
COLORS = ["red", "green", "blue"]

RUNGS = {
    "flat": {"type": "flat"},
    "int8": {"type": "int8_flat", "rescore": True},
    "int4": {"type": "int4_flat", "rescore": True},
    "ivf": {"type": "ivf"},
    "int8ivf": {"type": "int8_ivf"},
    "ivf_gen": {"type": "ivf"},
    "int8ivf_gen": {"type": "int8_ivf"},
}

FILTERS = {
    "term": {"term": {"color": "red"}},
    "terms_multi": {"terms": {"tags": ["t1", "t4"]}},
    "range": {"range": {"score": {"gte": 0.3, "lt": 0.8}}},
    "range_int": {"range": {"width": {"gte": 700}}},
    "exists": {"exists": {"field": "tags"}},
    "ids": {"ids": {"values": [f"d{i}" for i in range(0, N, 9)]}},
    "bool": {"bool": {"filter": [{"term": {"color": "blue"}},
                                 {"term": {"safe": True}}],
                      "must_not": [{"range": {"width": {"lt": 300}}}]}},
    "few": {"bool": {"filter": [{"term": {"color": "green"}},
                                {"range": {"width": {"gte": 1150}}}]}},
    "none": {"term": {"color": "purple"}},
    "novector": {"range": {"width": {"gte": 1300}}},
}


def _raw(body, ndjson=False):
    if body is None:
        return b""
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return json.dumps(body).encode()


def _docs(seed):
    """N documents: clustered vectors (the last 20 without one, with
    width >= 1300), a color, 0-3 tags, a width, a score, a safe flag."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, N)]
            + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    docs = []
    for i in range(N):
        doc = {"color": COLORS[int(rng.integers(3))],
               "width": int(rng.integers(0, 1200)),
               "score": float(np.float32(rng.random())),
               "safe": bool(rng.random() < 0.7)}
        n_tags = int(rng.integers(0, 4))
        if n_tags:
            doc["tags"] = [f"t{int(t)}" for t in rng.integers(0, 6, n_tags)]
        if i < N - 20:
            doc["v"] = vecs[i].tolist()
        else:
            doc["width"] = 1300 + i
        docs.append(doc)
    return rng, vecs, docs


def _mapping(options, similarity="cosine"):
    return {"properties": {
        "v": {"type": "dense_vector", "dims": D, "similarity": similarity,
              "index_options": options},
        "color": {"type": "keyword"}, "tags": {"type": "keyword"},
        "width": {"type": "integer"}, "score": {"type": "float"},
        "safe": {"type": "boolean"}}}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes with one index a rung, the same documents in two
    segments and three updates (tombstones)."""
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

    rng, vecs, docs = _docs(7)
    settings = {"number_of_shards": 1, "number_of_replicas": 0,
                "index.knn.nlist": 16}
    for name, options in RUNGS.items():
        create = {"settings": settings, "mappings": _mapping(options)}
        # `ivf` and `int8ivf` load as one segment, so that both packages
        # serve them through their IVF router and its filtered fallback;
        # the `_gen` rungs take the generational route (a base of 600
        # rows with its router, an L0 seal, tombstones)
        ivf = name.endswith("ivf")
        splits = ((0, N),) if ivf else ((0, 600), (600, N)) \
            if name.endswith("_gen") else ((0, 400), (400, N))
        for req in (ref_req, port_req):
            assert req("PUT", f"/{name}", create)[0] == 200
            for lo, hi in splits:
                bulk = []
                for i in range(lo, hi):
                    bulk += [{"index": {"_id": f"d{i}"}}, docs[i]]
                status, resp = req("POST", f"/{name}/_bulk", bulk,
                                   ndjson=True)
                assert status == 200 and not resp["errors"]
                assert req("POST", f"/{name}/_refresh")[0] == 200
            if not ivf:
                for i in (5, 77, 450):
                    doc = dict(docs[i], color="red", width=999)
                    assert req("PUT", f"/{name}/_doc/d{i}", doc)[0] == 200
                assert req("POST", f"/{name}/_refresh")[0] == 200
        if name.endswith("_gen"):
            # the tombstoned IVF base's compaction (a retrain on each
            # package's merge thread) ends before any search
            ref.indices.indices[name].shards[0].vector_store \
                ._gens["v"].drain()
            port.index(name).store._gens["v"].drain()
    queries = (vecs[rng.integers(0, N - 20, 3)]
               + 0.3 * rng.standard_normal((3, D))).astype(np.float32)
    yield ref_req, port_req, ref, port, queries
    ref.close()
    mp.undo()


def _ref_store(ref, name):
    return ref.indices.indices[name].shards[0].vector_store


def _same_hits(want, got, tol=1e-5):
    """Same total, ids equal where the reference's `_score` gaps exceed
    1e-4, `_score`s within `tol` ((1 + cos) / 2 halves the raw
    tolerance)."""
    assert got["hits"]["total"] == want["hits"]["total"]
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(wh)
    if not wh:
        assert got["hits"]["max_score"] is want["hits"]["max_score"] is None
        return
    ws = np.array([h["_score"] for h in wh])
    gs = np.array([h["_score"] for h in gh])
    np.testing.assert_allclose(gs, ws, atol=tol)
    assert abs(got["hits"]["max_score"] - want["hits"]["max_score"]) <= tol
    gap = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                     np.abs(np.diff(ws, append=-np.inf)))
    for j in np.nonzero(gap > 1e-4)[0]:
        assert gh[j]["_id"] == wh[j]["_id"]


@pytest.mark.parametrize("rung", ["flat", "int8", "ivf", "int8ivf",
                                  "ivf_gen", "int8ivf_gen"])
@pytest.mark.parametrize("fname", sorted(FILTERS))
def test_filtered_knn_matches_reference(nodes, rung, fname):
    ref_req, port_req, ref, port, queries = nodes
    for q in queries:
        body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": K,
                        "num_candidates": 50, "filter": FILTERS[fname]},
                "size": K}
        s1, want = ref_req("POST", f"/{rung}/_search", body)
        s2, got = port_req("POST", f"/{rung}/_search", body)
        assert s1 == s2 == 200, (want, got)
        _same_hits(want, got)
        phases = port.index(rung).store.last_knn_phases
        if rung.endswith("_gen"):
            assert phases["engine"] == "tpu_generational"
            assert phases["legs"] == ["segments.knn"] * 3
            assert _ref_store(ref, rung).last_knn_phases["legs"] == \
                phases["legs"]
        elif rung.endswith("ivf"):
            assert phases["fallback_reason"] == "filtered"
            assert _ref_store(ref, rung).last_knn_phases[
                "fallback_reason"] == "filtered"
    if fname == "none":
        assert got["hits"]["total"]["value"] == 0
    if fname == "few":
        assert 0 < got["hits"]["total"]["value"] < K


@pytest.mark.parametrize("fname", sorted(FILTERS))
def test_int4_rescore_under_a_filter_matches_reference(nodes, fname):
    """int4_flat + rescore through the stores at f32: the coarse window
    over the masked packed rows, then the exact rescore; the filter rows
    come from each package's own query over its own reader."""
    _ref_req, _port_req, ref, port, queries = nodes
    svc = port.index("int4")
    reader = svc.engine.acquire_searcher()
    rows = parse_query(FILTERS[fname]).execute(
        SearchContext(reader, svc.mapper_service)).rows
    ref_svc = ref.indices.indices["int4"]
    ref_shard = ref_svc.shards[0]
    ref_rows = ref_parse(FILTERS[fname]).execute(RefContext(
        ref_shard.engine.acquire_searcher(), ref_svc.mapper_service)).rows
    np.testing.assert_array_equal(rows, ref_rows)
    for q in queries:
        want_rows, want_raw = _ref_store(ref, "int4").search(
            "v", q, K, filter_rows=ref_rows, precision="f32")
        got_rows, got_raw = svc.store.search(
            "v", q, K, filter_rows=rows, precision="f32", reader=reader)
        assert len(got_rows) == len(want_rows)
        np.testing.assert_allclose(got_raw, want_raw, atol=1e-5)
        assert np.isin(got_rows, rows).all()
        gap = np.minimum(np.abs(np.diff(want_raw, prepend=np.inf)),
                         np.abs(np.diff(want_raw, append=-np.inf)))
        clear = gap > 1e-4
        np.testing.assert_array_equal(got_rows[clear], want_rows[clear])


@pytest.mark.parametrize("case", ["list", "list_filtered", "with_query",
                                  "with_bool_query", "boosted"])
def test_knn_list_and_knn_with_query_match_reference(nodes, case):
    """Several knn specs, or knn beside a query: bool.should of them."""
    ref_req, port_req, _ref, _port, queries = nodes
    a = {"field": "v", "query_vector": queries[0].tolist(), "k": K,
         "num_candidates": 40}
    b = {"field": "v", "query_vector": queries[1].tolist(), "k": 5}
    body = {"size": 20}
    if case == "list":
        body["knn"] = [a, b]
    elif case == "list_filtered":
        body["knn"] = [dict(a, filter=FILTERS["term"]),
                       dict(b, filter=FILTERS["range"], boost=2.0)]
    elif case == "with_query":
        body.update(knn=a, query={"term": {"color": "green"}})
    elif case == "with_bool_query":
        body.update(knn=[a, dict(b, filter=FILTERS["exists"])],
                    query={"bool": {"filter": {"term": {"safe": True}},
                                    "should": {"range": {
                                        "width": {"lt": 100}}}}})
    else:
        body.update(knn=dict(a, boost=0.5),
                    query={"constant_score": {"filter": FILTERS["few"],
                                              "boost": 0.25}})
    for rung in ("flat", "int8"):
        s1, want = ref_req("POST", f"/{rung}/_search", body)
        s2, got = port_req("POST", f"/{rung}/_search", body)
        assert s1 == s2 == 200, (want, got)
        _same_hits(want, got)


def test_knn_filter_errors_match_reference(nodes):
    ref_req, port_req, _ref, _port, queries = nodes
    knn = {"field": "v", "query_vector": queries[0].tolist(), "k": K}
    for filt in ({"range": {"width": {"gte": "wide"}}},
                 {"exists": {"field": "_source"}},
                 {"nosuch": {}}):
        body = {"knn": dict(knn, filter=filt)}
        s1, want = ref_req("POST", "/flat/_search", body)
        s2, got = port_req("POST", "/flat/_search", body)
        assert s1 == s2 == 400, (want, got)
        assert got["error"]["type"] == want["error"]["type"]


def test_filtered_hybrid_leg_matches_reference(nodes):
    """A `rank: {rrf}` body whose knn leg carries a filter, beside a
    late_interaction leg: the same fused hits as the reference, and the
    filtered leg's hits all satisfy the filter."""
    ref_req, port_req, _ref, port, queries = nodes
    rng = np.random.default_rng(11)
    create = {"settings": {"number_of_shards": 1, "number_of_replicas": 0},
              "mappings": {"properties": {
                  "emb": {"type": "dense_vector", "dims": D,
                          "similarity": "cosine"},
                  "colv": {"type": "rank_vectors", "dims": 8},
                  "tag": {"type": "keyword"}}}}
    bulk = []
    for i in range(80):
        bulk += [{"index": {"_id": f"h{i}"}},
                 {"emb": rng.standard_normal(D).astype(np.float32).tolist(),
                  "colv": rng.standard_normal((3, 8)).astype(
                      np.float32).tolist(),
                  "tag": f"t{i % 4}"}]
    for req in (ref_req, port_req):
        assert req("PUT", "/hy", create)[0] == 200
        assert not req("POST", "/hy/_bulk", bulk, ndjson=True)[1]["errors"]
        assert req("POST", "/hy/_refresh")[0] == 200
    for i, filt in enumerate(({"term": {"tag": "t1"}},
                              {"bool": {"must_not": {"term": {
                                  "tag": "t2"}}}},
                              {"term": {"tag": "none"}})):
        body = {"rank": {"rrf": {}}, "size": 10, "sub_searches": [
            {"query": {"knn": {
                "field": "emb", "k": 5, "num_candidates": 20,
                "query_vector": rng.standard_normal(D).tolist(),
                "filter": filt}}},
            {"query": {"late_interaction": {
                "field": "colv",
                "query_tokens": rng.standard_normal((2, 8)).tolist()}}}]}
        s1, want = ref_req("POST", "/hy/_search", body)
        s2, got = port_req("POST", "/hy/_search", body)
        assert s1 == s2 == 200, (want, got)
        assert got["hits"]["total"] == want["hits"]["total"]
        assert [h["_id"] for h in got["hits"]["hits"]] \
            == [h["_id"] for h in want["hits"]["hits"]]
        assert [h["_score"] for h in got["hits"]["hits"]] \
            == [h["_score"] for h in want["hits"]["hits"]]
    # the leg alone: every hit passes its filter
    ex = port._hybrid_executor(port.index("hy"))
    from elasticsearch_tpu_torch.search.hybrid_plan import compile_plan
    body["sub_searches"][0]["query"]["knn"]["filter"] = {"term": {
        "tag": "t3"}}
    plan = compile_plan(body, port.index("hy").mapper_service)
    reader = port.index("hy").engine.acquire_searcher()
    (knn_rows, _), = ex.score_legs(reader, [plan], [plan.bind(body)])
    assert len(knn_rows) == 5
    assert all(reader.get_source(int(r))["tag"] == "t3" for r in knn_rows)


def test_fast_mask_equals_isin():
    """The scatter mask equals `np.isin(row_map, filter_rows)` on random
    sorted sets, with filter rows absent from the row map (deleted docs,
    docs without the vector, rows past its end)."""
    from elasticsearch_tpu_torch.vectors.store import FieldCorpus
    rng = np.random.default_rng(3)
    for trial in range(20):
        n_rows = int(rng.integers(1, 3000))
        row_map = np.sort(rng.choice(n_rows * 2, n_rows, replace=False))
        # filter_mask reads only the corpus's device
        fc = FieldCorpus(SimpleNamespace(device=torch.device("cpu")),
                         row_map.astype(np.int64), "cosine", D, ())
        filters = []
        for _ in range(5):
            m = int(rng.integers(0, n_rows * 3))
            fr = np.unique(rng.integers(-2, n_rows * 3, m))
            filters.append(None if rng.random() < 0.2 else fr)
        filters.append(np.zeros(0, dtype=np.int64))
        n_pad = n_rows + int(rng.integers(0, 64))
        mask = filter_mask(fc, filters, 8, n_pad).numpy()
        assert mask.shape == (8, n_pad) and not mask[len(filters):].any()
        assert not mask[:, n_rows:].any()
        for i, fr in enumerate(filters):
            want = np.ones(n_rows, bool) if fr is None \
                else np.isin(row_map, fr)
            np.testing.assert_array_equal(mask[i, :n_rows], want)


def test_mixed_batch_matches_reference_search_many(nodes):
    """One batch of filtered and unfiltered requests (the batch takes the
    exact route, its unfiltered requests too) against the reference's
    `search_many` on the same batch."""
    _ref_req, _port_req, ref, port, queries = nodes
    svc = port.index("flat")
    reader = svc.engine.acquire_searcher()
    ctx = SearchContext(reader, svc.mapper_service)
    rows = {f: parse_query(FILTERS[f]).execute(ctx).rows
            for f in ("term", "few", "none", "bool")}
    plan = [(queries[0], None), (queries[1], rows["term"]),
            (queries[2], rows["few"]), (queries[0], rows["none"]),
            (queries[1], None), (queries[2], rows["bool"])]
    want = _ref_store(ref, "flat").search_many("v", plan, K)
    got = svc.store.search_many("v", [q for q, _ in plan], K,
                                filter_rows=[fr for _, fr in plan],
                                reader=reader)
    for (fr_q, fr), (w_rows, w_raw), (g_rows, g_raw) in zip(plan, want, got):
        assert len(g_rows) == len(w_rows)
        np.testing.assert_allclose(g_raw, w_raw, atol=2e-5)
        gap = np.minimum(np.abs(np.diff(w_raw, prepend=np.inf)),
                         np.abs(np.diff(w_raw, append=-np.inf)))
        np.testing.assert_array_equal(g_rows[gap > 1e-4], w_rows[gap > 1e-4])
        if fr is not None:
            assert np.isin(g_rows, fr).all()
    assert len(got[3][0]) == 0 and 0 < len(got[2][0]) < K


def test_concurrent_filtered_and_unfiltered_requests_share_a_batch():
    """Filtered and unfiltered searches queued together form one batch
    (the batcher key holds no filter) and each gets its batch-1 answer."""
    store, engine, ms = _engine_store()
    reader = engine.acquire_searcher()
    rng = np.random.default_rng(8)
    ctx = SearchContext(reader, ms)
    filt = parse_query({"term": {"color": "red"}}).execute(ctx).rows
    qs = rng.standard_normal((6, D)).astype(np.float32)
    calls = [(q, filt if i % 2 else None) for i, q in enumerate(qs)]
    alone = [store.search("v", q, K, filter_rows=fr, reader=reader)
             for q, fr in calls]
    orig = store._dispatch_many
    started, gate, sizes = threading.Event(), threading.Event(), []

    def held(fc, k, precision, requests, num_candidates):
        sizes.append(len(requests))
        if not started.is_set():
            started.set()
            assert gate.wait(10)
        return orig(fc, k, precision, requests, num_candidates)

    store._dispatch_many = held
    results = [None] * len(calls)

    def run(i):
        q, fr = calls[i]
        results[i] = store.search("v", q, K, filter_rows=fr, reader=reader)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    threads[0].start()
    assert started.wait(10)
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + 10
    while store.pending_requests("v") < len(calls) - 1:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    gate.set()
    for t in threads:
        t.join(10)
    assert sizes == [1, len(calls) - 1]
    for (g_rows, g_raw), (w_rows, w_raw), (_, fr) in zip(results, alone,
                                                         calls):
        np.testing.assert_allclose(g_raw, w_raw, atol=2e-5)
        if fr is not None:
            assert np.isin(g_rows, fr).all()


def _engine_store(n=300, seed=4):
    ms = mapping.MapperService(_mapping({"type": "flat"}))
    engine = Engine(ms)
    store = VectorStoreShard(device="cpu")
    engine.add_refresh_listener(lambda r: store.sync(r, ms.vector_fields()))
    _, vecs, docs = _docs(seed)
    engine.index_many([f"d{i}" for i in range(n)], docs[:n])
    engine.refresh()
    return store, engine, ms


def test_refresh_between_filter_and_dispatch_serves_the_old_snapshot():
    """A filter evaluated on reader A, then a refresh (new docs, an
    update that tombstones a row) before the search dispatches: the
    search is served from A's corpus, so its hits are A's rows that pass
    A's filter — the same hits a store that only ever saw A gives."""
    store, engine, ms = _engine_store()
    reader_a = engine.acquire_searcher()
    rng = np.random.default_rng(12)
    q = rng.standard_normal(D).astype(np.float32)
    query = KnnQuery("v", q, k=K, num_candidates=K,
                     filter_query=parse_query({"term": {"color": "red"}}))
    ctx_a = SearchContext(reader_a, ms, store)
    filt = query.filter_query.execute(ctx_a).rows
    only_a = VectorStoreShard(device="cpu")
    only_a.sync(reader_a, ms.vector_fields())
    want_rows, want_raw = only_a.search("v", q, K, filter_rows=filt)

    # the refresh: more red docs near q, and doc d0 re-indexed near q
    _, _, docs = _docs(5)
    near = [dict(d, v=(q + 0.01 * rng.standard_normal(D)).tolist(),
                 color="red") for d in docs[:20]]
    engine.index_many([f"n{i}" for i in range(19)] + ["d0"], near)
    engine.refresh()
    assert store.field("v") is not store._field_for("v", reader_a)

    got = query.execute(ctx_a)
    rows_a = reader_a.live_global_rows()
    assert np.isin(got.rows, rows_a).all() and np.isin(got.rows, filt).all()
    np.testing.assert_array_equal(np.sort(got.rows), np.sort(want_rows))
    # a new reader sees the new red docs
    ctx_b = SearchContext(engine.acquire_searcher(), ms, store)
    new = query.execute(ctx_b)
    assert not np.isin(new.rows, rows_a).all()
