"""The port's `VectorStoreShard` against the reference store on the same
sealed segments (two segments, one tombstone) on the CPU: rows must match
where the reference's score gaps exceed 1e-4 and raw scores agree within
2e-5 (bf16 products are exact in f32; only summation order differs), for
every metric and for the `int8_flat` rung with `rescore: true`. The
reference's int8 VNNI host mirror is switched off so it serves from its
device route, as the port does. Also: the port's engine feeds its store
through refresh, and re-syncs only when the segment set changed."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index import mapping as ref_mapping
from elasticsearch_tpu.index import segment as ref_segment
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.index import mapping, segment
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

D, K = 16, 10


@pytest.fixture(autouse=True)
def _no_host_mirror(monkeypatch):
    monkeypatch.setattr(ref_store.native, "AVAILABLE", False)


def _readers(blocks, deleted, first_seg_id=0):
    """The same two segments as a reference and a port ShardReader."""
    ref_views, views, base = [], [], 0
    for seg_id, vecs in enumerate(blocks, first_seg_id):
        n = len(vecs)
        ids = [f"d{base + i}" for i in range(n)]
        present = np.ones(n, dtype=bool)
        rseg = ref_segment.Segment(
            seg_id=seg_id, base=base, num_docs=n, postings={},
            field_lengths={}, total_terms={}, doc_values={},
            vectors={"v": (vecs, present)}, ids=ids, sources=[None] * n,
            seq_nos=np.arange(base, base + n, dtype=np.int64))
        pseg = segment.Segment(seg_id, base, ids, [None] * n,
                               {"v": (vecs, present)})
        dels = deleted.get(seg_id - first_seg_id)
        ref_views.append(ref_segment.SegmentView(rseg, dels))
        views.append(segment.SegmentView(pseg, dels))
        base += n
    return ref_segment.ShardReader(ref_views), segment.ShardReader(views)


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm",
                                        "max_inner_product"])
@pytest.mark.parametrize("options", [None, {"type": "int8_flat",
                                            "rescore": True}])
def test_store_search_matches_reference(similarity, options):
    rng = np.random.default_rng(21)
    blocks = [rng.standard_normal((150, D)).astype(np.float32),
              rng.standard_normal((90, D)).astype(np.float32)]
    ref_reader, reader = _readers(blocks, {0: {3, 40}})
    field = {"type": "dense_vector", "dims": D, "similarity": similarity}
    if options:
        field["index_options"] = options
    props = {"properties": {"v": field}}
    ref = ref_store.VectorStoreShard()
    ref.sync(ref_reader, ref_mapping.MapperService(props).vector_fields())
    port = VectorStoreShard(device="cpu")
    port.sync(reader, mapping.MapperService(props).vector_fields())
    assert port.field("v").encoding == ("int8" if options else "bf16")

    queries = rng.standard_normal((5, D)).astype(np.float32)
    for q in queries:
        want_rows, want_raw = ref.search("v", q, K)
        got_rows, got_raw = port.search("v", q, K)
        assert 3 not in got_rows and 40 not in got_rows   # tombstoned
        np.testing.assert_allclose(got_raw, want_raw, atol=2e-5 * max(
            1.0, float(np.abs(want_raw).max())))
        gap = np.minimum(np.abs(np.diff(want_raw, prepend=np.inf)),
                         np.abs(np.diff(want_raw, append=-np.inf)))
        clear = gap > 1e-4
        np.testing.assert_array_equal(got_rows[clear], want_rows[clear])


def test_engine_refresh_feeds_store_and_resyncs_on_change():
    ms = mapping.MapperService({"properties": {
        "v": {"type": "dense_vector", "dims": D}}})
    engine = Engine(ms)
    store = VectorStoreShard(device="cpu")
    engine.add_refresh_listener(
        lambda r: store.sync(r, ms.vector_fields()))
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((50, D)).astype(np.float32)
    engine.index_many([str(i) for i in range(50)], vectors={"v": vecs})
    engine.refresh()
    fc = store.field("v")
    assert len(fc.row_map) == 50
    engine.refresh()
    assert store.field("v") is fc            # nothing changed: no rebuild
    engine.index("7", {"v": (vecs[7] * -1).tolist(), "tag": "x"})
    assert engine.get("7")["_version"] == 2
    reader = engine.refresh()
    # the update tombstones row 7 and seals row 50 (an L0 generation)
    assert store.field("v") is not fc \
        and len(store.field("v").snap.live_row_map()) == 50
    rows, _ = store.search("v", -vecs[7], 1)
    assert reader.get_id(int(rows[0])) == "7"
    assert reader.get_source(int(rows[0]))["tag"] == "x"


def test_store_requires_a_gpu_unless_asked_for_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorStoreShard()


# ---------------------------------------------------------------- tpu_ivf
#
# IVF fields: the reference trains, its `export_ivf_layout` crosses over,
# and the port re-places the same rows into the same centroids; then both
# stores must serve the same hits under the rule above (rows equal where
# gaps exceed 1e-4, raw scores within 2e-5), through the same nprobe.

IVF_CASES = {
    "ivf": ({"type": "ivf", "nlist": 16, "nprobe": 4}, {}),
    "int8_ivf": ({"type": "int8_ivf", "nlist": 16, "nprobe": 4}, {}),
    "int4_ivf": ({"type": "int4_ivf", "nlist": 16, "nprobe": 4}, {}),
    "int4_flat": ({"type": "int4_flat"}, {}),
    "engine_setting": (None, {"knn_engine": "tpu_ivf", "knn_nlist": 16,
                              "knn_nprobe": 4}),
}


@pytest.mark.parametrize("case", sorted(IVF_CASES))
@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
def test_ivf_store_matches_reference_with_layout_carried(case, similarity):
    options, engine = IVF_CASES[case]
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((12, D)).astype(np.float32)
    blocks = [(centers[rng.integers(0, 12, n)] + 0.4 * rng.standard_normal(
        (n, D))).astype(np.float32) for n in (500, 300)]
    ref_reader, reader = _readers(blocks, {1: {7}})
    field = {"type": "dense_vector", "dims": D, "similarity": similarity}
    if options:
        field["index_options"] = options
    props = {"properties": {"v": field}}
    ref = ref_store.VectorStoreShard(**engine)
    ref.sync(ref_reader, ref_mapping.MapperService(props).vector_fields())
    port = VectorStoreShard(device="cpu", **engine)
    port.restore_ivf_layout(ref.export_ivf_layout())
    port.sync(reader, mapping.MapperService(props).vector_fields())
    ivf = case != "int4_flat"
    fc = port.field("v")
    assert (fc.router is not None) is ivf
    assert port.knn_stats["ivf_restores"] == int(ivf)
    assert port.knn_stats["ivf_trains"] == 0
    assert fc.encoding == {"int8_ivf": "int8", "int4_ivf": "int4",
                           "int4_flat": "int4"}.get(case, "bf16")
    if ivf:
        np.testing.assert_array_equal(
            fc.router.index.part_rows,
            ref.field("v").router.index.part_rows)

    queries = (blocks[0][rng.integers(0, 500, 5)]
               + 0.2 * rng.standard_normal((5, D))).astype(np.float32)
    for q in queries:
        want_rows, want_raw = ref.search("v", q, K)
        got_rows, got_raw = port.search("v", q, K)
        assert len(got_rows) == len(want_rows) == K
        assert 507 not in got_rows                      # tombstoned
        np.testing.assert_allclose(got_raw, want_raw, atol=2e-5 * max(
            1.0, float(np.abs(want_raw).max())))
        gap = np.minimum(np.abs(np.diff(want_raw, prepend=np.inf)),
                         np.abs(np.diff(want_raw, append=-np.inf)))
        clear = gap > 1e-4
        np.testing.assert_array_equal(got_rows[clear], want_rows[clear])
        phases = port.last_knn_phases
        if ivf:
            assert phases["nprobe"] == ref.last_knn_phases["nprobe"] == 4
            assert phases["fused_probe"] is (similarity != "l2_norm")
        assert ("rescore" in phases) is (fc.encoding == "int4")
    stats = port.knn_stats
    assert stats["searches"] == 5 and stats["fallback_searches"] == 0
    assert stats["ivf_searches"] == (5 if ivf else 0)
    assert stats["fused_probe_searches"] == \
        (5 if ivf and similarity != "l2_norm" else 0)
    assert stats["rescore_searches"] == (5 if fc.encoding == "int4" else 0)


def test_small_ivf_field_stays_exhaustive_and_f32_falls_back():
    rng = np.random.default_rng(8)
    _, reader = _readers([rng.standard_normal((300, D)).astype(np.float32)],
                         {})
    props = {"properties": {"v": {"type": "dense_vector", "dims": D,
                                  "index_options": {"type": "ivf"}}}}
    store = VectorStoreShard(device="cpu")
    store.sync(reader, mapping.MapperService(props).vector_fields())
    assert store.field("v").router is None           # < IVF_MIN_ROWS
    rows, _ = store.search("v", rng.standard_normal(D), K)
    assert len(rows) == K and store.knn_stats["ivf_searches"] == 0

    _, reader = _readers([rng.standard_normal((600, D)).astype(np.float32)],
                         {})
    store.sync(reader, mapping.MapperService(props).vector_fields())
    assert store.field("v").router is not None
    assert store.knn_stats["ivf_trains"] == 1
    rows, _ = store.search("v", rng.standard_normal(D), K, precision="f32")
    assert len(rows) == K
    assert store.knn_stats["fallback_searches"] == 1
    assert store.last_knn_phases == {"engine": "tpu_exhaustive",
                                     "fallback_reason": "f32_precision"}


def test_append_only_refresh_keeps_the_router():
    """The full-build path's router extension (`index.segments.enabled:
    false`; a generational field seals the delta instead, as
    test_torch_segments.py holds)."""
    ms = mapping.MapperService({"properties": {"v": {
        "type": "dense_vector", "dims": D,
        "index_options": {"type": "int8_ivf", "nlist": 8}}}})
    engine = Engine(ms)
    store = VectorStoreShard(device="cpu", segments_enabled=False)
    engine.add_refresh_listener(lambda r: store.sync(r, ms.vector_fields()))
    rng = np.random.default_rng(12)
    vecs = rng.standard_normal((700, D)).astype(np.float32)
    engine.index_many([str(i) for i in range(600)], vectors={"v": vecs[:600]})
    engine.refresh()
    router = store.field("v").router
    assert router is not None and router.index.total == 600
    engine.index_many([str(i) for i in range(600, 700)],
                      vectors={"v": vecs[600:]})
    reader = engine.refresh()
    # placed into a copy of the layout, not retrained: same centroids and
    # tuned nprobe, and the previous snapshot's router still holds 600 rows
    new = store.field("v").router
    assert new is not router and new.index is not router.index
    np.testing.assert_array_equal(new.index.centroids,
                                  router.index.centroids)
    assert new._tuned_nprobe == router._tuned_nprobe
    assert router.index.total == 600 and new.index.total == 700
    assert store.knn_stats["ivf_trains"] == 1
    router = new
    rows, _ = store.search("v", vecs[650], 1)
    assert reader.get_id(int(rows[0])) == "650"
    # a delete re-bases rows: only a fresh layout is sound
    engine.index("3", {"v": vecs[3].tolist()})
    engine.refresh()
    assert store.field("v").router is not router
    assert store.knn_stats["ivf_trains"] == 2


def test_ivf_store_requires_a_gpu_unless_asked_for_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorStoreShard(knn_engine="tpu_ivf")


# ------------------------------------------------------------ concurrency
#
# `search` coalesces concurrent callers through the combining batcher. The
# first caller's dispatch is held on an event until the others have queued
# behind it, so they form one batch of 7 (bucket 8) deterministically.

def _hold_first_dispatch(store):
    """Wrap the store's dispatch stage: the first call waits for `gate`.
    Returns (started, gate)."""
    import threading
    orig = store._dispatch_many
    started, gate = threading.Event(), threading.Event()

    def held(*args, **kwargs):
        if not started.is_set():
            started.set()
            assert gate.wait(10)
        return orig(*args, **kwargs)

    store._dispatch_many = held
    return started, gate


def _run_concurrently(store, field, calls, first_alone=True):
    """Run each zero-argument call on its own thread, the first alone in
    a held dispatch until the rest are queued. Returns their results."""
    import threading
    import time
    started, gate = _hold_first_dispatch(store)
    results = [None] * len(calls)

    def run(i):
        results[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    threads[0].start()
    assert started.wait(10)
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + 10
    while store.pending_requests(field) < len(calls) - 1:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    gate.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return results


def _assert_same_hits(got, want):
    (got_rows, got_raw), (want_rows, want_raw) = got, want
    assert len(got_rows) == len(want_rows) == K
    np.testing.assert_allclose(got_raw, want_raw, atol=2e-5 * max(
        1.0, float(np.abs(want_raw).max())))
    gap = np.minimum(np.abs(np.diff(want_raw, prepend=np.inf)),
                     np.abs(np.diff(want_raw, append=-np.inf)))
    clear = gap > 1e-4
    np.testing.assert_array_equal(got_rows[clear], want_rows[clear])


@pytest.mark.parametrize("options", [None, {"type": "int8_ivf", "nlist": 16,
                                            "nprobe": 4},
                                     {"type": "int4_ivf", "nlist": 16,
                                      "nprobe": 4}])
def test_concurrent_searches_coalesce_and_match_reference(options):
    """8 threads: the same hits as the reference store's `search` for each
    query, on a flat and on IVF fields (the layout carried over), from 2
    dispatches (1, then 7 coalesced)."""
    rng = np.random.default_rng(41)
    centers = rng.standard_normal((12, D)).astype(np.float32)
    blocks = [(centers[rng.integers(0, 12, n)] + 0.4 * rng.standard_normal(
        (n, D))).astype(np.float32) for n in (500, 300)]
    ref_reader, reader = _readers(blocks, {0: {5}})
    field = {"type": "dense_vector", "dims": D, "similarity": "cosine"}
    if options:
        field["index_options"] = options
    props = {"properties": {"v": field}}
    ref = ref_store.VectorStoreShard()
    ref.sync(ref_reader, ref_mapping.MapperService(props).vector_fields())
    port = VectorStoreShard(device="cpu")
    port.restore_ivf_layout(ref.export_ivf_layout())
    port.sync(reader, mapping.MapperService(props).vector_fields())
    assert (port.field("v").router is not None) is (options is not None)
    queries = (blocks[0][rng.integers(0, 500, 8)]
               + 0.2 * rng.standard_normal((8, D))).astype(np.float32)
    got = _run_concurrently(port, "v", [
        (lambda q=q: port.search("v", q, K)) for q in queries])
    for q, res in zip(queries, got):
        _assert_same_hits(res, ref.search("v", q, K))
    sched = port.scheduler_stats()
    assert (sched["batches"], sched["requests"]) == (2, 8)
    assert sched["pipelined_batches"] == 2
    assert port.knn_stats["searches"] == 2
    assert port.queued_requests() == 0


@pytest.mark.parametrize("options", [None, {"type": "int4_flat"},
                                     {"type": "int8_ivf", "nlist": 16,
                                      "nprobe": 4}])
def test_search_many_async_then_finalize_equals_search_many(options):
    rng = np.random.default_rng(43)
    blocks = [rng.standard_normal((700, D)).astype(np.float32)]
    _, reader = _readers(blocks, {})
    field = {"type": "dense_vector", "dims": D}
    if options:
        field["index_options"] = options
    store = VectorStoreShard(device="cpu")
    store.sync(reader, mapping.MapperService(
        {"properties": {"v": field}}).vector_fields())
    queries = list(rng.standard_normal((5, D)).astype(np.float32))
    want = store.search_many("v", queries, K, num_candidates=50)
    handle = store.search_many_async("v", queries, K, num_candidates=50)
    got = store.finalize_many(handle)
    assert len(got) == len(want) == 5
    for (gr, gs), (wr, ws) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gs, ws)
    # a batch of 5 runs at the bucket of 8, a single query at bucket 1: the
    # product's summation order may differ in the last bits there, so the
    # batch-1 answers are held to the parity rule (rows where gaps exceed
    # 1e-4, raw scores within 2e-5)
    for q, res in zip(queries, want):
        _assert_same_hits(store.search("v", q, K, num_candidates=50), res)


def test_sync_between_submits_serves_each_request_its_snapshot():
    """A request queued in a batcher that a refresh retires is served
    against the corpus that batcher closed over; a request after the
    refresh sees the new one. Retired counters are kept."""
    import threading
    rng = np.random.default_rng(47)
    old = [rng.standard_normal((200, D)).astype(np.float32)]
    new = [-old[0], rng.standard_normal((50, D)).astype(np.float32)]
    props = mapping.MapperService({"properties": {"v": {
        "type": "dense_vector", "dims": D}}}).vector_fields()
    _, old_reader = _readers(old, {})
    # new segments (an engine rewrite of the rows): the store rebuilds
    _, new_reader = _readers(new, {}, first_seg_id=10)
    queries = rng.standard_normal((3, D)).astype(np.float32)
    oracles = []
    for reader in (old_reader, new_reader):
        oracle = VectorStoreShard(device="cpu")
        oracle.sync(reader, props)
        oracles.append([oracle.search("v", q, K) for q in queries])

    store = VectorStoreShard(device="cpu")
    store.sync(old_reader, props)
    started, gate = _hold_first_dispatch(store)
    results = {}

    def run(i):
        results[i] = store.search("v", queries[i], K)

    first = threading.Thread(target=run, args=(0,))
    first.start()
    assert started.wait(10)
    queued = threading.Thread(target=run, args=(1,))
    queued.start()
    while store.pending_requests("v") < 1:
        queued.join(0.002)
    store.sync(new_reader, props)             # retires the old batcher
    assert store.pending_requests("v") == 0   # ... which is out of the map
    run(2)                                    # the new snapshot, at once
    gate.set()
    for t in (first, queued):
        t.join(10)
        assert not t.is_alive()
    for i, snapshot in ((0, 0), (1, 0), (2, 1)):
        for got, want in zip(results[i], oracles[snapshot][i]):
            np.testing.assert_array_equal(got, want)
    # the old batcher's counters folded into the total when it retired
    # (one batch then, in flight); as in the reference, the batch it ran
    # after its retirement is not counted
    sched = store.scheduler_stats()
    assert (sched["batches"], sched["requests"]) == (2, 2)


def test_each_thread_reads_its_own_phases():
    """`last_knn_phases` is per thread: a request on an int4_ivf field
    keeps its route and rescore phases while another thread's flat search
    lands in between."""
    import threading
    rng = np.random.default_rng(53)
    n = 700
    vecs = {f: rng.standard_normal((n, D)).astype(np.float32)
            for f in ("v", "w")}
    seg = segment.Segment(0, 0, [f"d{i}" for i in range(n)], [None] * n,
                          {f: (m, np.ones(n, dtype=bool))
                           for f, m in vecs.items()})
    reader = segment.ShardReader([segment.SegmentView(seg, None)])
    store = VectorStoreShard(device="cpu")
    store.sync(reader, mapping.MapperService({"properties": {
        "v": {"type": "dense_vector", "dims": D,
              "index_options": {"type": "int4_ivf", "nlist": 8}},
        "w": {"type": "dense_vector", "dims": D}}}).vector_fields())
    ivf_done, flat_done = threading.Event(), threading.Event()
    seen = {}

    def ivf_request():
        store.search("v", vecs["v"][3], K)
        ivf_done.set()
        assert flat_done.wait(10)
        seen["ivf"] = store.last_knn_phases

    def flat_request():
        assert ivf_done.wait(10)
        store.search("w", vecs["w"][3], K)
        seen["flat"] = store.last_knn_phases
        flat_done.set()

    threads = [threading.Thread(target=f) for f in (ivf_request,
                                                    flat_request)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert seen["flat"] == {}
    assert seen["ivf"]["engine"] == "tpu_ivf"
    assert seen["ivf"]["rescore"]["window"] >= K
    assert store.last_knn_phases == {}       # this thread searched nothing


def test_refresh_race_keeps_no_stale_batcher():
    """A request that read the field before a refresh swapped it is served
    through a batcher nothing keeps (no cached batcher holds the old
    corpus), and retiring the field again keeps the current build's
    batcher."""
    rng = np.random.default_rng(59)
    old = [rng.standard_normal((200, D)).astype(np.float32)]
    new = old + [rng.standard_normal((50, D)).astype(np.float32)]
    props = mapping.MapperService({"properties": {"v": {
        "type": "dense_vector", "dims": D}}}).vector_fields()
    _, old_reader = _readers(old, {})
    _, new_reader = _readers(new, {})
    store = VectorStoreShard(device="cpu")
    store.sync(old_reader, props)
    old_fc = store.field("v")
    store.sync(new_reader, props)
    q = rng.standard_normal(D).astype(np.float32)
    stale = store._batcher("v", old_fc, K, "bf16", None)
    assert all(b is not stale for _, b in store._batchers.values())
    rows, _ = stale.submit((q, None))[0]         # (vector, filter rows)
    assert rows.max() < 200                       # the old snapshot's rows
    store.search("v", q, K)
    (fc, current), = store._batchers.values()
    assert fc is store.field("v")
    store._retire_field("v")
    assert list(store._batchers.values()) == [(fc, current)]


@pytest.mark.parametrize("retire", [True, False])
def test_plan_change_at_the_same_version_replaces_the_batcher(retire):
    """A mapping change without a new segment set (same version, so the
    same batcher key) serves the new encoding once the merge thread has
    re-encoded the field, also when a search lands between the swap and
    the retirement (`retire` False holds the retirement back)."""
    rng = np.random.default_rng(61)
    blocks = [rng.standard_normal((300, D)).astype(np.float32)]
    _, reader = _readers(blocks, {})
    store = VectorStoreShard(device="cpu")
    q = blocks[0][7]
    for options, dtype in ((None, torch.bfloat16),
                           ({"type": "int8_flat"}, torch.int8)):
        field = {"type": "dense_vector", "dims": D}
        if options:
            field["index_options"] = options
            if not retire:
                store._retire_field = lambda field: None
        store.sync(reader, mapping.MapperService(
            {"properties": {"v": field}}).vector_fields())
        # the new encoding is a retarget: the merge thread re-encodes
        store._gens["v"].drain()
        assert store.field("v").corpus.matrix.dtype == dtype
        rows, _ = store.search("v", q, K)
        assert rows[0] == 7
        (fc, _), = store._batchers.values()
        assert fc is store.field("v")
    assert store.scheduler_stats()["batches"] == 2
