"""Generational device segments of the port (`elasticsearch_tpu_torch/
segments/`, `columnar/store.py`, the store's generational path, the engine
merge and `_forcemerge`) against the reference package on the CPU.

The same numpy segments go through the same multi-refresh sequences in
the reference's generational `VectorStoreShard` and the port's: appends
seal L0 generations, deletes set tombstones, k deeper than a generation,
per-query filters, merges, a search dispatched before a merge and landed
after it, a segment rewrite, the rebuild counters, the settings and
`index.segments.enabled: false`. Hits must have the same rows where the
reference's score gaps exceed 1e-4 and raw scores within 2e-5 (the store
tolerance of test_torch_store.py), and `segment_stats()` the reference's
counters. The merge policy is held to the reference's on 200 seeded
generation lists, an IVF compaction (the reference's retrained layout
carried into the port's) to the same probed lists, and `_forcemerge` to
the reference through both REST layers.
"""

import threading
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index import mapping as ref_mapping
from elasticsearch_tpu.index import segment as ref_segment
from elasticsearch_tpu.indices import service as ref_service
from elasticsearch_tpu.ops import dispatch as ref_dispatch
from elasticsearch_tpu.segments import TieredMergePolicy as RefPolicy
from elasticsearch_tpu.segments.generation import (
    generation_tier as ref_generation_tier,
)
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.columnar.store import STORE, RowSource
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index import mapping, segment
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.indices.service import (
    validate_segments_settings,
)
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.segments import TieredMergePolicy
from elasticsearch_tpu_torch.segments.generation import generation_tier
from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

D = 16
# the reference's keys of `segment_stats()` the port keeps (it has no mesh)
STAT_KEYS = ("full_rebuilds", "rebuilds_avoided", "rebuild_reasons",
             "enabled", "seals", "sealed_rows", "merges", "merged_rows",
             "aborted_merges", "tombstone_deletes", "ivf_background_builds",
             "dtype_retargets", "dtype_reencodes", "generations",
             "l0_generations", "tombstoned_rows", "bytes", "tiers")


@pytest.fixture(autouse=True)
def _no_host_mirror(monkeypatch):
    # the reference serves from its device route, as the port does
    monkeypatch.setattr(ref_store.native, "AVAILABLE", False)


class Segs:
    """The same sealed segments for both packages (one `v` field, ids
    d<row>), made from a seed."""

    def __init__(self, rng, sizes, first_seg_id=0, base=0, centers=None):
        self.ref, self.port, self.mats = [], [], []
        for i, n in enumerate(sizes):
            if centers is None:
                mat = rng.standard_normal((n, D)).astype(np.float32)
            else:
                mat = (centers[rng.integers(0, len(centers), n)]
                       + 0.4 * rng.standard_normal((n, D))).astype(
                    np.float32)
            ids = [f"d{base + j}" for j in range(n)]
            present = np.ones(n, dtype=bool)
            self.ref.append(ref_segment.Segment(
                seg_id=first_seg_id + i, base=base, num_docs=n, postings={},
                field_lengths={}, total_terms={}, doc_values={},
                vectors={"v": (mat, present)}, ids=ids, sources=[None] * n,
                seq_nos=np.arange(base, base + n, dtype=np.int64)))
            self.port.append(segment.Segment(first_seg_id + i, base, ids,
                                             [None] * n, {"v": (mat, present)}))
            self.mats.append(mat)
            base += n

    def readers(self, upto, deleted=None):
        """(reference reader, port reader) over segments [0, upto) with
        deleted = {segment index: {local docs}}."""
        deleted = deleted or {}
        return (ref_segment.ShardReader([
                    ref_segment.SegmentView(s, deleted.get(i))
                    for i, s in enumerate(self.ref[:upto])]),
                segment.ShardReader([
                    segment.SegmentView(s, deleted.get(i))
                    for i, s in enumerate(self.port[:upto])]))


def _props(similarity="cosine", options=None):
    field = {"type": "dense_vector", "dims": D, "similarity": similarity}
    if options:
        field["index_options"] = options
    return {"properties": {"v": field}}


def _stores(**kw):
    """(reference, port) generational stores, merges run by the test."""
    ref = ref_store.VectorStoreShard(segments_background_merge=False,
                                     host_mirror_max_bytes=0, **kw)
    port = VectorStoreShard(device="cpu", segments_background_merge=False,
                            **kw)
    return ref, port


def _sync(ref, port, readers, props):
    ref.sync(readers[0], ref_mapping.MapperService(props).vector_fields())
    port.sync(readers[1], mapping.MapperService(props).vector_fields())


def _same_hits(got, want):
    (got_rows, got_raw), (want_rows, want_raw) = got, want
    assert len(got_rows) == len(want_rows)
    if not len(want_rows):
        return
    np.testing.assert_allclose(got_raw, want_raw, atol=2e-5 * max(
        1.0, float(np.abs(want_raw).max())))
    gap = np.minimum(np.abs(np.diff(want_raw, prepend=np.inf)),
                     np.abs(np.diff(want_raw, append=-np.inf)))
    clear = gap > 1e-4
    np.testing.assert_array_equal(got_rows[clear], want_rows[clear])


def _assert_parity(ref, port, rng, ks=(3, 10, 64), n_queries=3,
                   filter_rows=None, precision="bf16"):
    for _ in range(n_queries):
        q = rng.standard_normal(D).astype(np.float32)
        for k in ks:
            _same_hits(port.search("v", q, k, filter_rows=filter_rows,
                                   precision=precision),
                       ref.search("v", q, k, filter_rows=filter_rows,
                                  precision=precision))


def _same_stats(port, ref):
    got, want = port.segment_stats(), ref.segment_stats()
    for key in STAT_KEYS:
        assert (key in got) == (key in want), key
        if key in want:
            assert got[key] == want[key], (key, got[key], want[key])


# ------------------------------------------------------------ the ladder

@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 256, 300, 4096, 8193,
                               100_000, 1 << 20, (1 << 20) + 1, 3 << 20])
def test_row_ladder_and_tier_match_reference(n):
    assert dispatch.bucket_gen_rows(n) == ref_dispatch.bucket_gen_rows(n)
    assert dispatch.in_gen_row_grid(n) == ref_dispatch.in_gen_row_grid(n)
    assert generation_tier(n) == ref_generation_tier(n)
    assert (dispatch.GEN_ROW_BUCKET_MIN, dispatch.MAX_GEN_ROW_BUCKET) == (
        ref_dispatch.GEN_ROW_BUCKET_MIN, ref_dispatch.MAX_GEN_ROW_BUCKET)


# ------------------------------------------------------------ the policy

FakeGen = namedtuple("FakeGen", "tier n_rows dead_rows")


@pytest.mark.parametrize("chunk", range(10))
def test_policy_matches_reference_on_seeded_lists(chunk):
    """select and force on 200 seeded generation lists (20 a case), with
    tier sizes, L0 caps and GC fractions drawn too."""
    for seed in range(chunk * 20, chunk * 20 + 20):
        rng = np.random.default_rng(seed)
        gens = []
        for _ in range(int(rng.integers(0, 14))):
            tier = int(rng.choice([0, 0, 0, 1, 2, 3, 5, 9]))
            rows = int(rng.integers(1, 128 << tier))
            dead = int(rng.integers(0, rows + 1)) if rng.random() < 0.3 \
                else 0
            gens.append(FakeGen(tier, rows, dead))
        args = (int(rng.integers(1, 6)), int(rng.integers(0, 9)),
                float(rng.choice([0.1, 0.5, 0.9])))
        for got, want in ((TieredMergePolicy(*args).select(gens),
                           RefPolicy(*args).select(gens)),
                          (TieredMergePolicy.force(gens),
                           RefPolicy.force(gens))):
            assert (None if got is None else tuple(got)) == \
                (None if want is None else tuple(want)), (seed, got, want)


def test_policy_on_the_sift_b_sequence():
    """chip_smoke.py's sift_b part: a 65,536-row base and 12 seals of 100
    rows, every pending merge run after each seal. Its expected merges
    (`chip_smoke._merge_plan` over the port's policy) are the reference
    policy's on the same sequence."""
    import chip_smoke
    plan = chip_smoke._merge_plan(TieredMergePolicy(), chip_smoke.N_SIFT_B,
                                  chip_smoke.SIFT_B_REFRESHES,
                                  chip_smoke.SIFT_B_DOCS)
    pol, gens, reasons = RefPolicy(), [chip_smoke.N_SIFT_B], {}
    for _ in range(chip_smoke.SIFT_B_REFRESHES):
        gens.append(chip_smoke.SIFT_B_DOCS)
        while True:
            spec = pol.select([FakeGen(ref_generation_tier(n), n, 0)
                               for n in gens])
            if spec is None:
                break
            reasons[spec.reason] = reasons.get(spec.reason, 0) + 1
            gens[spec.start:spec.stop] = [sum(gens[spec.start:spec.stop])]
    assert plan == (reasons, [ref_generation_tier(n) for n in gens])
    assert reasons == {"tier_full": 3}


# ---------------------------------------------- refresh sequences, parity

# name -> (sizes, steps, metric, options, ks); a step is (segments in the
# reader, {segment: deleted locals})
SEQUENCES = {
    "appends": ([400, 60, 33, 200],
                [(1, {}), (2, {}), (3, {}), (4, {})], "cosine", None,
                (3, 10, 64)),
    "k_deeper": ([150, 20, 40], [(1, {}), (2, {}), (3, {})], "l2_norm",
                 None, (25, 100, 210, 500)),
    "deletes": ([300, 80], [(2, {}), (2, {0: {0, 17, 250}, 1: {5}})],
                "cosine", None, (5, 50, 380)),
    "append_delete": ([300, 80, 50],
                      [(2, {}), (3, {0: {1, 2, 299}, 1: {79}})],
                      "dot_product", None, (10, 64)),
    "mip_deletes_only_l0": ([256, 64, 64],
                            [(2, {}), (3, {}), (3, {2: {0, 63}})],
                            "max_inner_product", None, (10, 100)),
    "int8_rescore": ([300, 90, 40],
                     [(2, {}), (3, {0: {4, 8}})], "cosine",
                     {"type": "int8_flat", "rescore": True}, (10, 40)),
    "int4_two_phase": ([300, 90, 40],
                       [(2, {}), (3, {0: {4, 8}, 1: {0}})], "cosine",
                       {"type": "int4_flat"}, (10, 40)),
    "int4_two_phase_l2": ([260, 100],
                          [(1, {}), (2, {0: {9}})], "l2_norm",
                          {"type": "int4_flat"}, (10,)),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_refresh_sequence_matches_reference(name):
    sizes, steps, metric, options, ks = SEQUENCES[name]
    rng = np.random.default_rng(sorted(SEQUENCES).index(name))
    segs = Segs(rng, sizes)
    ref, port = _stores()
    props = _props(metric, options)
    # int4 scores at f32 (the reference's int4 planes at bf16 do not run
    # on the CPU), the rest at the serving default
    precision = "f32" if options and "int4" in options["type"] else "bf16"
    for upto, deleted in steps:
        _sync(ref, port, segs.readers(upto, deleted), props)
        _assert_parity(ref, port, rng, ks=ks, precision=precision)
        _same_stats(port, ref)
    st = port.segment_stats()
    assert st["full_rebuilds"] == 0
    assert st["rebuilds_avoided"] == len(steps) - 1
    phases = port.last_knn_phases
    assert phases["engine"] == "tpu_generational"
    assert phases["legs"] == ["knn.exact"] + ["segments.knn"] * (
        st["generations"] - 1)
    if options and options["type"] == "int4_flat":
        assert phases["rescore"]["window"] >= max(ks)
    # deleted rows never surface
    dead = [segs.ref[i].base + loc for i, locs in steps[-1][1].items()
            for loc in locs]
    rows, _ = port.search("v", rng.standard_normal(D).astype(np.float32),
                          sum(sizes), precision=precision)
    assert not np.isin(dead, rows).any()


@pytest.mark.parametrize("deleted", [{}, {0: {3, 100}, 1: {2}}])
def test_per_query_filters_across_generations(deleted):
    """A batch mixing filtered and unfiltered requests over three
    generations (and tombstones): the same hits as the reference's
    `search_many`."""
    rng = np.random.default_rng(11)
    segs = Segs(rng, [256, 64, 40])
    ref, port = _stores()
    props = _props()
    for upto in (1, 2, 3):
        _sync(ref, port, segs.readers(upto, deleted if upto == 3 else {}),
              props)
    filters = [np.sort(rng.choice(360, 90, replace=False)).astype(np.int64),
               None, np.arange(250, 330, dtype=np.int64),
               np.array([1, 2, 3], dtype=np.int64)]
    queries = rng.standard_normal((4, D)).astype(np.float32)
    reqs = [(q, fr) for q, fr in zip(queries, filters)]
    want = ref.search_many("v", reqs, 10)
    got = port.search_many("v", list(queries), 10, filter_rows=filters)
    for g, w, fr in zip(got, want, filters):
        _same_hits(g, w)
        if fr is not None:
            assert np.isin(g[0], fr).all()


# ------------------------------------------------------------ the merges

MERGES = {
    # tier-full over four L0 seals of 50 (tier 0 and tier 0 ...)
    "tier_full": ([300] + [50] * 5, {"segments_tier_size": 3}, {}),
    "l0_overflow": ([400] + [30] * 6,
                    {"segments_tier_size": 10, "segments_max_l0": 3}, {}),
    "tombstone_gc": ([300, 200], {},
                     {1: set(range(0, 200, 2)) | set(range(1, 60, 2))}),
}


@pytest.mark.parametrize("name", sorted(MERGES))
def test_merges_match_reference(name):
    sizes, kw, deleted = MERGES[name]
    rng = np.random.default_rng(sorted(MERGES).index(name) + 20)
    segs = Segs(rng, sizes)
    ref, port = _stores(**kw)
    props = _props()
    for upto in range(1, len(sizes) + 1):
        _sync(ref, port, segs.readers(upto), props)
    if deleted:
        _sync(ref, port, segs.readers(len(sizes), deleted), props)
    _same_stats(port, ref)
    before = port.segment_stats()
    n_ref = ref._gens["v"].run_merges()
    assert port._gens["v"].run_merges() == n_ref >= 1
    st = port.segment_stats()
    # fewer generations, or (a GC compaction) no dead row left
    assert st["generations"] < before["generations"] or (
        st["tombstoned_rows"] == 0 < before["tombstoned_rows"])
    assert st["merge_reasons"] == {name: n_ref} or name == "tier_full"
    assert name in st["merge_reasons"]
    assert st["merge_nanos"] > 0
    _same_stats(port, ref)
    _assert_parity(ref, port, rng)
    # force merge: one clean generation, served as the single corpus
    assert port._gens["v"].force_merge() and ref._gens["v"].force_merge()
    assert port.segment_stats()["generations"] == 1
    _same_stats(port, ref)
    _assert_parity(ref, port, rng)
    assert port.last_knn_phases == {}     # the monolithic path


def test_search_dispatched_before_a_merge_lands_after_it():
    """A batch dispatched against the pre-merge set lands its answer after
    the merge installed (the handle holds the set); a fresh dispatch on
    the old set still answers."""
    rng = np.random.default_rng(30)
    segs = Segs(rng, [300] + [50] * 4)
    ref, port = _stores(segments_tier_size=3)
    for upto in range(1, 6):
        _sync(ref, port, segs.readers(upto), _props())
    gc = port._gens["v"]
    fc = port.field("v")
    snap = fc.snap
    q = rng.standard_normal(D).astype(np.float32)
    want = ref.search("v", q, 10)
    handle = port.search_many_async("v", [q], 10)
    assert gc.run_merges() >= 1
    assert gc.snapshot().generations != snap.generations
    assert port.field("v") is not fc          # the merged set is served
    (got,) = port.finalize_many(handle)
    _same_hits(got, want)
    again = port.finalize_many(port._dispatch_generational(
        snap, fc, 10, "bf16", [(q, None)], None))
    _same_hits(again[0], want)
    _same_hits(port.search("v", q, 10), want)


def test_tombstone_install_is_copy_on_write():
    rng = np.random.default_rng(31)
    segs = Segs(rng, [200, 40])
    ref, port = _stores()
    _sync(ref, port, segs.readers(2), _props())
    gc = port._gens["v"]
    snap = gc.snapshot()
    old = [g.tombstones for g in snap.generations]
    _sync(ref, port, segs.readers(2, {0: {1}}), _props())
    assert not any(t.any() for t in old)
    assert gc.snapshot().dead_rows == 1 and snap.dead_rows == 0
    assert gc.snapshot().epoch > snap.epoch


def test_reader_keeps_its_generation_set():
    """A request naming the reader its filter ran on is served from the
    set synced for that reader, also after a later refresh; a merge of
    that set serves it too."""
    rng = np.random.default_rng(32)
    segs = Segs(rng, [200, 60, 60])
    port = VectorStoreShard(device="cpu", segments_background_merge=False,
                            segments_tier_size=2)
    props = mapping.MapperService(_props()).vector_fields()
    r1 = segs.readers(2)[1]
    port.sync(segs.readers(1)[1], props)
    port.sync(r1, props)
    r2 = segs.readers(3, {0: {0, 1, 2}})[1]
    q = segs.mats[0][1]
    rows_r1, _ = port.search("v", q, 5, reader=r1)
    port.sync(r2, props)
    assert port.search("v", q, 5, reader=r1)[0][0] == 1
    assert port.search("v", q, 5, reader=r1)[0].max() < 260
    assert 1 not in port.search("v", q, 5)[0]
    np.testing.assert_array_equal(port.search("v", q, 5, reader=r1)[0],
                                  rows_r1)


def test_background_merge_thread_drains_while_searching():
    """The merge thread consolidates under concurrent searches; every
    answer equals the reference's over the same rows."""
    rng = np.random.default_rng(33)
    segs = Segs(rng, [300] + [40] * 6)
    ref = ref_store.VectorStoreShard(segments_background_merge=False,
                                     host_mirror_max_bytes=0)
    port = VectorStoreShard(device="cpu", segments_tier_size=3,
                            segments_merge_budget_ms=5.0)
    queries = rng.standard_normal((6, D)).astype(np.float32)
    for upto in range(1, 8):
        _sync(ref, port, segs.readers(upto), _props())
    want = [ref.search("v", q, 10) for q in queries]
    errors = []

    def search():
        try:
            for _ in range(5):
                for q, w in zip(queries, want):
                    _same_hits(port.search("v", q, 10), w)
        except Exception as e:      # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=search) for _ in range(3)]
    for t in threads:
        t.start()
    port._gens["v"].drain()
    for t in threads:
        t.join(60)
    assert not errors, errors[0]
    st = port.segment_stats()
    assert st["merges"] >= 1 and not port._gens["v"].merge_pending()
    for q, w in zip(queries, want):
        _same_hits(port.search("v", q, 10), w)


def test_close_stops_the_merge_thread_and_drops_generations():
    rng = np.random.default_rng(34)
    segs = Segs(rng, [300] + [40] * 6)
    port = VectorStoreShard(device="cpu", segments_tier_size=3)
    props = mapping.MapperService(_props()).vector_fields()
    for upto in range(1, 8):
        port.sync(segs.readers(upto)[1], props)
    gc = port._gens["v"]
    port.close()
    assert gc._merge_thread is None or not gc._merge_thread.is_alive()
    assert gc.snapshot().generations == ()
    assert port.field("v") is None and not port._gens


# ---------------------------------------------------- rebuilds, counted

def test_segment_rewrite_rebuilds_once():
    """An engine rewrite (rows re-based) cannot be a delta: one rebuild,
    with its reason, in both packages."""
    rng = np.random.default_rng(40)
    mat = rng.standard_normal((200, D)).astype(np.float32)
    ref, port = _stores()
    for seg_id, base in ((0, 0), (7, 64)):
        one = Segs.__new__(Segs)
        Segs.__init__(one, np.random.default_rng(0), [200], seg_id, base)
        one.ref[0].vectors["v"] = one.port[0].vectors["v"] = (
            mat, np.ones(200, dtype=bool))
        _sync(ref, port, one.readers(1), _props())
    _same_stats(port, ref)
    assert port.segment_stats()["rebuild_reasons"] == {"segment_rewrite": 1}


def test_monolithic_path_counts_the_rebuild_stall():
    """With segments off, every changed refresh rebuilds, counted with the
    reference's reasons."""
    rng = np.random.default_rng(41)
    segs = Segs(rng, [200, 40])
    ref = ref_store.VectorStoreShard(segments_enabled=False,
                                     host_mirror_max_bytes=0)
    port = VectorStoreShard(device="cpu", segments_enabled=False)
    for upto, deleted in ((1, {}), (2, {}), (2, {0: {3}})):
        _sync(ref, port, segs.readers(upto, deleted), _props())
        _assert_parity(ref, port, rng, ks=(10,), n_queries=2)
    _same_stats(port, ref)
    st = port.segment_stats()
    assert st["rebuild_reasons"] == {"append_headroom": 1, "deletes": 1}
    assert st["rebuilds_avoided"] == 0 and not port._gens


def test_large_delta_seals_as_the_reference_does():
    """A delta of more rows than the field holds seals as one generation,
    as in the reference (no rebuild); a force merge then folds the set
    into one clean base in both. The hits and the counters agree."""
    rng = np.random.default_rng(42)
    segs = Segs(rng, [100, 300, 50])
    ref, port = _stores()
    for upto in (1, 2, 3):
        _sync(ref, port, segs.readers(upto), _props())
        _assert_parity(ref, port, rng, ks=(10, 64), n_queries=2)
    _same_stats(port, ref)
    st = port.segment_stats()
    assert st["rebuild_reasons"] == {} and st["full_rebuilds"] == 0
    assert st["generations"] == 3 and st["seals"] == 2
    assert port._gens["v"].force_merge() and ref._gens["v"].force_merge()
    _same_stats(port, ref)
    assert port.field("v").snap.simple
    _assert_parity(ref, port, rng, ks=(10, 64), n_queries=2)


def test_failed_background_merge_stops_and_drain_raises(monkeypatch):
    """A merge that raises ends the merge thread, which starts no retry of
    its own (a later refresh may start one); `drain()` raises the error, the set and its hits stay as they
    were, and a later merge that installs clears the error."""
    rng = np.random.default_rng(44)
    segs = Segs(rng, [300] + [40] * 4)
    port = VectorStoreShard(device="cpu", segments_tier_size=3)
    props = mapping.MapperService(_props()).vector_fields()
    port.sync(segs.readers(1)[1], props)
    gc = port._gens["v"]
    calls = []

    def failing(spec, victims):
        calls.append(spec)
        raise RuntimeError("build failed")

    gc._build_merged = failing
    raised = []
    monkeypatch.setattr(threading, "excepthook", raised.append)
    q = rng.standard_normal(D).astype(np.float32)
    for upto in range(2, 6):
        port.sync(segs.readers(upto)[1], props)
    want = port.search("v", q, 10)
    with pytest.raises(RuntimeError, match="background merge failed"):
        gc.drain(timeout_s=10)
    n_calls = len(calls)
    time.sleep(0.2)
    assert len(calls) == n_calls and gc._merge_thread is None
    # one attempt a refresh at most, each ending its thread
    assert 1 <= len(raised) == n_calls <= 3
    assert all(type(a.exc_value) is RuntimeError for a in raised)
    assert gc.merge_pending() and gc.segment_stats()["merges"] == 0
    np.testing.assert_array_equal(port.search("v", q, 10)[0], want[0])
    del gc._build_merged
    gc.run_merges()
    assert gc.merge_error is None and not gc.merge_pending()
    gc.drain(timeout_s=10)
    _same_hits(port.search("v", q, 10), want)


def test_plan_change_retargets_and_reencodes_on_the_merge_thread():
    rng = np.random.default_rng(43)
    segs = Segs(rng, [300, 60])
    ref, port = _stores()
    _sync(ref, port, segs.readers(1), _props())
    _sync(ref, port, segs.readers(2), _props())
    _sync(ref, port, segs.readers(2), _props(options={"type": "int8_flat"}))
    _same_stats(port, ref)
    assert port.field("v").corpus.matrix.dtype == torch.bfloat16
    assert port._gens["v"].run_merges() == ref._gens["v"].run_merges() == 2
    _same_stats(port, ref)
    snap = port._gens["v"].snapshot()
    assert all(g.corpus.matrix.dtype == torch.int8 for g in snap.generations)
    _assert_parity(ref, port, rng, ks=(10,))
    assert port.segment_stats()["full_rebuilds"] == 0


# ------------------------------------------------------------- settings

SETTINGS = [
    {"index.segments.enabled": "false", "index.segments.tier_size": "6",
     "index.segments.max_l0": 4, "index.segments.merge_budget_ms": "25"},
    {},
    {"index.segments.enabled": True},
    {"index.segments.tier_size": 1},
    {"index.segments.max_l0": 0},
    {"index.segments.max_l0": "x"},
    {"index.segments.merge_budget_ms": "0"},
    {"index.segments.merge_budget_ms": "abc"},
]


@pytest.mark.parametrize("i", range(len(SETTINGS)))
def test_settings_validation_matches_reference(i):
    settings = SETTINGS[i]
    try:
        want = ref_service.validate_segments_settings(settings)
    except Exception as e:      # noqa: BLE001 - compared below
        with pytest.raises(IllegalArgumentError) as got:
            validate_segments_settings(settings)
        assert str(got.value) == str(e)
        return
    assert validate_segments_settings(settings) == want


def test_segments_disabled_setting_serves_monolithic():
    from elasticsearch_tpu_torch.node import Node
    node = Node(device="cpu")
    node.create_index("t", {
        "settings": {"index.segments.enabled": False,
                     "index.segments.tier_size": 3},
        "mappings": _props()})
    store = node.index("t").store
    assert store.segments_enabled is False
    engine = node.index("t").engine
    rng = np.random.default_rng(44)
    vecs = rng.standard_normal((60, D)).astype(np.float32)
    engine.index_many([f"d{i}" for i in range(60)], vectors={"v": vecs})
    engine.refresh()
    engine.delete("d3")
    engine.refresh()
    st = node.device_segments_stats()
    assert st["full_rebuilds"] == 1 and st["rebuild_reasons"] == {
        "deletes": 1}
    assert st.get("generations", 0) == 0
    with pytest.raises(IllegalArgumentError):
        node.create_index("u", {"settings": {"index.segments.tier_size": 1},
                                "mappings": _props()})


def test_node_segment_stats_match_reference(tmp_path):
    """`Node.device_segments_stats()` against the reference's
    `_device_segments_section()` after the same writes, refreshes and a
    delete on a two-shard index."""
    from elasticsearch_tpu.node import Node as RefNode
    from elasticsearch_tpu_torch.node import Node
    ref = RefNode(str(tmp_path / "ref"))
    port = Node(device="cpu")
    try:
        body = {"settings": {"number_of_shards": 2,
                             "index.segments.enabled": True},
                "mappings": {"properties": {
                    "v": {"type": "dense_vector", "dims": 8}}}}
        ref.create_index_with_templates("t", settings=body["settings"],
                                        mappings=body["mappings"])
        port.create_index("t", body)
        rng = np.random.default_rng(5)
        for batch, n in enumerate((60, 20, 20)):
            for i in range(n):
                doc = {"v": rng.standard_normal(8).tolist()}
                ref.index_doc("t", f"{batch}_{i}", doc)
                port.index_doc("t", f"{batch}_{i}", doc)
            ref.indices.get("t").refresh()
            port.index("t").refresh()
        ref.delete_doc("t", "0_0")
        port.delete_doc("t", "0_0")
        ref.indices.get("t").refresh()
        port.index("t").refresh()
        want = ref._device_segments_section()
        got = port.device_segments_stats()
        for key in STAT_KEYS:
            assert got[key] == want[key], (key, got[key], want[key])
        assert got["full_rebuilds"] == 0 and got["rebuilds_avoided"] >= 2
    finally:
        ref.close()


# ------------------------------------------------------------------ IVF

def test_ivf_compaction_with_the_layout_carried_probes_the_same_lists():
    """An int8_ivf base loses its router at a delete (served masked, no
    router leg), and the merge thread compacts and retrains it: with the
    reference's retrained layout carried into the port's retrain, both
    routers hold the same partitions and answer the same hits through the
    same nprobe."""
    rng = np.random.default_rng(50)
    centers = rng.standard_normal((12, D)).astype(np.float32)
    segs = Segs(rng, [700, 100], centers=centers)
    props = _props(options={"type": "int8_ivf", "nlist": 16, "nprobe": 4})
    ref, port = _stores()
    ref.sync(segs.readers(1)[0],
             ref_mapping.MapperService(props).vector_fields())
    port.restore_ivf_layout(ref.export_ivf_layout())
    port.sync(segs.readers(1)[1],
              mapping.MapperService(props).vector_fields())
    assert port.knn_stats["ivf_restores"] == 1
    queries = (segs.mats[0][rng.integers(0, 700, 4)]
               + 0.2 * rng.standard_normal((4, D))).astype(np.float32)
    # an append seals an L0: the base keeps its router (the IVF leg)
    _sync(ref, port, segs.readers(2), props)
    assert port.field("v").router is port._gens["v"].snapshot() \
        .generations[0].router is not None
    for q in queries:
        _same_hits(port.search("v", q, 10), ref.search("v", q, 10))
    assert port.last_knn_phases["legs"] == ["ivf", "segments.knn"]
    # a delete in the base drops its router: masked exact legs
    _sync(ref, port, segs.readers(2, {0: {3, 30, 300}}), props)
    assert port.field("v").router is None
    n_ivf = port.knn_stats["ivf_searches"]
    for q in queries:
        _same_hits(port.search("v", q, 10), ref.search("v", q, 10))
    assert port.knn_stats["ivf_searches"] == n_ivf
    _same_stats(port, ref)
    # the compaction: the reference retrains, its layout is carried over
    assert ref._gens["v"].run_merges() == 1
    port.restore_ivf_layout(ref.export_ivf_layout())
    assert port._gens["v"].run_merges() == 1
    _same_stats(port, ref)
    assert port.segment_stats()["ivf_background_builds"] == 1
    assert port.segment_stats()["merge_reasons"] == {"tombstone_gc": 1}
    got_r = port._gens["v"].snapshot().generations[0].router
    want_r = ref._gens["v"].snapshot().generations[0].router
    np.testing.assert_array_equal(got_r.index.part_rows,
                                  want_r.index.part_rows)
    np.testing.assert_array_equal(got_r.index.centroids,
                                  want_r.index.centroids)
    for q in queries:
        _same_hits(port.search("v", q, 10), ref.search("v", q, 10))
    assert port.last_knn_phases["legs"] == ["ivf", "segments.knn"]
    # and after a force merge the one clean base serves through the router
    assert port._gens["v"].force_merge() and ref._gens["v"].force_merge()
    for q in queries:
        _same_hits(port.search("v", q, 10), ref.search("v", q, 10))
    assert port.last_knn_phases["engine"] == "tpu_ivf"


def test_generational_append_keeps_the_base_router():
    """An append-only refresh of an IVF field seals the delta and keeps
    the base's router untouched (no train, no placement)."""
    ms = mapping.MapperService(_props(options={"type": "int8_ivf",
                                               "nlist": 8}))
    engine = Engine(ms)
    store = VectorStoreShard(device="cpu", segments_background_merge=False)
    engine.add_refresh_listener(lambda r: store.sync(r, ms.vector_fields()))
    rng = np.random.default_rng(51)
    vecs = rng.standard_normal((700, D)).astype(np.float32)
    engine.index_many([str(i) for i in range(600)], vectors={"v": vecs[:600]})
    engine.refresh()
    router = store.field("v").router
    engine.index_many([str(i) for i in range(600, 700)],
                      vectors={"v": vecs[600:]})
    reader = engine.refresh()
    assert store.field("v").router is router and router.index.total == 600
    assert store.knn_stats["ivf_trains"] == 1
    rows, _ = store.search("v", vecs[650], 1)
    assert reader.get_id(int(rows[0])) == "650"
    assert store.segment_stats()["seals"] == 1


# ----------------------------------------------------------- the blocks

def test_block_store_reads_only_new_segments_and_pins_nothing():
    rng = np.random.default_rng(60)
    segs = Segs(rng, [200, 50, 30])
    STORE.reset()
    port = VectorStoreShard(device="cpu", segments_background_merge=False)
    props = mapping.MapperService(_props()).vector_fields()
    port.sync(segs.readers(1)[1], props)
    port.sync(segs.readers(2)[1], props)
    port.sync(segs.readers(3, {0: {5}})[1], props)
    # 1, then 1 new, then segment 0 changed and 2 new
    st = STORE.stats()
    assert (st["extracts"], st["hits"]) == (4, 2)
    assert st["compositions"] == {"cached": 0, "delta": 2, "full": 1}
    view = STORE.vector_view(segs.readers(3, {0: {5}})[1], "v")
    assert view.refresh == {"blocks": 3, "cached": 3, "extracted": 0,
                            "mode": "cached"}
    snap = port._gens["v"].snapshot()
    assert all(g.source.private_nbytes() == 0 for g in snap.generations)
    flat = np.array([0, 5, 199, 200, 249, 250, 279])
    want = np.concatenate(segs.mats)[flat]
    np.testing.assert_array_equal(snap.gather_rows(flat), want)
    src = RowSource.concat([RowSource.from_array(m) for m in segs.mats])
    np.testing.assert_array_equal(src.select(flat).gather(), want)
    np.testing.assert_array_equal(src.slice(195, 255).gather(),
                                  np.concatenate(segs.mats)[195:255])
    assert src.private_nbytes() == sum(m.nbytes for m in segs.mats)


# ----------------------------------------------------------- _forcemerge

def test_engine_merge_keeps_array_vectors_versions_and_seq_nos():
    ms = mapping.MapperService({"properties": {
        "v": {"type": "dense_vector", "dims": D},
        "tag": {"type": "keyword"}}})
    engine = Engine(ms)
    store = VectorStoreShard(device="cpu", segments_background_merge=False)
    engine.add_refresh_listener(lambda r: store.sync(r, ms.vector_fields()))
    rng = np.random.default_rng(61)
    vecs = rng.standard_normal((90, D)).astype(np.float32)
    engine.index_many([f"a{i}" for i in range(60)],
                      sources=[{"tag": f"t{i % 3}"} for i in range(60)],
                      vectors={"v": vecs[:60]}, routings=[None] * 60)
    engine.refresh()
    engine.index_many([f"b{i}" for i in range(30)],
                      sources=[{"tag": "b", "v": vecs[60 + i].tolist()}
                               for i in range(30)])
    engine.index("a5", {"tag": "new", "v": vecs[5].tolist()})
    engine.delete("a7")
    engine.refresh()
    before = {d: engine.get(d) for d in
              [f"a{i}" for i in range(60)] + [f"b{i}" for i in range(30)]}
    reader = engine.merge()
    assert len(engine.segments) == 1 and not engine.deleted_rows
    assert reader.num_docs == 89
    for d, doc in before.items():
        assert engine.get(d) == doc
    rows = {d: engine.version_map[d].row for d in before if d != "a7"}
    assert min(rows.values()) >= 91 and sorted(rows.values()) == list(
        range(91, 180))
    st = store.segment_stats()
    assert st["rebuild_reasons"] == {"segment_rewrite": 1}
    assert st["generations"] == 1 and st["tombstoned_rows"] == 0
    for i in (0, 5, 59, 70):
        row, _ = store.search("v", vecs[i], 1)
        assert reader.get_id(int(row[0])) == (f"a{i}" if i < 60
                                              else f"b{i - 60}")
    seg = engine.segments[0]
    assert seg.doc_values["_version"].get(
        rows["a5"] - seg.base) == 2
    engine.merge()                       # one clean segment: nothing to do
    assert store.segment_stats()["full_rebuilds"] == 1


def test_forcemerge_through_both_rest_layers(tmp_path, monkeypatch):
    from tests.torch_rest_pair import Pair
    pair = Pair(tmp_path, monkeypatch)
    try:
        rng = np.random.default_rng(62)
        vecs = rng.standard_normal((120, 8)).astype(np.float32)
        pair.same("PUT", "/fm", {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {
                "v": {"type": "dense_vector", "dims": 8},
                "tag": {"type": "keyword"}}}})
        for lo, hi in ((0, 50), (50, 90), (90, 120)):
            ops = []
            for i in range(lo, hi):
                ops += [{"index": {"_id": f"d{i}"}},
                        {"v": vecs[i].tolist(), "tag": f"t{i % 4}"}]
            pair.same("POST", "/fm/_bulk", ops, ndjson=True)
            pair.same("POST", "/fm/_refresh")
        for i in (3, 55, 100):
            pair.same("DELETE", f"/fm/_doc/d{i}")
        pair.same("POST", "/fm/_update/d10",
                  {"doc": {"v": (-vecs[10]).tolist()}})
        pair.same("POST", "/fm/_refresh")
        bodies = [{"knn": {"field": "v", "query_vector": q.tolist(),
                           "k": 10, "num_candidates": 50}, "size": 10,
                   "version": True, "seq_no_primary_term": True}
                  for q in vecs[[0, 10, 60, 110]]]
        for b in bodies:
            pair.same("POST", "/fm/_search", b)
        pair.same("POST", "/fm/_forcemerge")
        pair.same("POST", "/_forcemerge")
        pair.same("POST", "/fm/_forcemerge",
                  query={"only_expunge_deletes": "true",
                         "max_num_segments": "1"})
        for b in bodies:
            pair.same("POST", "/fm/_search", b)
        pair.same("POST", "/fm/_count")
        pair.same("GET", "/fm/_doc/d10")
        pair.same("POST", "/fm/_mget", {"ids": ["d0", "d3", "d10", "d119"]})
        ref_engine = pair.ref_node.indices.get("fm").shards[0].engine
        port_engine = pair.port_node.index("fm").engine
        assert len(port_engine.segments) == len(ref_engine.segments) == 1
        assert {d: v.row for d, v in port_engine.version_map.items()
                if not v.deleted} == {
            d: v.row for d, v in ref_engine.version_map.items()
            if not v.deleted}
        store = pair.port_node.index("fm").store
        assert store.segment_stats()["rebuild_reasons"] == {
            "segment_rewrite": 1}
    finally:
        pair.close()
