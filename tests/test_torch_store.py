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


def _readers(blocks, deleted):
    """The same two segments as a reference and a port ShardReader."""
    ref_views, views, base = [], [], 0
    for seg_id, vecs in enumerate(blocks):
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
        dels = deleted.get(seg_id)
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
    assert store.field("v") is not fc and len(store.field("v").row_map) == 50
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
    ms = mapping.MapperService({"properties": {"v": {
        "type": "dense_vector", "dims": D,
        "index_options": {"type": "int8_ivf", "nlist": 8}}}})
    engine = Engine(ms)
    store = VectorStoreShard(device="cpu")
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
    assert store.field("v").router is router        # placed, not retrained
    assert router.index.total == 700 and store.knn_stats["ivf_trains"] == 1
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
