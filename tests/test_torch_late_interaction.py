"""The late-interaction field store against the JAX package: the same docs
fed to a reference `Engine` and to the port's `Engine`, then synced into
each package's `LateInteractionShard` (the port's on the CPU).

Byte-identical: per-segment token blocks, and after `sync` the token tile,
`tile_scales`, `row_map`, `cap`, `n_pad` and the coarse corpus of pooled
centroids, at f32, bf16 (the port holds its bit pattern), int8 and int4.
`search_batch` rows are equal and scores within rtol 1e-5 (the MaxSim
boards differ only in f32 sum order; see tests/test_torch_maxsim.py); the
host walker gives the same rows and scores within 1e-6."""

import tempfile

import numpy as np
import pytest
import torch

from elasticsearch_tpu.columnar import blocks as ref_blocks
from elasticsearch_tpu.common import errors as ref_errors
from elasticsearch_tpu.index.engine import Engine as RefEngine
from elasticsearch_tpu.index.mapping import MapperService as RefMappers
from elasticsearch_tpu.search.queries import (
    SearchContext as RefContext, parse_query as ref_parse)
from elasticsearch_tpu.vectors.late_interaction import (
    LateInteractionShard as RefShard)
from elasticsearch_tpu_torch.columnar import blocks as port_blocks
from elasticsearch_tpu_torch.common.errors import MapperParsingError
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.search.queries_ext import LateInteractionQuery
from elasticsearch_tpu_torch.vectors import late_interaction as late_mod
from elasticsearch_tpu_torch.vectors.late_interaction import (
    LateInteractionShard)

ENCODINGS = ["f32", "bf16", "int8", "int4"]


def _clustered(rng, n_docs, dims, max_tokens, n_topics=12, noise=0.25):
    """Docs whose tokens scatter around shared topic vectors (the
    reference's recall-test geometry)."""
    topics = rng.standard_normal((n_topics, dims)).astype(np.float32)
    return [(topics[i % n_topics] + noise * rng.standard_normal(
        (int(rng.integers(2, max_tokens + 1)), dims))).astype(np.float32)
        for i in range(n_docs)]


def _pair(rng, n_docs=60, dims=16, max_tokens=6, similarity="cosine",
          **field):
    """The same docs in both engines, over two refreshes (two segments):
    doc "3" is updated (a tombstone), doc "nofield" has no tokens, and the
    port loads its second batch through `index_many(token_vectors=)`."""
    mapping = {"properties": {"colv": {"type": "rank_vectors", "dims": dims,
                                       "similarity": similarity, **field}}}
    ref_ms, port_ms = RefMappers(mapping), MapperService(mapping)
    ref_eng = RefEngine(tempfile.mkdtemp(), ref_ms)
    port_eng = Engine(port_ms)
    docs = _clustered(rng, n_docs, dims, max_tokens)
    half = n_docs // 2
    for i, d in enumerate(docs[:half]):
        ref_eng.index(str(i), {"colv": d.tolist()})
        port_eng.index(str(i), {"colv": d.tolist()})
    for eng in (ref_eng, port_eng):
        eng.index("nofield", {"other": 1})
        eng.refresh()
    docs[3] = docs[3][::-1].copy()
    for i, d in list(enumerate(docs))[half:] + [(3, docs[3])]:
        ref_eng.index(str(i), {"colv": d.tolist()})
    batch = list(range(half, n_docs)) + [3]
    port_eng.index_many(
        [str(i) for i in batch],
        token_vectors={"colv": (np.concatenate([docs[i] for i in batch]),
                                np.array([len(docs[i]) for i in batch]))})
    for eng in (ref_eng, port_eng):
        eng.refresh()
    return (ref_ms, ref_eng.acquire_searcher(), port_ms,
            port_eng.acquire_searcher(), docs)


def _tile_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_blocks_and_tiles_byte_identical(encoding):
    rng = np.random.default_rng(21)
    ref_ms, ref_reader, port_ms, port_reader, _docs = _pair(
        rng, encoding=encoding)
    variant = (encoding, "cosine", 16)
    for rv, pv in zip(ref_reader.views, port_reader.views):
        rb = ref_blocks.extract_token_vector_block(rv, "colv", variant)
        pb = port_blocks.extract_token_vector_block(pv, "colv", variant)
        assert rb.fingerprint == pb.fingerprint
        for key in ("data", "scales", "counts", "pooled", "rows"):
            a, b = getattr(rb, key), getattr(pb, key)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), key
    ref_lf = RefShard().field(ref_reader, ref_ms.get("colv"))
    lf = LateInteractionShard(device="cpu").field(port_reader,
                                                  port_ms.get("colv"))
    assert (lf.n_docs, lf.cap, lf.n_pad, lf.tokens_total) \
        == (ref_lf.n_docs, ref_lf.cap, ref_lf.n_pad, ref_lf.tokens_total)
    assert lf.n_docs == 60 and lf.n_pad > lf.n_docs
    assert np.array_equal(lf.row_map, ref_lf.row_map)
    assert tuple(lf.tile.shape) == ref_lf.tile.shape
    assert _tile_bytes(lf.tile) == np.ascontiguousarray(ref_lf.tile).tobytes()
    assert _tile_bytes(lf.tile_scales) == ref_lf.tile_scales.tobytes()
    assert lf.nbytes() == ref_lf.nbytes()
    ref_coarse = np.asarray(ref_lf.coarse_corpus.matrix)
    assert lf.coarse_corpus.matrix.numpy().tobytes() == ref_coarse.tobytes()
    assert lf.coarse_corpus.num_valid == ref_lf.coarse_corpus.num_valid
    assert lf.coarse_window(10) == ref_lf.coarse_window(10)


def test_refresh_reencodes_only_new_segments():
    rng = np.random.default_rng(22)
    ms = MapperService({"properties": {"colv": {"type": "rank_vectors",
                                                "dims": 8}}})
    eng = Engine(ms)
    for i in range(20):
        eng.index(str(i), {"colv": rng.standard_normal((3, 8)).tolist()})
    eng.refresh()
    shard = LateInteractionShard(device="cpu")
    lf = shard.field(eng.acquire_searcher(), ms.get("colv"))
    assert lf.columnar_refresh["mode"] == "full"
    for i in range(20, 30):
        eng.index(str(i), {"colv": rng.standard_normal((2, 8)).tolist()})
    eng.refresh()
    lf = shard.field(eng.acquire_searcher(), ms.get("colv"))
    assert lf.columnar_refresh == {"blocks": 2, "cached": 1, "extracted": 1,
                                   "mode": "delta"}
    assert lf.n_docs == 30 and shard.stats["rebuilds"] == 2
    shard.field(eng.acquire_searcher(), ms.get("colv"))
    assert shard.stats["rebuilds"] == 2


def _both_search(ref_ms, ref_reader, port_ms, port_reader, queries, k):
    want = RefShard().search_batch(ref_reader, ref_ms.get("colv"), queries, k)
    shard = LateInteractionShard(device="cpu")
    got = shard.search_batch(port_reader, port_ms.get("colv"), queries, k)
    assert len(got) == len(want)
    for (gr, gs), (wr, ws) in zip(got, want):
        assert np.array_equal(gr, wr)
        assert gs.dtype == np.float32
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    return got, shard


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_search_batch_matches_reference(encoding):
    rng = np.random.default_rng(23)
    ref_ms, ref_reader, port_ms, port_reader, docs = _pair(
        rng, encoding=encoding, oversample=4)
    queries = [(docs[5][:3], 1.0), (docs[17][:2] + 0.1, 2.5),
               (rng.standard_normal((9, 16)).astype(np.float32), 1.0)]
    got, shard = _both_search(ref_ms, ref_reader, port_ms, port_reader,
                              queries, 10)
    assert all(len(r) == 10 for r, _ in got)
    assert shard.stats["searches"] == 1 and shard.stats["queries"] == 3
    assert set(shard.last_phases) == {"coarse_nanos", "rescore_nanos",
                                      "select_nanos"}


@pytest.mark.parametrize("encoding", ["int8", "int4"])
def test_wide_query_search_batch_matches_reference(encoding):
    """Queries of 132 and 300 query tokens (query rows padded to 256 and
    512) go through the coarse search and the MaxSim rescore, as in the
    reference's own store."""
    rng = np.random.default_rng(26)
    ref_ms, ref_reader, port_ms, port_reader, docs = _pair(
        rng, encoding=encoding)
    queries = [(rng.standard_normal((132, 16)).astype(np.float32), 1.0),
               (np.tile(docs[9], (60, 1))[:300] + 0.05, 1.5)]
    got, shard = _both_search(ref_ms, ref_reader, port_ms, port_reader,
                              queries, 10)
    assert all(len(r) == 10 for r, _ in got)
    assert shard.stats["searches"] == 1 and shard.stats["queries"] == 2


def test_rebuild_during_a_search_keeps_its_snapshot(monkeypatch):
    """A refresh that rebuilds the field (updated docs shift its row map)
    while a search is between its coarse phase and its selection does not
    change that search: it reads one snapshot (tile, scales, row map, doc
    count) from start to end."""
    rng = np.random.default_rng(27)
    ms = MapperService({"properties": {"colv": {"type": "rank_vectors",
                                                "dims": 8}}})
    eng = Engine(ms)
    for i in range(40):
        eng.index(str(i), {"colv": rng.standard_normal((4, 8)).tolist()})
    eng.refresh()
    old_reader, mapper = eng.acquire_searcher(), ms.get("colv")
    queries = [(rng.standard_normal((3, 8)).astype(np.float32), 1.0)]
    want = LateInteractionShard(device="cpu").search_batch(
        old_reader, mapper, queries, 10)
    for i in list(range(8)) + list(range(40, 300)):   # 0-7 updated: the
        eng.index(str(i), {"colv": rng.standard_normal((9, 8)).tolist()})
    eng.refresh()                                    # row map shifts
    new_reader = eng.acquire_searcher()
    shard = LateInteractionShard(device="cpu")
    lf = shard.field(old_reader, mapper)
    rescore = late_mod.maxsim.maxsim_rescore

    def rebuild_then_rescore(*args):
        shard.field(new_reader, mapper)          # the refresh lands here
        return rescore(*args)

    monkeypatch.setattr(late_mod.maxsim, "maxsim_rescore",
                        rebuild_then_rescore)
    got = lf.search_batch(queries, 10)
    assert lf.n_docs == 300 and shard.stats["rebuilds"] == 2
    assert np.array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], want[0][1])


def test_boost_and_padding_rows_match_reference():
    """A window wider than the docs (oversample 32 over 33 docs) puts
    padding rows of the coarse corpus into it: they clamp onto the tile's
    padding row and never surface; boost scales the scores."""
    rng = np.random.default_rng(24)
    ref_ms, ref_reader, port_ms, port_reader, docs = _pair(
        rng, n_docs=33, oversample=32, similarity="dot_product")
    for boost in (1.0, 2.5):
        got, _ = _both_search(ref_ms, ref_reader, port_ms, port_reader,
                              [(docs[0][:2], boost)], 33)
        rows, scores = got[0]
        assert {port_reader.get_id(int(r)) for r in rows} \
            == {str(i) for i in range(33)}
        assert np.all(np.isfinite(scores))


def test_walker_matches_reference():
    rng = np.random.default_rng(25)
    for similarity in ("cosine", "dot_product"):
        ref_ms, ref_reader, port_ms, port_reader, docs = _pair(
            rng, similarity=similarity)
        qtok = docs[7][:3] + 0.05
        ds = ref_parse({"late_interaction": {
            "field": "colv", "query_tokens": qtok.tolist(),
            "boost": 1.5}}).execute(RefContext(ref_reader, ref_ms))
        rows, scores = LateInteractionQuery(
            "colv", qtok.tolist(), boost=1.5).execute(port_reader, port_ms)
        assert np.array_equal(rows, np.asarray(ds.rows))
        np.testing.assert_allclose(scores, np.asarray(ds.scores),
                                   rtol=1e-6, atol=1e-6)
        assert len(rows) == 60


MAPPER_CASES = [
    {"type": "rank_vectors"},
    {"type": "rank_vectors", "dims": 8, "similarity": "l2_norm"},
    {"type": "rank_vectors", "dims": 8, "encoding": "binary"},
    {"type": "rank_vectors", "dims": 7, "index_options": {"encoding": "int4"}},
    {"type": "rank_vectors", "dims": 8, "coarse": "fp8"},
    {"type": "rank_vectors", "dims": 8, "oversample": 0},
    {"type": "rank_vectors", "dims": 8, "index_options": {"oversample": "x"}},
]


@pytest.mark.parametrize("case", range(len(MAPPER_CASES)))
def test_mapper_errors_match_reference(case):
    mapping = {"properties": {"c": MAPPER_CASES[case]}}
    with pytest.raises(ref_errors.MapperParsingError) as want:
        RefMappers(mapping)
    with pytest.raises(MapperParsingError) as got:
        MapperService(mapping)
    assert got.value.message == want.value.message


def test_mapper_defaults_and_refusals():
    m = MapperService({"properties": {"c": {"type": "rank_vectors",
                                            "dims": 8}}}).get("c")
    assert (m.encoding, m.similarity, m.oversample, m.coarse) \
        == ("int8", "cosine", 4, "f32")
    with pytest.raises(MapperParsingError, match="binary rung is not ported"):
        MapperService({"properties": {"c": {
            "type": "rank_vectors", "dims": 8,
            "index_options": {"coarse": "binary"}}}})
    eng = Engine(MapperService({"properties": {"c": {
        "type": "rank_vectors", "dims": 8}}}))
    for bad in ([[1.0] * 5], [[float("nan")] * 8], "x", [1.0] * 8,
                [[1.0] * 8, [1.0] * 3]):
        with pytest.raises(MapperParsingError):
            eng.index("x", {"c": bad})
    # an empty list is a document without tokens, as in the reference
    eng.index("empty", {"c": []})
    assert eng.get("empty")["_source"] == {"c": []}
    toks = np.ones((5, 8), np.float32)
    for tokens, counts in ((toks, [2, 2]), (toks, [3, 3, -1]),
                           (np.ones((5, 7), np.float32), [2, 3, 0]),
                           (toks * np.inf, [2, 3, 0]), (toks, [2.0, 3, 0])):
        with pytest.raises(MapperParsingError):
            eng.index_many(["a", "b", "c"],
                           token_vectors={"c": (tokens, counts)})
    eng.index_many(["a", "b", "c"], token_vectors={"c": (toks, [2, 0, 3])})
    eng.refresh()
    assert eng.get("b")["_source"] == {}
    assert eng.get("c")["_source"]["c"] == toks[2:].tolist()
