"""The port's learned-sparse layer (`ops/sparse.py`, the feature-map column
of `index/segment.py`, `columnar/blocks.py::SparsePostingsBlock` and the
`sparse_vector` / `weighted_tokens` / `rank_feature` walkers) against the
reference's on the CPU: the same seeded `rank_features` documents (Zipf
token ids, two segments, updates that tombstone rows, docs without the
field, an empty map, a list of maps) go through both packages' engines.
The tile layouts must be byte-identical; the port's board (its plain
PyTorch version on CPU tensors) must give the rows and f32 score bits of
the reference's `sparse.topk` program (JAX on the CPU), and the port's
host twin and walker those of the reference's host route and walker, at
f32, bf16 and int8 impacts. `rank_feature` scores equal the reference's
f32 bits."""

import tempfile

import numpy as np
import pytest
import torch

from elasticsearch_tpu import native as ref_native
from elasticsearch_tpu.columnar.blocks import (
    extract_sparse_postings_block as ref_extract,
)
from elasticsearch_tpu.index.engine import Engine as RefEngine
from elasticsearch_tpu.index.mapping import MapperService as RefMapperService
from elasticsearch_tpu.ops.sparse import SparseField as RefSparseField
from elasticsearch_tpu.search.queries import SearchContext as RefContext
from elasticsearch_tpu.search.queries import parse_query as ref_parse
from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.columnar import blocks
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import FeatureMapColumn
from elasticsearch_tpu_torch.ops import bm25, dispatch, sparse
from elasticsearch_tpu_torch.search.queries import SearchContext, parse_query

MAPPING = {"properties": {"feats": {"type": "rank_features"},
                          "legacy": {"type": "sparse_vector"},
                          "pr": {"type": "rank_feature"},
                          "neg": {"type": "rank_feature",
                                  "positive_score_impact": False},
                          "body": {"type": "text"}}}
VOCAB = 200


def _docs(seed: int, n: int):
    """Feature maps of 2-40 Zipf-drawn tokens with weights in (0, 3]:
    doc 5 mod 23 has no map, 11 mod 29 an empty one, 13 mod 31 a list of
    two maps; every doc a rank_feature value."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        toks = rng.choice(VOCAB, int(rng.integers(2, 41)), replace=False, p=p)
        w = rng.uniform(0.0, 3.0, len(toks)).astype(np.float32)
        fmap = {f"t{t}": float(x) for t, x in zip(toks, np.maximum(w, 1e-3))}
        doc = {"feats": fmap, "body": f"doc {i}",
               "pr": float(rng.uniform(0.1, 20.0)),
               "neg": float(rng.uniform(-5.0, 5.0))}
        if i % 7 == 2:
            doc["legacy"] = dict(list(fmap.items())[:5])
        if i % 23 == 5:
            del doc["feats"]
        if i % 29 == 11:
            doc["feats"] = {}
        if i % 31 == 13:
            doc["feats"] = [fmap, {"t1": 1.0}]
        if i % 19 == 3:
            doc["pr"] = [doc["pr"], 2.0]
        docs.append(doc)
    return docs


class Pair:
    def __init__(self):
        self.ref = RefEngine(tempfile.mkdtemp(), RefMapperService(MAPPING))
        self.port = Engine(MapperService(MAPPING))

    def index(self, ids, docs):
        for i, d in zip(ids, docs):
            self.ref.index(i, d)
        self.port.index_many(list(ids), docs)

    def refresh(self):
        return self.ref.refresh(), self.port.refresh()


@pytest.fixture(scope="module")
def readers():
    """Three snapshots: one segment; an append-only second segment; then
    updates that tombstone rows of both segments."""
    docs = _docs(7, 700)
    pair = Pair()
    pair.index([str(i) for i in range(400)], docs[:400])
    snaps = [pair.refresh()]
    pair.index([str(i) for i in range(400, 700)], docs[400:])
    snaps.append(pair.refresh())
    pair.index(["3", "41", "555"], [docs[8], docs[9], docs[10]])
    snaps.append(pair.refresh())
    return snaps


def _fields(dtype, reader_pair, field="feats"):
    ref = RefSparseField(field, dtype)
    port = sparse.SparseField(field, dtype, device="cpu")
    ref.sync(reader_pair[0])
    port.sync(reader_pair[1])
    return ref, port


def _same(a, b):
    for (ra, sa), (rb, sb) in zip(a, b, strict=True):
        assert np.array_equal(ra, rb)
        assert np.array_equal(sa.view(np.int32), sb.view(np.int32))


def _wide(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return {f"t{t}": float(rng.uniform(0.1, 2.0))
            for t in rng.permutation(VOCAB + 60)[:n]}


QUERIES = [
    ({"t1": 2.0, "t2": 0.5}, 1.0),
    ({"t5": 1.0}, 1.0),
    ({"t10": 3.0, "zzz": 9.0, "t11": 1.0, "t12": 0.25, "t0": 4.0}, 2.5),
    ({"never": 5.0}, 1.0),                    # nothing in the vocabulary
    ({"t3": 1.5, "t7": 0.75}, 0.3),
    (_wide(120), 1.0),                        # a learned-sparse width
    (_wide(250, seed=4), 1.7),                # more than the vocabulary
]


@pytest.mark.parametrize("snap", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_tile_layout_is_the_reference_bytes(readers, snap, dtype):
    ref, port = _fields(dtype, readers[snap])
    assert port.term_tiles == ref.term_tiles
    assert port.tile_slots.tobytes() == ref.tile_slots.tobytes()
    assert port.tile_impacts.tobytes() == ref.tile_impacts.tobytes()
    assert np.array_equal(port.row_map, ref.row_map)
    assert (port.n_slots, port.nnz, port.nbytes()) \
        == (ref.n_slots, ref.nnz, ref.nbytes())
    slots, impacts, scales = port._device_arrays()
    r_slots, r_impacts, r_scales = ref._device_arrays()
    assert np.array_equal(slots.numpy(), np.asarray(r_slots))
    if dtype == "bf16":
        assert np.array_equal(impacts.view(torch.int16).numpy(),
                              np.asarray(r_impacts).view(np.int16))
    else:
        assert np.array_equal(impacts.numpy(), np.asarray(r_impacts))
    assert (scales is None) == (r_scales is None)
    if scales is not None:
        assert np.array_equal(scales.numpy(), np.asarray(r_scales))


@pytest.mark.parametrize("snap", [0, 2])
@pytest.mark.parametrize("field", ["feats", "legacy", "body"])
def test_postings_block_is_the_reference_block(readers, snap, field):
    """Per segment: each feature's live slots and f32 weights, and the
    live count, as the reference's walk over the dicts gives them."""
    ref_reader, port_reader = readers[snap]
    for rv, pv in zip(ref_reader.views, port_reader.views, strict=True):
        want = ref_extract(rv, field)
        got = blocks.extract_sparse_postings_block(pv, field)
        assert got.n_live == want.n_live
        assert sorted(got.features) == sorted(want.features)
        for feat, (slots, weights) in want.features.items():
            g_slots, g_weights = got.features[feat]
            assert g_slots.tolist() == slots.tolist()
            assert g_weights.tobytes() == weights.tobytes()


def test_feature_map_column_holds_the_reference_values(readers):
    """The column gives each doc's value as the reference's column holds
    it: a dict in the map's order with the f64 weights, a list of maps,
    an empty map, or None."""
    ref_reader, port_reader = readers[2]
    kinds = set()
    for rv, pv in zip(ref_reader.views, port_reader.views):
        for field in ("feats", "legacy", "pr"):
            rcol = rv.segment.doc_values.get(field)
            pcol = pv.segment.doc_values.get(field)
            assert (rcol is None) == (pcol is None)
            if rcol is None:
                continue
            if field != "pr":
                assert isinstance(pcol, FeatureMapColumn)
            assert pcol.present.tolist() == rcol.present.tolist()
            for loc in range(rv.segment.num_docs):
                want, got = rcol.values[loc], pcol.values[loc]
                assert type(got) is type(want)
                if isinstance(want, dict):
                    assert list(got.items()) == list(want.items())
                else:
                    assert got == want
                kinds.add(type(want).__name__ + str(bool(want)))
    assert {"dictTrue", "dictFalse", "listTrue", "NoneTypeFalse"} <= kinds


@pytest.mark.parametrize("window", [5, 100, 1000])
@pytest.mark.parametrize("snap", [0, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_board_and_host_routes_match_reference(readers, snap, dtype,
                                               window):
    """Rows and f32 bits: the port's board against the reference's
    `sparse.topk` program (the quantized impacts), the port's host twin
    against the reference's host route (the f32 impacts); at f32 all four
    agree. Boosts fold into the token weights."""
    ref, port = _fields(dtype, readers[snap])
    board = port.search_batch(QUERIES, window)
    _same(board, ref.search_batch(QUERIES, window, route="device"))
    host = port.search_batch(QUERIES, window, route="host")
    _same(host, ref.search_batch(QUERIES, window, route="host"))
    if dtype == "f32":
        _same(board, host)
    assert all(len(rows) <= window for rows, _ in board)
    assert len(board[3][0]) == 0
    assert len(board[5][0]) == min(window, len(host[5][0])) > 0


@pytest.mark.parametrize("snap", [0, 2])
def test_walkers_match_the_board_and_the_reference_walker(readers, snap):
    """`sparse_vector` and `weighted_tokens` through both packages' query
    parsers: every matching row and its f32 bits, and the window the
    board ranks from them (ties to the lower row)."""
    ref_reader, port_reader = readers[snap]
    ref_ms = RefMapperService(MAPPING)
    port_ms = MapperService(MAPPING)
    _ref, port = _fields("f32", readers[snap])
    board = port.search_batch(QUERIES, 100)
    for (tokens, boost), (b_rows, b_scores) in zip(QUERIES, board):
        for body in ({"sparse_vector": {"field": "feats",
                                        "query_vector": tokens,
                                        "boost": boost}},
                     {"weighted_tokens": {"feats": {"tokens": tokens,
                                                    "boost": boost}}}):
            want = ref_parse(body).execute(RefContext(ref_reader, ref_ms))
            got = parse_query(body).execute(SearchContext(port_reader,
                                                          port_ms))
            assert got.rows.tolist() == want.rows.tolist()
            assert got.scores.tobytes() == want.scores.tobytes()
            top = native.topk(got.scores, min(100, len(got.rows)))
            assert top.tolist() == ref_native.topk(
                want.scores, min(100, len(want.rows))).tolist()
            assert got.rows[top].tolist() == b_rows.tolist()
            assert got.scores[top].tobytes() == b_scores.tobytes()


def test_batch_matches_single_queries(readers):
    _ref, port = _fields("f32", readers[2])
    batched = port.search_batch(QUERIES, 50)
    for q, got in zip(QUERIES, batched):
        _same([got], port.search_batch([q], 50))


def test_docs_without_the_field_never_match():
    """A doc without the field, with an empty map or with a list of maps
    (which the reference keeps as a plain value) holds no posting, in
    both packages."""
    ms = {"properties": {"feats": {"type": "rank_features"}}}
    ref = RefEngine(tempfile.mkdtemp(), RefMapperService(ms))
    port = Engine(MapperService(ms))
    docs = [("a", {"feats": {"x": 1.0}}), ("b", {}), ("c", {"feats": {"y": 2.0}}),
            ("d", {"feats": {}}), ("e", {"feats": [{"x": 3.0}, {"y": 1.0}]})]
    for i, d in docs:
        ref.index(i, d)
    port.index_many([i for i, _ in docs], [d for _, d in docs])
    ref_r, port_r = ref.refresh(), port.refresh()
    sf = sparse.SparseField("feats", device="cpu")
    sf.sync(port_r)
    ref_sf = RefSparseField("feats")
    ref_sf.sync(ref_r)
    q = [({"x": 1.0, "y": 1.0}, 1.0)]
    (rows, _), = sf.search_batch(q, 10)
    assert {port_r.get_id(int(r)) for r in rows} == {"a", "c"}
    _same(sf.search_batch(q, 10), ref_sf.search_batch(q, 10, route="host"))
    assert sf.n_slots == ref_sf.n_slots == 5


def test_append_and_update_refreshes_rebuild_as_the_reference():
    """An append-only refresh extracts only the new segment; updates
    tombstone rows; each layout and answer equals the reference's."""
    ms = {"properties": {"feats": {"type": "rank_features"}}}
    ref = RefEngine(tempfile.mkdtemp(), RefMapperService(ms))
    port = Engine(MapperService(ms))

    def index(ids, docs):
        for i, d in zip(ids, docs):
            ref.index(i, d)
        port.index_many(list(ids), docs)

    index([str(i) for i in range(50)],
          [{"feats": {"alpha": 1.0 + i % 7, f"tok{i % 5}": 2.0}}
           for i in range(50)])
    port_sf = sparse.SparseField("feats", device="cpu")
    q = [({"alpha": 1.0, "tok2": 0.5}, 1.0)]
    for step in range(3):
        ref_r, port_r = ref.refresh(), port.refresh()
        assert port_sf.sync(port_r)
        assert not port_sf.sync(port_r)
        ref_sf = RefSparseField("feats")
        ref_sf.sync(ref_r)
        assert port_sf.tile_impacts.tobytes() == ref_sf.tile_impacts.tobytes()
        assert port_sf.tile_slots.tobytes() == ref_sf.tile_slots.tobytes()
        _same(port_sf.search_batch(q, 100),
              ref_sf.search_batch(q, 100, route="device"))
        if step == 0:
            assert port_sf.columnar_refresh["mode"] == "full"
            index([str(i) for i in range(50, 80)],
                  [{"feats": {"alpha": 0.5, "beta": 3.0}}] * 30)
        elif step == 1:
            assert port_sf.columnar_refresh == {
                "blocks": 2, "cached": 1, "extracted": 1, "mode": "delta"}
            index(["3", "60"], [{"feats": {"alpha": 9.0}}, {"other": 1}])
        else:
            (rows, _), = port_sf.search_batch(q, 100)
            ids = [port_r.get_id(int(r)) for r in rows]
            assert ids[0] == "3" and "60" not in ids


def test_plan_positions_carry_each_tokens_boost(readers):
    """Query q's plan entries are its in-vocabulary tokens in the map's
    order, each with its token's f32(f32(weight) * f32(boost)) bits: the
    host twin's tiles and boosts, one entry a token."""
    _ref, port = _fields("f32", readers[2])
    tile_ids, boosts, _m = port.plan_queries(QUERIES)
    pos_starts, runs = port.plan_positions(QUERIES)
    assert pos_starts[0] == 0 and pos_starts[-1] == runs.shape[1]
    for qi, (tokens, boost) in enumerate(QUERIES):
        mine = runs[:, pos_starts[qi]:pos_starts[qi + 1]]
        in_vocab = [t for t in tokens if t in port.term_tiles]
        assert [tuple(e) for e in mine[:2].T.tolist()] \
            == [port.term_tiles[t] for t in in_vocab]
        want = tile_ids[qi][tile_ids[qi] >= 0]
        assert [t for f, n in mine[:2].T.tolist()
                for t in range(f, f + n)] == want.tolist()
        assert np.array_equal(np.repeat(mine[2].view(np.float32), mine[1]),
                              boosts[qi][:len(want)])
        for j, t in enumerate(in_vocab):
            b = np.float32(np.float32(tokens[t]) * np.float32(boost))
            assert mine[2, j] == b.view(np.int32)


@pytest.mark.parametrize("field", ["feats", "legacy"])
def test_sparse_tile_first_is_lane_0_and_ascends(readers, field):
    _ref, port = _fields("int8", readers[2], field)
    assert np.array_equal(port.tile_first, port.tile_slots[:, 0])
    for first, nt in port.term_tiles.values():
        run = port.tile_first[first:first + nt]
        assert (run >= 0).all() and (np.diff(run) > 0).all()


@pytest.mark.parametrize("range_slots", [32, 160])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_sparse_ranged_plain_version_is_the_plain_version(readers, dtype,
                                                          range_slots):
    """On the learned-sparse layout (a boost a token, up to 250 tokens a
    query) the kernels' range decomposition in plain PyTorch gives the
    plain version's window, bit for bit, k past one range."""
    _ref, port = _fields(dtype, readers[2])
    pos_starts, runs = port.plan_positions(QUERIES)
    args = (torch.from_numpy(pos_starts), torch.from_numpy(runs),
            torch.ones(len(QUERIES), dtype=torch.int32),
            port._device_tile_first(), *port._device_arrays())
    for k in (10, 2 * range_slots + 1):
        want = bm25.bm25_board_reference(*args, k, port.n_slots)
        got = bm25.bm25_board_ranged_reference(*args, k, port.n_slots,
                                               range_slots=range_slots)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_sparse_ranged_board_route_matches_reference(readers, dtype,
                                                     monkeypatch):
    """The sparse board route through the ranged plain version (ranges of
    64 slots, windows past one range) against the reference's
    `sparse.topk` program on the CPU: the same rows and f32 bits."""
    ref, port = _fields(dtype, readers[2])
    monkeypatch.setattr(bm25, "bm25_board", lambda *a, variant=None: (
        bm25.bm25_board_ranged_reference(*a, range_slots=64)))
    for window in (10, 300):
        _same(port.search_batch(QUERIES, window),
              ref.search_batch(QUERIES, window, route="device"))


def test_board_counts_no_launch_on_the_cpu(readers, monkeypatch):
    """On CPU tensors the wrapper runs the plain version and counts
    nothing; the sparse layout passes its variant to the wrapper, which
    counts it only where the kernel launches."""
    _ref, port = _fields("f32", readers[2])
    seen = []
    board = bm25.bm25_board
    monkeypatch.setattr(bm25, "bm25_board", lambda *a, **k: (
        seen.append(k.get("variant")), board(*a, **k))[1])
    dispatch.reset_launches()
    port.search_batch(QUERIES, 10)
    assert seen == [sparse.VARIANT]
    assert dispatch.launches().get(bm25.KERNEL, 0) == 0
    assert not dispatch.variant_launches()


RANK_FEATURE_BODIES = [
    {"field": "pr"},
    {"field": "pr", "saturation": {"pivot": 4.0}, "boost": 2.0},
    {"field": "pr", "log": {"scaling_factor": 3.0}},
    {"field": "pr", "sigmoid": {"pivot": 7.0, "exponent": 0.6}},
    {"field": "pr", "linear": {}},
    {"field": "neg", "linear": {}, "boost": 0.5},
    {"field": "feats.t1"},
    {"field": "feats.t4", "saturation": {"pivot": 0.5}},
    {"field": "feats.t2", "log": {"scaling_factor": 1.5}, "boost": 3.0},
    {"field": "feats.t9", "sigmoid": {"pivot": 1.0, "exponent": 2.0}},
    {"field": "feats.never"},
    {"field": "missing"},
]


@pytest.mark.parametrize("i", range(len(RANK_FEATURE_BODIES)))
def test_rank_feature_matches_reference(readers, i):
    ref_reader, port_reader = readers[2]
    body = {"rank_feature": dict(RANK_FEATURE_BODIES[i])}
    if body["rank_feature"]["field"].startswith("feats"):
        # a doc holding a list of maps makes the reference's walk fail
        # on float(dict); the port raises the same error
        with pytest.raises(TypeError):
            ref_parse(body).execute(RefContext(ref_reader,
                                               RefMapperService(MAPPING)))
        with pytest.raises(TypeError):
            parse_query(body).execute(SearchContext(
                port_reader, MapperService(MAPPING)))
        return
    want = ref_parse(body).execute(RefContext(ref_reader,
                                              RefMapperService(MAPPING)))
    got = parse_query(body).execute(SearchContext(port_reader,
                                                  MapperService(MAPPING)))
    assert got.rows.tolist() == want.rows.tolist()
    assert got.scores.tobytes() == want.scores.tobytes()


@pytest.mark.parametrize("i", range(6, len(RANK_FEATURE_BODIES)))
def test_rank_feature_of_a_features_map_matches_reference(i):
    """`rank_features.<feature>` over maps only (no list of maps)."""
    mapping = {"properties": {"feats": {"type": "rank_features"}}}
    ref = RefEngine(tempfile.mkdtemp(), RefMapperService(mapping))
    port = Engine(MapperService(mapping))
    docs = [d for d in _docs(9, 300) if not isinstance(d.get("feats"), list)]
    docs = [{"feats": d["feats"]} if "feats" in d else {} for d in docs]
    for j, d in enumerate(docs[:150]):
        ref.index(str(j), d)
    port.index_many([str(j) for j in range(150)], docs[:150])
    ref.refresh(), port.refresh()
    for j, d in enumerate(docs[150:], start=150):
        ref.index(str(j), d)
    port.index_many([str(j) for j in range(150, len(docs))], docs[150:])
    ref.index("4", docs[0])
    port.index("4", docs[0])
    ref_r, port_r = ref.refresh(), port.refresh()
    body = {"rank_feature": dict(RANK_FEATURE_BODIES[i])}
    want = ref_parse(body).execute(RefContext(ref_r,
                                              RefMapperService(mapping)))
    got = parse_query(body).execute(SearchContext(port_r,
                                                  MapperService(mapping)))
    assert got.rows.tolist() == want.rows.tolist()
    assert got.scores.tobytes() == want.scores.tobytes()
    assert (len(got.rows) == 0) == (body["rank_feature"]["field"]
                                    in ("feats.never", "missing"))
