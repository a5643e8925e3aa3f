"""The port's BM25 lexical engine (`ops/bm25.py`, `native/`) against the
reference's on the CPU: the same seeded documents (Zipf-drawn words, two
segments, updates that tombstone rows) go through both packages' engines;
the impact tile layouts must be byte-identical, and the port's board
(its plain PyTorch version on CPU tensors) and host twin must give the
rows and f32 score bits of the reference's device and host routes, for
f32, bf16 and int8 impacts."""

import tempfile

import numpy as np
import pytest
import torch

from elasticsearch_tpu import native as ref_native
from elasticsearch_tpu.index.engine import Engine as RefEngine
from elasticsearch_tpu.index.mapping import MapperService as RefMapperService
from elasticsearch_tpu.ops.bm25 import LexicalField as RefLexicalField
from elasticsearch_tpu.search.queries import resolve_msm
from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.ops import bm25, dispatch

MAPPING = {"properties": {"body": {"type": "text"},
                          "tag": {"type": "keyword"}}}
VOCAB = 300


def _docs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        words = [f"w{r}" for r in rng.choice(VOCAB, int(rng.integers(0, 40)),
                                             p=p)]
        doc = {"body": " ".join(words), "tag": f"t{i % 3}"}
        if i % 17 == 0:
            doc["body"] = [doc["body"], "W1 w2, w3!"]    # multi-valued
        if i % 23 == 5:
            del doc["body"]
        docs.append(doc)
    return docs


class Pair:
    """One engine a package over the same writes."""

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
    """Three reader snapshots: one segment; an append-only second
    segment; then updates that tombstone rows of both segments."""
    docs = _docs(3, 900)
    pair = Pair()
    pair.index([str(i) for i in range(500)], docs[:500])
    snaps = [pair.refresh()]
    pair.index([str(i) for i in range(500, 900)], docs[500:])
    snaps.append(pair.refresh())
    pair.index(["3", "40", "610"], [docs[7], docs[8], docs[9]])
    snaps.append(pair.refresh())
    return snaps


def _fields(dtype, reader_pair):
    ref = RefLexicalField("body", dtype)
    port = bm25.LexicalField("body", dtype, device="cpu")
    ref.sync(reader_pair[0])
    port.sync(reader_pair[1])
    return ref, port


def _same(a, b):
    for (ra, sa), (rb, sb) in zip(a, b, strict=True):
        assert np.array_equal(ra, rb)
        assert np.array_equal(sa.view(np.int32), sb.view(np.int32))


QUERIES = [
    (["w1", "w5", "w1"], 1.0),               # a repeated word
    (["w3", "oov", "w40"], 2.5),             # an out-of-vocabulary word
    (["oov"], 1.0),                          # nothing in the vocabulary
    (["w0", "w2", "w7", "w11", "w100"], 0.5),
    (["w250"], 1.0),
    (["w1", "w2"], 1.0),
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


@pytest.mark.parametrize("window", [5, 50, 1000])
@pytest.mark.parametrize("snap", [0, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_board_and_host_routes_match_reference(readers, snap, dtype, window):
    """Rows and f32 bits: the port's board against the reference's device
    route (the quantized impacts), the port's host twin against the
    reference's host route (the f32 impacts); at f32 all four agree.
    Required matches: 1, `operator: and` and minimum_should_match."""
    ref, port = _fields(dtype, readers[snap])
    for required in (None,
                     [len(t) for t, _ in QUERIES],
                     [resolve_msm("60%", len(t)) for t, _ in QUERIES],
                     [2, 2, 1, 3, 1, 2]):
        board = port.search_batch(QUERIES, window, required=required)
        _same(board, ref.search_batch(QUERIES, window, required=required,
                                      route="device"))
        host = port.search_batch(QUERIES, window, required=required,
                                 route="host")
        _same(host, ref.search_batch(QUERIES, window, required=required,
                                     route="host"))
        if dtype == "f32":
            _same(board, host)
        assert all(len(rows) <= window for rows, _ in board)
    assert len(board[2][0]) == 0


def test_append_only_refresh_extracts_only_new_segments(readers):
    port = bm25.LexicalField("body", device="cpu")
    assert port.sync(readers[0][1])
    assert port.columnar_refresh["mode"] == "full"
    assert port.sync(readers[1][1])
    assert port.columnar_refresh == {"blocks": 2, "cached": 1,
                                     "extracted": 1, "mode": "delta"}
    assert not port.sync(readers[1][1])
    # the updates add a third segment and tombstone rows of both others
    assert port.sync(readers[2][1])
    assert port.columnar_refresh == {"blocks": 3, "cached": 0,
                                     "extracted": 3, "mode": "full"}
    ref = RefLexicalField("body")
    ref.sync(readers[2][0])
    assert port.tile_impacts.tobytes() == ref.tile_impacts.tobytes()


def test_plan_positions_holds_the_plan_queries_tiles(readers):
    """The board's term-position plan names the host twin's tiles: each
    query's j-th in-vocabulary word's tiles at position j."""
    _ref, port = _fields("f32", readers[2])
    tile_ids, boosts, _m = port.plan_queries(QUERIES)
    items, starts = port.plan_positions(QUERIES)
    assert starts[0] == 0 and starts[-1] == items.shape[1]
    for qi in range(len(QUERIES)):
        mine = items[:, items[0] == qi]
        want = tile_ids[qi][tile_ids[qi] >= 0]
        assert mine[1].tolist() == want.tolist()
        assert np.array_equal(mine[2].view(np.float32),
                              boosts[qi][:len(want)])
    # a query's tiles of one word share a position; words ascend
    for j in range(len(starts) - 1):
        q = items[0, starts[j]:starts[j + 1]]
        assert (np.diff(q) >= 0).all()


def test_board_counts_one_launch_set_only_on_cuda(readers):
    """On CPU tensors the wrapper runs the plain version and counts
    nothing; a launch counts only where the kernel launches."""
    _ref, port = _fields("f32", readers[2])
    dispatch.reset_launches()
    port.search_batch(QUERIES, 10)
    assert dispatch.launches().get(bm25.KERNEL, 0) == 0


def test_native_hot_loops_are_the_reference_bits():
    rng = np.random.default_rng(5)
    freqs = rng.integers(1, 30, 5000).astype(np.int32)
    lengths = rng.integers(0, 400, 5000).astype(np.float32)
    for idf, avg, boost in ((0.1, 37.5, 1.0), (7.25, 1.0, 2.5),
                            (3.3, 0.0, 0.7)):
        a = native.bm25_score(freqs, lengths, idf, avg, 1.2, 0.75, boost)
        b = ref_native.bm25_score(freqs, lengths, idf, avg, 1.2, 0.75, boost)
        assert a.view(np.int32).tolist() == b.view(np.int32).tolist()
    scores = rng.integers(0, 50, 4000).astype(np.float32) / 4
    scores[::7] = -np.inf
    for k in (0, 1, 10, 100, 4000, 5000):
        assert native.topk(scores, k).tolist() \
            == ref_native.topk(scores, k).tolist()
    a = np.unique(rng.integers(0, 10_000, 3000)).astype(np.int64)
    b = np.unique(rng.integers(0, 10_000, 200)).astype(np.int64)
    for x, y in ((a, b), (b, a), (a, a[:0])):
        for got, want in zip(native.intersect_sorted(x, y),
                             ref_native.intersect_sorted(x, y)):
            assert got.tolist() == want.tolist()
        sx = rng.random(len(x)).astype(np.float32)
        sy = rng.random(len(y)).astype(np.float32)
        for sa, sb in ((sx, sy), (None, sy), (sx, None)):
            got = native.union_sum(x, sa, y, sb)
            want = ref_native.union_sum(x, sa, y, sb)
            assert got[0].tolist() == want[0].tolist()
            assert got[1].view(np.int32).tolist() \
                == want[1].view(np.int32).tolist()
    assert native.AVAILABLE
