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
    """The board's plan, one entry a (query, term position), names the host
    twin's tiles: query q's entries are its in-vocabulary words in query
    order (a repeated word each time), and their tile runs, expanded, are
    its `plan_queries` tiles with their boosts."""
    _ref, port = _fields("f32", readers[2])
    tile_ids, boosts, _m = port.plan_queries(QUERIES)
    pos_starts, runs = port.plan_positions(QUERIES)
    assert pos_starts.dtype == runs.dtype == np.int32
    assert pos_starts[0] == 0 and pos_starts[-1] == runs.shape[1]
    for qi, (words, _boost) in enumerate(QUERIES):
        mine = runs[:, pos_starts[qi]:pos_starts[qi + 1]]
        assert [tuple(e) for e in mine[:2].T.tolist()] == [
            port.term_tiles[w] for w in words if w in port.term_tiles]
        want = tile_ids[qi][tile_ids[qi] >= 0]
        assert [t for f, n in mine[:2].T.tolist()
                for t in range(f, f + n)] == want.tolist()
        assert np.array_equal(np.repeat(mine[2].view(np.float32), mine[1]),
                              boosts[qi][:len(want)])


@pytest.mark.parametrize("snap", [0, 1, 2])
def test_tile_first_is_lane_0_and_ascends_in_each_run(readers, snap):
    """`tile_first` is each tile's lane 0, valid in every run's tile and
    strictly ascending within a run, the order the kernel's window search
    needs; it goes to the card with the tiles."""
    _ref, port = _fields("f32", readers[snap])
    assert np.array_equal(port.tile_first, port.tile_slots[:, 0])
    assert np.array_equal(port._device_tile_first().numpy(), port.tile_first)
    for first, nt in port.term_tiles.values():
        run = port.tile_first[first:first + nt]
        assert (run >= 0).all() and (np.diff(run) > 0).all()


def _board_args(field, queries, required):
    """`bm25_board`'s arguments up to k for a batch, on the CPU."""
    pos_starts, runs = field.plan_positions(queries)
    return (torch.from_numpy(pos_starts), torch.from_numpy(runs),
            torch.from_numpy(np.asarray(required, dtype=np.int32)),
            field._device_tile_first(), *field._device_arrays())


def _same_window(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("range_slots", [32, 96, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_ranged_plain_version_is_the_plain_version(readers, dtype,
                                                   range_slots):
    """The kernels' decomposition in plain PyTorch (ranges of
    `range_slots`, each term's tile window in a range from `tile_first`,
    a range's top k', the merge) gives the plain version's window, score
    bits and slots, -inf / -1 past the matches: terms span several
    ranges, and k runs past one range, to every slot."""
    _ref, port = _fields(dtype, readers[2])
    n = port.n_slots
    assert n > 3 * range_slots
    for required in ([1] * len(QUERIES), [2, 2, 1, 3, 1, 2]):
        args = _board_args(port, QUERIES, required)
        for k in (7, range_slots + 5, n):
            want = bm25.bm25_board_reference(*args, k, n)
            assert want[1].dtype == torch.int32 and want[0].shape == (6, k)
            _same_window(bm25.bm25_board_ranged_reference(
                *args, k, n, range_slots=range_slots), want)
            assert bool((want[1] == -1).eq(want[0] == -np.inf).all())


def test_range_windows_hold_every_posting_in_range(readers):
    """Each entry's window holds every posting of its term whose slot lies
    in the range, and no tile past the range's end."""
    _ref, port = _fields("f32", readers[2])
    _ps, runs = port.plan_positions(QUERIES)
    for lo, hi in ((0, 64), (64, 200), (300, 301), (0, port.n_slots),
                   (port.n_slots - 40, port.n_slots)):
        start, count = bm25.range_windows(port.tile_first, runs, lo, hi)
        for j in range(runs.shape[1]):
            first, nt = runs[0, j], runs[1, j]
            slots = port.tile_slots[first:first + nt]
            tile = np.nonzero(((slots >= lo) & (slots < hi)).any(1))[0]
            win = np.arange(start[j], start[j] + count[j]) - first
            assert set(tile.tolist()) <= set(win.tolist())
            assert (port.tile_first[start[j]:start[j] + count[j]] < hi).all()


def test_launch_plan_fills_the_sms_and_bounds_the_ranges():
    """R halves from 8,192 until Q * ceil(n_slots / R) fills the card's
    SMs (132 on the H100 SXM, 114 on the PCIe card), not below 1,024 nor
    past the field; k' = min(k, R); the merge sorts in global scratch
    only past 16,384 keys; without `range_slots` the SM count is
    required."""
    p = bm25.launch_plan(32, 1 << 20, 100, sms=132)
    assert (p.range_slots, p.n_ranges, p.k_range, p.n_cand) \
        == (8192, 128, 100, 12800)
    assert p.sort_in_smem and p.sort_n == 128
    p = bm25.launch_plan(1, 1 << 20, 100, sms=132)
    assert (p.range_slots, p.n_ranges) == (4096, 256)
    assert bm25.launch_plan(1, 1 << 20, 100, sms=114).range_slots == 8192
    assert bm25.launch_plan(1, 1 << 20, 100, sms=200).range_slots == 4096
    assert bm25.launch_plan(1, 1 << 20, 16384, sms=132).sort_in_smem
    assert bm25.launch_plan(1, 3000, 10, sms=132).range_slots == 1024
    assert bm25.launch_plan(1, 100, 10, sms=132).range_slots == 128
    p = bm25.launch_plan(4, 5000, 20000, range_slots=64)
    assert (p.n_ranges, p.k_range, p.sort_n, p.sort_in_smem) \
        == (79, 64, 32768, False)
    for bad in (16, 100, 1 << 15):
        with pytest.raises(ValueError, match="range_slots"):
            bm25.launch_plan(1, 5000, 10, range_slots=bad)
    for sms in (None, 0):
        with pytest.raises(ValueError, match="SM count"):
            bm25.launch_plan(1, 5000, 10, sms=sms)


def test_kernel_smem_fits_the_card_at_every_plan():
    """The kernels' shared memory as the C entry sizes it: kernel A's
    boards (8 B a slot) grow with R, kernel B's sort buffer with k until
    it moves to global scratch; both stay within the H100's 227 KB a
    block."""
    a, b = bm25.kernel_smem(bm25.launch_plan(32, 1 << 20, 100, sms=132))
    assert (a, b) == (1152 + 8 * 8192 + 12 * 512,
                      1152 + 4 * 4096 + 8 * 2048 + 8 * 128)
    for k in (1, 100, 16384, 16385, 1 << 20):
        for r in (32, 8192, bm25.RANGE_MAX):
            a, b = bm25.kernel_smem(bm25.launch_plan(1, 1 << 20, k,
                                                     range_slots=r))
            assert max(a, b) <= 232448


@pytest.mark.parametrize("bad", ["not_from_0", "descends", "short",
                                 "past_the_tiles", "negative"])
def test_check_plan_refuses_out_of_bounds_plans(readers, bad):
    """A plan the kernels would read out of bounds is refused on the host
    (before its upload) and by the CPU wrapper; the field's own plans
    pass."""
    _ref, port = _fields("f32", readers[2])
    n_tiles = len(port.tile_slots)
    pos_starts, runs = port.plan_positions(QUERIES)
    bm25.check_plan(pos_starts, runs, n_tiles)
    pos_starts, runs = pos_starts.copy(), runs.copy()
    if bad == "not_from_0":
        pos_starts[0] = 1
    elif bad == "descends":
        pos_starts[2], pos_starts[3] = pos_starts[3], pos_starts[2] - 1
    elif bad == "short":
        pos_starts[-1] -= 1
    elif bad == "past_the_tiles":
        runs[1, -1] = n_tiles - runs[0, -1] + 1
    else:
        runs[0, 0] = -1
    with pytest.raises(ValueError):
        bm25.check_plan(pos_starts, runs, n_tiles)
    with pytest.raises(ValueError):
        bm25.bm25_board(torch.from_numpy(pos_starts), torch.from_numpy(runs),
                        torch.ones(len(QUERIES), dtype=torch.int32),
                        port._device_tile_first(), *port._device_arrays(),
                        10, port.n_slots)


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_window_zero_is_empty_as_in_the_reference(readers, dtype, route):
    """`rank_window_size: 0` gives every query an empty window on both
    routes, as the reference's do; the board is not called."""
    ref, port = _fields(dtype, readers[2])
    want = ref.search_batch(QUERIES, 0, route=route)
    assert all(len(rows) == 0 for rows, _ in want)
    got = port.search_batch(QUERIES, 0, route=route)
    assert len(got) == len(QUERIES)
    _same(got, want)
    for rows, scores in got:
        assert rows.dtype == np.int64 and scores.dtype == np.float32


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_ranged_board_route_matches_reference(readers, dtype, monkeypatch):
    """The board route through the ranged plain version at ranges of 64
    slots, windows past one range and `operator: and`, against the
    reference's `bm25.topk` program on the CPU: the same rows and f32
    bits."""
    ref, port = _fields(dtype, readers[2])
    monkeypatch.setattr(bm25, "bm25_board", lambda *a, variant=None: (
        bm25.bm25_board_ranged_reference(*a, range_slots=64)))
    for required in (None, [len(t) for t, _ in QUERIES], [2, 2, 1, 3, 1, 2]):
        for window in (10, 150, 1000):
            _same(port.search_batch(QUERIES, window, required=required),
                  ref.search_batch(QUERIES, window, required=required,
                                   route="device"))


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
