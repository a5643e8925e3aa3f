"""The port's IVF engine (`elasticsearch_tpu_torch/ann/`, `ops/knn_ivf.py`,
`ops/ivf_fused.py`) and its int4 rung against the JAX package on the CPU.

Both packages are held to the same partitions: k-means draws differ
between `jax.random` and `torch.Generator`, so the reference trains, its
`export_layout` crosses over, and the port re-places the same rows into
the same centroids (`ivf_from_layout`); part rows, counts and the device
partitions' bytes must then be identical for f32, bf16, int8 and int4.

Tolerances (PR 1's parity rule): scores within 1e-5 at f32 precision and
2e-5 at bf16 (bf16 x bf16 products are exact in f32; only the order of
the f32 sum differs), scaled by |score| for l2; ids equal wherever the
reference's gap to its neighbours exceeds 1e-4. The fused kernels' plain
version is held to the reference's Pallas kernel in interpret mode, with
NEG_INF (-3e38) at exactly the same slots. The int4 codec and corpus are
byte-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ann import ivf_index as ref_ivf
from elasticsearch_tpu.ann.router import IVFRouter as RefRouter
from elasticsearch_tpu.ops import knn as ref_knn
from elasticsearch_tpu.ops import knn_ivf as ref_knn_ivf
from elasticsearch_tpu.ops import pallas_ivf_fused as ref_fused
from elasticsearch_tpu.quant import codec as ref_codec
from elasticsearch_tpu.quant import rescore as ref_rescore
from elasticsearch_tpu_torch.ann import ivf_index
from elasticsearch_tpu_torch.ann.router import IVFRouter
from elasticsearch_tpu_torch.ops import ivf_fused as fused
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.ops import knn_ivf
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.quant import codec
from elasticsearch_tpu_torch.quant import rescore

N, D, NLIST, Q, K = 1200, 32, 16, 8, 10
DTYPES = ["f32", "bf16", "int8", "int4"]
NEG = -3.0e38


def assert_topk_parity(got_s, got_i, want_s, want_i, atol, gap=1e-4):
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    scale = np.maximum(1.0, np.abs(want_s))
    pad = want_s <= -1e37
    np.testing.assert_array_equal(got_s <= -1e37, pad)
    assert np.all(np.abs(got_s - want_s)[~pad] <= atol * scale[~pad]), \
        np.abs(got_s - want_s)[~pad].max()
    padded = np.pad(want_s, ((0, 0), (1, 1)), constant_values=np.inf)
    padded[:, -1] = -np.inf
    gaps = np.minimum(padded[:, :-2] - padded[:, 1:-1],
                      padded[:, 1:-1] - padded[:, 2:])
    clear = gaps > gap * scale
    np.testing.assert_array_equal(got_i[clear], want_i[clear])


def _bytes(t) -> np.ndarray:
    """Raw bytes of a port tensor or a reference array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.contiguous().numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    # rows of norm ~6, as PR 1's parity data: l2's raw score cancels
    # terms of order |q|² + |v|², whose f32 rounding the tolerance scales
    # only by |score|
    centers = rng.standard_normal((24, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 24, N)]
            + 0.5 * rng.standard_normal((N, D)).astype(np.float32))
    queries = (vecs[rng.integers(0, N, Q)]
               + 0.3 * rng.standard_normal((Q, D)).astype(np.float32))
    return vecs.astype(np.float32), queries.astype(np.float32)


_LAYOUTS = {}


def layouts(data, dtype, metric=sim.COSINE):
    """(reference IVFIndex, port IVFIndex re-placed from its layout)."""
    key = (dtype, metric)
    if key not in _LAYOUTS:
        vecs, _ = data
        ref = ref_ivf.build_ivf_index(vecs, metric=metric, nlist=NLIST,
                                      dtype=dtype)
        port = ivf_index.ivf_from_layout(ref_ivf.export_layout(ref), vecs)
        _LAYOUTS[key] = (ref, port)
    return _LAYOUTS[key]


# ------------------------------------------------------------------ int4 rung

@pytest.mark.parametrize("shape", [(1, 2), (37, 16), (300, 96)])
def test_int4_encode_np_byte_identical(shape):
    rng = np.random.default_rng(shape[0])
    rows = rng.standard_normal(shape).astype(np.float32) * 5.0
    rows[0] = 0.0                       # the 1e-30 scale floor
    want = ref_codec.get("int4").encode_np(rows)
    got = codec.get("int4").encode_np(rows)
    np.testing.assert_array_equal(_bytes(got.data), _bytes(want.data))
    np.testing.assert_array_equal(_bytes(got.scales), _bytes(want.scales))
    with pytest.raises(ValueError, match="even dims"):
        codec.get("int4").encode_np(np.ones((2, 3), np.float32))


def test_int4_planes_and_blocked_dots_match_reference():
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 256, (3, 5, 8)).astype(np.uint8)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    lo, hi = codec.int4_planes(torch.from_numpy(packed))
    wlo, whi = ref_codec.int4_planes_jnp(jnp.asarray(packed))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    qe, qo = codec.split_query_planes(torch.from_numpy(q))
    wqe, wqo = ref_codec.split_query_planes_jnp(jnp.asarray(q))
    np.testing.assert_array_equal(qe.numpy(), np.asarray(wqe))
    np.testing.assert_array_equal(qo.numpy(), np.asarray(wqo))
    for dt, tdt, atol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2e-5)):
        want = np.asarray(ref_codec.int4_blocked_dots_jnp(
            jnp.asarray(q), jnp.asarray(packed), dt))
        got = codec.int4_blocked_dots(torch.from_numpy(q),
                                      torch.from_numpy(packed), tdt).numpy()
        np.testing.assert_allclose(got, want, atol=atol * np.abs(want).max())


@pytest.mark.parametrize("metric", [sim.COSINE, sim.DOT_PRODUCT, sim.L2_NORM])
def test_int4_corpus_bytes_and_flat_search_match_reference(data, metric):
    vecs, queries = data
    want = ref_knn.build_corpus(vecs, metric=metric, dtype="int4")
    got = knn.build_corpus(vecs, metric=metric, dtype="int4", device="cpu")
    assert got.matrix.dtype == torch.uint8 and got.num_valid == N
    for name in ("matrix", "scales", "sq_norms"):
        np.testing.assert_array_equal(_bytes(getattr(got, name)),
                                      _bytes(getattr(want, name)))
    norm = vecs if metric != sim.COSINE else \
        vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    enc = codec.get("int4").encode_np(norm)
    ref_enc = ref_knn.corpus_from_encoded(enc.data, enc.scales, vecs,
                                          metric=metric)
    port_enc = knn.corpus_from_encoded(enc.data, enc.scales, vecs,
                                       metric=metric, device="cpu")
    for name in ("matrix", "scales", "sq_norms"):
        np.testing.assert_array_equal(_bytes(getattr(port_enc, name)),
                                      _bytes(getattr(ref_enc, name)))
    np.testing.assert_array_equal(_bytes(port_enc.matrix), _bytes(got.matrix))
    s, i = knn.knn_search(torch.from_numpy(queries), got, K, metric=metric,
                          precision="f32")
    ws, wi = ref_knn.knn_search(jnp.asarray(queries), want, K, metric=metric,
                                precision="f32")
    assert_topk_parity(s.numpy(), i.numpy(), ws, wi, 1e-5)
    # at bf16 the reference's CPU backend refuses the plane matmul
    # (BF16 x BF16 = F32 dot; ROADMAP.md §3), so the serving route is held
    # to the same arithmetic in float64: bf16 query planes x int4 levels,
    # de-scaled. int4 stays off the binned kernel route, as in the
    # reference.
    s, i = knn.knn_search_auto(torch.from_numpy(queries), got, K,
                               metric=metric)
    q = knn._prep_queries(torch.from_numpy(queries), metric)
    qb = q.to(torch.bfloat16).double().numpy()
    lo, hi = codec.int4_planes(got.matrix)
    dots = (qb[:, 0::2] @ lo.double().numpy().T
            + qb[:, 1::2] @ hi.double().numpy().T) \
        * got.scales.double().numpy()[None, :]
    if metric == sim.L2_NORM:
        dots = (2 * dots - (q.double().numpy() ** 2).sum(1)[:, None]
                - got.sq_norms.double().numpy()[None, :])
    dots[:, N:] = -np.inf
    order = np.argsort(-dots, axis=1, kind="stable")[:, :K]
    assert_topk_parity(s.numpy(), i.numpy(),
                       np.take_along_axis(dots, order, 1), order, 2e-5)


def test_rescore_matches_reference(data):
    vecs, queries = data
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, N, (Q, 40))
    coarse = rng.standard_normal((Q, 40)).astype(np.float32)
    coarse[ids < 0] = NEG
    for metric in (sim.COSINE, sim.DOT_PRODUCT, sim.L2_NORM):
        want = ref_rescore.rescore_boards(queries, coarse, ids, K,
                                          lambda r: vecs[r], metric)
        got = rescore.rescore_boards(queries, coarse, ids, K,
                                     lambda r: vecs[r], metric)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2]
    for k, over, lim in ((10, 4, None), (10, 4, 25), (0, 1, None), (3, 0, 9)):
        assert rescore.coarse_window(k, over, lim) == \
            ref_rescore.coarse_window(k, over, lim)
    assert rescore.DEFAULT_OVERSAMPLE["int4"] == \
        ref_rescore.DEFAULT_OVERSAMPLE["int4"]


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("dtype", DTYPES)
def test_layout_from_reference_export_is_byte_identical(data, dtype):
    ref, port = layouts(data, dtype)
    np.testing.assert_array_equal(port.part_rows, ref.part_rows)
    np.testing.assert_array_equal(port.counts, ref.counts)
    np.testing.assert_array_equal(port.part_vecs, ref.part_vecs)
    assert (port.nlist, port.cap, port.trained_on) == \
        (ref.nlist, ref.cap, ref.trained_on)
    got, want = port.device_partitions("cpu"), ref.device_partitions()
    for name in knn_ivf.IVFPartitions._fields:
        np.testing.assert_array_equal(_bytes(getattr(got, name)),
                                      _bytes(getattr(want, name)), name)
    # the reference's partitions carried over as numpy: the same bytes
    carried = knn_ivf.ivf_partitions_from_numpy(
        {f: np.asarray(getattr(want, f)) for f in want._fields}, "cpu")
    for name in knn_ivf.IVFPartitions._fields:
        np.testing.assert_array_equal(_bytes(getattr(carried, name)),
                                      _bytes(getattr(got, name)), name)
    # padding slots carry scale 0, so every scorer masks them
    assert (got.part_scales[got.part_rows < 0] == 0).all()


def test_layout_l2_add_clone_and_compatibility(data):
    vecs, _ = data
    ref, port = layouts(data, "f32", sim.L2_NORM)
    np.testing.assert_array_equal(port.part_rows, ref.part_rows)
    layout = ivf_index.export_layout(port)
    want = ref_ivf.export_layout(ref)
    assert layout.keys() == want.keys()
    np.testing.assert_array_equal(layout["centroids"], want["centroids"])
    for n, ok in ((N, True), (port.nlist * port.cap + 1, False),
                  (2 * N + 1, False)):
        assert ivf_index.layout_compatible(layout, n, D, sim.L2_NORM,
                                           "f32") is ok
    assert not ivf_index.layout_compatible(layout, N, D, sim.COSINE, "f32")
    assert not ivf_index.layout_compatible({}, N, D, sim.L2_NORM, "f32")
    # incremental add: the same displacement accounting as the reference
    a, b = port.clone(), ref.clone()
    extra = vecs[:300] * 1.5
    rows = np.arange(N, N + 300)
    a.add(extra, rows)
    b.add(extra, rows)
    np.testing.assert_array_equal(a.part_rows, b.part_rows)
    assert (a.displaced, a.spilled, a.needs_retrain) == \
        (b.displaced, b.spilled, b.needs_retrain)
    assert port.total == N          # the clone's add left the source alone
    assert ivf_index.pick_nlist(1_000_000, 960) == \
        ref_ivf.pick_nlist(1_000_000, 960) == 1024


# ------------------------------------------------------------- route, score

def _prepped(queries, metric):
    return (knn_ivf._prep_queries(torch.from_numpy(queries), metric),
            ref_knn_ivf._prep_queries(jnp.asarray(queries), metric))


@pytest.mark.parametrize("metric", [sim.COSINE, sim.L2_NORM])
def test_route_matches_reference(data, metric):
    _, queries = data
    ref, port = layouts(data, "f32", metric)
    q, rq = _prepped(queries, metric)
    ids, vals = knn_ivf.route(q, port.device_partitions("cpu"), 4,
                              metric=metric)
    wids, wvals = ref_knn_ivf.route(rq, ref.device_partitions(), 4,
                                    metric=metric)
    assert ids.dtype == torch.int32
    assert_topk_parity(vals.numpy(), ids.numpy(), wvals, wids, 1e-5)
    with pytest.raises(ValueError, match="power of two"):
        knn_ivf.route(q, port.device_partitions("cpu"), 3, metric=metric)


@pytest.mark.parametrize("dtype,metric,precision", [
    ("f32", sim.COSINE, "f32"), ("f32", sim.COSINE, "bf16"),
    ("bf16", sim.DOT_PRODUCT, "bf16"), ("int8", sim.COSINE, "bf16"),
    ("int4", sim.COSINE, "bf16"), ("f32", sim.L2_NORM, "bf16"),
    ("int8", sim.L2_NORM, "bf16"), ("int4", sim.L2_NORM, "bf16"),
    ("bf16", sim.L2_NORM, "f32")])
def test_score_probes_matches_reference(data, dtype, metric, precision):
    _, queries = data
    ref, port = layouts(data, dtype, metric)
    parts, rparts = port.device_partitions("cpu"), ref.device_partitions()
    q, rq = _prepped(queries, metric)
    wids, _ = ref_knn_ivf.route(rq, rparts, 4, metric=metric)
    probe = torch.from_numpy(np.array(wids))
    s, r = knn_ivf.score_probes(q, parts, probe, K, metric=metric,
                                precision=precision)
    ws, wr = ref_knn_ivf.score_probes(rq, rparts, wids, K, metric=metric,
                                      precision=precision)
    assert r.dtype == torch.int32
    assert_topk_parity(s.numpy(), r.numpy(), ws, wr,
                       1e-5 if precision == "f32" else 2e-5)
    # the convenience entry routes and scores in one call
    s2, r2 = knn_ivf.ivf_search(torch.from_numpy(queries), parts, K, 4,
                                metric=metric, precision=precision)
    assert torch.equal(r2, r)


# ------------------------------------------------------------- fused route

@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_board_plain_version_matches_interpret_kernel(data, dtype):
    _, queries = data
    ref, port = layouts(data, dtype)
    parts, rparts = port.device_partitions("cpu"), ref.device_partitions()
    q, rq = _prepped(queries, sim.COSINE)
    wids, _ = ref_knn_ivf.route(rq, rparts, 4, metric=sim.COSINE)
    probe = torch.from_numpy(np.array(wids))
    want = np.asarray(ref_fused._fused_probe_board(rq, rparts, wids,
                                                   interpret=True))
    got = fused.probe_board(q, parts, probe).numpy()
    assert got.shape == want.shape == (Q, 4, port.cap)
    neg = want <= -1e37
    assert neg.any() and (want[neg] == NEG).all()
    np.testing.assert_array_equal(got <= -1e37, neg)
    assert (got[neg] == NEG).all()
    np.testing.assert_allclose(got[~neg], want[~neg],
                               atol=2e-5 * np.abs(want[~neg]).max())
    s, r = fused.fused_probe_scores(q, parts, probe, K)
    ws, wr = ref_fused.fused_probe_scores(rq, rparts, wids, K,
                                          interpret=True)
    assert_topk_parity(s.numpy(), r.numpy(), ws, wr, 2e-5)
    # the fused and the scan route give the same rows, as the reference's
    # own parity test pins for its two routes
    s2, r2 = knn_ivf.score_probes(q, parts, probe, K)
    assert torch.equal(r, r2)
    np.testing.assert_allclose(s.numpy(), s2.numpy(), atol=2e-5)


def test_fused_masks_padding_even_when_probes_are_mostly_padding(data):
    """k deeper than the probed valid rows: the tail comes back as
    NEG_INF / -1, never a padding slot's row."""
    _, queries = data
    _, port = layouts(data, "int8")
    parts = port.device_partitions("cpu")
    q = knn_ivf._prep_queries(torch.from_numpy(queries), sim.COSINE)
    probe, _ = knn_ivf.route(q, parts, 1)
    k = port.cap
    s, r = fused.fused_probe_scores(q, parts, probe, k)
    valid = (parts.part_rows[probe[:, 0].long()] >= 0).sum(1)
    for qi in range(Q):
        n = int(valid[qi])
        assert (r[qi, :n] >= 0).all() and (r[qi, n:] == -1).all()
        assert (s[qi, n:] == NEG).all()


def test_fused_eligibility():
    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
        assert fused.fused_eligible(dt, sim.COSINE)
        assert fused.fused_eligible(dt, sim.DOT_PRODUCT)
        assert not fused.fused_eligible(dt, sim.L2_NORM)
        assert not fused.fused_eligible(dt, sim.COSINE, precision="f32")
    assert not fused.fused_eligible(torch.int32, sim.COSINE)


# ------------------------------------------------------------------ router

def _routers(data, dtype, nprobe, metric=sim.COSINE):
    ref, port = layouts(data, dtype, metric)
    return (RefRouter(ref.clone(), nprobe=nprobe),
            IVFRouter(port.clone(), nprobe=nprobe, device="cpu"))


@pytest.mark.parametrize("dtype", ["bf16", "int4"])
def test_router_tuned_nprobe_and_search_match_reference(data, dtype):
    _, queries = data
    rr, pr = _routers(data, dtype, "auto")
    assert pr.effective_nprobe(K) == rr.effective_nprobe(K)
    ws, wr, wph = rr.search(queries, K)
    s, r, ph = pr.search(queries, K)
    assert ph["nprobe"] == wph["nprobe"]
    assert ph["fused_probe"] and ph["engine"] == "tpu_ivf"
    assert ph["scored_rows"] == wph["scored_rows"]
    assert all(ph[f] >= 0 for f in ("route_nanos", "score_nanos",
                                     "merge_nanos"))
    assert_topk_parity(s, r, ws, wr, 2e-5)


def test_router_fixed_nprobe_snaps_up_the_pow2_ladder(data):
    for setting, want in ((3, 4), (4, 4), (5, 8), (100, NLIST), (0, 1)):
        rr, pr = _routers(data, "f32", setting)
        assert pr.effective_nprobe(K) == rr.effective_nprobe(K) == want


def test_router_num_candidates_widens_like_reference(data):
    _, queries = data
    rr, pr = _routers(data, "bf16", 2)
    cap = pr.index.cap
    for nc in (None, 10, cap + 1, 3 * cap, 5 * cap, 100 * cap):
        ws, wr, wph = rr.search(queries, K, num_candidates=nc)
        s, r, ph = pr.search(queries, K, num_candidates=nc)
        assert ph["nprobe"] == wph["nprobe"], nc
        assert_topk_parity(s, r, ws, wr, 2e-5)
    assert ph["nprobe"] == NLIST
    _, _, ph = pr.search(queries, K, num_candidates=3 * cap)
    assert ph["nprobe"] == 4


def test_router_l2_takes_the_scan_route(data):
    _, queries = data
    rr, pr = _routers(data, "f32", 4, metric=sim.L2_NORM)
    ws, wr, _ = rr.search(queries, K)
    s, r, ph = pr.search(queries, K)
    assert not ph["fused_probe"]
    assert_topk_parity(s, r, ws, wr, 2e-5)


def test_router_k_beyond_probed_rows_pads_back(data):
    _, queries = data
    rr, pr = _routers(data, "f32", 1)
    k = pr.index.cap + 5
    ws, wr, _ = rr.search(queries, k)
    s, r, _ = pr.search(queries, k)
    assert s.shape == (Q, k) and (r[:, -5:] == -1).all()
    assert np.isneginf(s[:, -5:]).all()
    np.testing.assert_array_equal(r[:, -5:], np.asarray(wr)[:, -5:])


def test_router_fallback_reasons_match_reference(data):
    vecs, _ = data
    rr, pr = _routers(data, "f32", 4)
    cap = pr.index.cap
    for args in ((K, True, "bf16"), (K, False, "f32"), (cap + 1, False,
                                                         "bf16"),
                 (K, False, "bf16")):
        assert pr.should_fallback(*args) == rr.should_fallback(*args)
    assert pr.should_fallback(K, True, "bf16") == "filtered"
    assert pr.should_fallback(K, False, "f32") == "f32_precision"
    assert pr.should_fallback(cap + 1, False, "bf16") == "k_exceeds_partition"
    assert pr.should_fallback(K, False, "bf16") is None
    # drift: adds that miss their first choice past the retrain threshold
    far = np.repeat(vecs[:1], 600, axis=0)
    for router in (rr, pr):
        router.index.add(far, np.arange(N, N + 600))
    assert pr.index.needs_retrain and rr.index.needs_retrain
    assert pr.should_fallback(K, False, "bf16") == "needs_retrain" == \
        rr.should_fallback(K, False, "bf16")
    empty = ivf_index.IVFIndex(np.eye(4, D, dtype=np.float32), 8,
                               sim.COSINE, "f32")
    assert IVFRouter(empty, device="cpu").should_fallback(
        K, False, "bf16") == "empty"
