"""The port's aggregation engine on CPU tensors with the router off, held to
the reference's host path on the same documents: final JSON and the `$p`
partial states (HLL registers, t-digests, bucket lists) with `==`; the
`aggs.*` torch ops against numpy; the column store's delta refresh; and
the cost router's choices."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.search import agg_partials as ref_partials
from elasticsearch_tpu.search import aggregations as ref_aggs
from elasticsearch_tpu.search.queries import SearchContext as RefContext
from elasticsearch_tpu_torch.ops import aggs as ops
from elasticsearch_tpu_torch.search import agg_partials, aggregations
from elasticsearch_tpu_torch.search.agg_plan import AggEngine, CostRouter
from elasticsearch_tpu_torch.search.queries import SearchContext
from tests.test_torch_aggs import BODIES, DEVICE_BODIES, _load
from tests.torch_rest_pair import Pair


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("engine"), mp)
    pair.ref_node.settings["search.aggs.device_enabled"] = "false"
    _load(pair, "e", 2, 11, 240)
    yield pair
    pair.close()
    mp.undo()


def _contexts(pair, name):
    svc = pair.port_node.index(name)
    ctx = SearchContext(svc.combined_reader(), svc.mapper_service)
    ctx.index_name = name
    rsvc = pair.ref_node.indices.get(name)
    rctx = RefContext(rsvc.combined_reader(), rsvc.mapper_service)
    rctx.index_name = name
    return ctx, rctx, svc


def _rows(ctx, rctx, every: int):
    rows = ctx.all_rows()[::every]
    rrows = rctx.all_rows()[::every]
    assert np.array_equal(rows, rrows)
    return rows


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("case", sorted(DEVICE_BODIES - {
    "post_filter_scope", "no_match", "terms_min_doc_count_0"}))
def test_engine_matches_reference_host_path(loaded, case, every):
    """Final and partial mode over every row and every third row: the
    engine's answers equal the reference's `compute_aggs` and
    `compute_partial_aggs`, and at least one node ran on the device."""
    ctx, rctx, svc = _contexts(loaded, "e")
    rows = _rows(ctx, rctx, every)
    spec = BODIES[case].get("aggs") or BODIES[case]["aggregations"]
    engine = AggEngine(svc.mapper_service, "cpu")
    got, prof = engine.compute(ctx, rows, spec)
    assert got == ref_aggs.compute_aggs(rctx, rows, spec)
    assert engine.stats["device_nodes"] > 0, prof
    got, _ = engine.compute(ctx, rows, spec, partial=True)
    assert got == ref_partials.compute_partial_aggs(rctx, rows, spec)
    # and the port's own host walkers give the same states
    assert got == agg_partials.compute_partial_aggs(ctx, rows, spec)
    assert aggregations.compute_aggs(ctx, rows, spec) == \
        ref_aggs.compute_aggs(rctx, rows, spec)


def test_non_integral_sum_takes_host_path(loaded):
    ctx, rctx, svc = _contexts(loaded, "e")
    rows = ctx.all_rows()
    engine = AggEngine(svc.mapper_service, "cpu")
    spec = {"a": {"avg": {"field": "f"}}, "s": {"stats": {"field": "f"}},
            "h": {"histogram": {"field": "n", "interval": 10},
                  "aggs": {"x": {"sum": {"field": "f"}}}},
            "m": {"min": {"field": "f"}}, "n": {"sum": {"field": "n"}}}
    got, prof = engine.compute(ctx, rows, spec)
    assert got == ref_aggs.compute_aggs(rctx, rows, spec)
    engines = {n["name"]: (n["engine"], n.get("fallback_reason"))
               for n in prof["nodes"]}
    assert engines == {"a": ("host", "non_integral_sum"),
                       "s": ("host", "non_integral_sum"),
                       "h": ("host", "non_integral_sum"),
                       "m": ("device", None), "n": ("device", None)}
    assert engine.stats["fallback_reasons"]["non_integral_sum"]["count"] \
        == 3


def test_column_store_extracts_only_new_segments(loaded):
    pair = loaded
    pair.same("PUT", "/cs", {"mappings": {"properties": {
        "n": {"type": "integer"}, "tag": {"type": "keyword"}}}})
    svc = pair.port_node.index("cs")
    engine = AggEngine(svc.mapper_service, "cpu")
    spec = {"t": {"terms": {"field": "tag"},
                  "aggs": {"s": {"sum": {"field": "n"}}}}}
    for batch in range(3):
        ops_ = []
        for i in range(20):
            ops_ += [{"index": {"_id": f"{batch}-{i}"}},
                     {"n": i + batch, "tag": f"t{i % 3}"}]
        pair.same("POST", "/cs/_bulk", ops_, ndjson=True)
        pair.same("POST", "/cs/_refresh")
        before = dict(engine.store.stats)
        ctx = SearchContext(svc.combined_reader(), svc.mapper_service)
        got, _ = engine.compute(ctx, ctx.all_rows(), spec)
        assert got["t"]["buckets"][0]["doc_count"] == 7 * (batch + 1)
        # one new segment a refresh: two fields' blocks extracted
        assert engine.store.stats["blocks_extracted"] \
            - before["blocks_extracted"] == 2
        assert engine.store.stats["blocks_cached"] \
            - before["blocks_cached"] == 2 * batch
    pair.same("DELETE", "/cs")


# ------------------------------------------------------------------ ops

def _cols(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-50, 500, n).astype(np.float64)
    present = rng.random(n) > 0.1
    vals[~present] = np.nan
    mask = rng.random(n) > 0.3
    ords = np.where(present, rng.integers(0, 13, n), -1).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(vals=vals, present=present, mask=mask, ords=ords).items()}
    return vals, present, mask, ords, t


def _ref_boards(lanes, ok, v, n_lanes):
    cnt = np.bincount(lanes[ok], minlength=n_lanes)
    s = np.bincount(lanes[ok], weights=v[ok], minlength=n_lanes)
    mn = np.full(n_lanes, np.inf)
    mx = np.full(n_lanes, -np.inf)
    np.minimum.at(mn, lanes[ok], v[ok])
    np.maximum.at(mx, lanes[ok], v[ok])
    return cnt, s, mn, mx


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("missing", [None, 3.0])
def test_ord_and_hist_ops_match_numpy(missing):
    vals, present, mask, ords, t = _cols()
    lanes = np.where(ords >= 0, ords, 16)
    cnt = np.bincount(lanes[mask], minlength=17)
    np.testing.assert_array_equal(
        ops.ord_counts(t["ords"], t["mask"], 16).numpy(), cnt)
    v = np.where(present, vals, missing if missing is not None else 0.0)
    p = present | (missing is not None)
    _same(ops.ord_metric(t["ords"], t["mask"], missing, t["vals"],
                         t["present"], 16),
          _ref_boards(lanes, mask & p, v, 17))
    # histogram ids: floor((v - offset) / interval) - base, off-span trash
    hp = (25.0, 5.0, -2.0, 1.0, missing)
    kv = np.where(present, vals, missing if missing is not None else 0.0)
    ids = np.floor((kv - 5.0) / 25.0) + 2
    ok = p & (ids >= 0) & (ids < 32)
    hl = np.where(ok, ids, 32).astype(np.int64)
    np.testing.assert_array_equal(
        ops.hist_counts(t["vals"], t["present"], t["mask"], hp, 32).numpy(),
        np.bincount(hl[mask & ok], minlength=33))
    _same(ops.hist_metric(t["vals"], t["present"], t["mask"], hp, None,
                          t["vals"], t["present"], 32),
          _ref_boards(hl, mask & ok & present, vals, 33))


def test_range_cal_tree_hll_ops_match_numpy():
    vals, present, mask, ords, t = _cols(seed=1)
    bounds = np.asarray([[-np.inf, 100], [50, 300], [200, np.inf],
                         [np.inf, np.inf]])
    members = (vals[None, :] >= bounds[:, :1]) & (vals[None, :] < bounds[:, 1:]) \
        & (mask & present)[None, :]
    bt = torch.from_numpy(bounds)
    np.testing.assert_array_equal(
        ops.range_counts(t["vals"], t["present"], t["mask"], bt,
                         None).numpy(), members.sum(axis=1))
    got = ops.range_metric(t["vals"], t["present"], t["mask"], bt, None,
                           None, t["vals"], t["present"])
    np.testing.assert_array_equal(got[0].numpy(), members.sum(axis=1))
    np.testing.assert_array_equal(
        got[1].numpy(), np.where(members, vals[None, :], 0).sum(axis=1))
    # calendar ids: searchsorted over boundaries, +inf past the span
    cb = np.full(8, np.inf)
    cb[:5] = [-60, 0, 100, 250, 400]
    cal = np.searchsorted(cb, np.trunc(vals - 10.0), side="right") - 1
    ok = present & (cal >= 0) & (cal < 8)
    cl = np.where(ok, cal, 8)
    np.testing.assert_array_equal(
        ops.cal_counts(t["vals"], t["present"], t["mask"],
                       torch.from_numpy(cb), (1.0, 10.0), 8).numpy(),
        np.bincount(cl[mask & ok], minlength=9))
    # a two-level tree: ordinals (with a missing lane) x histogram
    hp = (100.0, 0.0, -1.0, 1.0, None)
    levels = [("ord", 16, (t["ords"], True)),
              ("hist", 8, (t["vals"], t["present"], hp))]
    o = np.where(ords >= 0, ords, 15)
    h = np.floor(np.where(present, vals, 0) / 100.0) + 1
    hok = present & (h >= 0) & (h < 8)
    cid = np.where(mask & hok, o * 8 + np.where(hok, h, 0), 128)
    cid = cid.astype(np.int64)
    np.testing.assert_array_equal(
        ops.tree_counts(t["mask"], levels).numpy(),
        np.bincount(cid[mask & hok], minlength=129))
    _same(ops.tree_metric(t["mask"], None, t["vals"], t["present"], levels),
          _ref_boards(cid, mask & hok & present, vals, 129))
    # HLL registers: the max rank of each (lane, register)
    rng = np.random.default_rng(2)
    hidx = rng.integers(0, ops.HLL_M, len(vals)).astype(np.int32)
    hrho = np.where(present, rng.integers(1, 20, len(vals)), 0) \
        .astype(np.int32)
    want = np.zeros((129, ops.HLL_M), dtype=np.int32)
    sel = mask & hok
    np.maximum.at(want, (cid[sel], hidx[sel]), hrho[sel])
    np.testing.assert_array_equal(
        ops.hll_board(t["mask"], torch.from_numpy(hidx),
                      torch.from_numpy(hrho), levels).numpy(), want)


def test_cost_router_prefers_host_on_small_sets_after_timings():
    r = CostRouter()
    # the priors: a large match takes the device, a tiny one the host
    assert r.decide("terms", 100_000, 1 << 17) == "device"
    assert r.decide("terms", 10, 1 << 20) == "host"
    r.observe_device("terms", 5_000_000)
    r.observe_host("terms", 10_000, 10)
    routes = [r.decide("terms", 10, 1 << 20)
              for _ in range(CostRouter.REPROBE - 1)]
    assert routes[:-1] == ["host"] * (CostRouter.REPROBE - 2)
    assert routes[-1] == "probe"
    assert r.decide("terms", 1_000_000, 1 << 20) == "device"
    assert r.snapshot()["decisions"] == {
        "device": 2, "probe": 1, "host": CostRouter.REPROBE - 1}
