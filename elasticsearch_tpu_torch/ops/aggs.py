"""Aggregation boards on the card: the column store and the single-device
`aggs.*` programs as torch ops (port of `elasticsearch_tpu/ops/aggs.py`).

Store. Each aggregated field becomes an `AggColumn` over the reader's
live rows, padded to a power of two (`StoreSnapshot.r_pad`) so a
refreshed column's rows line up with the mask: an f64 value column and a
presence mask (the `numeric_values` view), int32 global ordinals for
`terms` (over the raw values, in first-occurrence order), and for
`cardinality` the per-row HLL register index and rank. Each segment's
extraction is cached by its `columnar.blocks.fingerprint`, so an
append-only refresh re-extracts only the new segments; the store resyncs
lazily, at the first aggregation after a refresh. A column uploads to
one explicit device on first use (`AggColumn.device_arrays`).

Ops. One call reduces the matched rows (a bool mask over the padded rows)
into boards of `n_buckets + 1` lanes: counts in int64 and sums in f64
through `scatter_add_`, minima and maxima through `scatter_reduce_`
(`amin` / `amax`, seeded with +inf / -inf). The last lane is the trash:
pad rows, rows off the span, and for `terms` the rows missing the key
(the `missing` bucket). Bucket ids come from the resident key column:
ordinals (`ord_*`), an affine floor (`hist_*`), the range bounds
(`range_*`), a `searchsorted` over the calendar boundaries (`cal_*`), a
composite id over up to TREE_MAX_DEPTH levels (`tree_*`); `hll_board`
is a scatter-max of each row's rank into its register. On CUDA an f64
`scatter_add_` is an unordered atomic, so a sum equals numpy's only on
integral columns whose sum of |values| stays under 2^53
(`AggColumn.integral_exact`): `search/agg_plan.py` routes sum-bearing
metrics on any other column to the host path. Counts, minima and maxima
are exact in any order.

Each op counts one launch a call on a CUDA tensor (`dispatch.LAUNCHES`,
`aggs.<op>`); on the CPU the same ops run on CPU tensors and count
nothing. The row-sharded `aggs.mesh_*` twins wait for the multi-device
path. Board sizes round up AGG_B_LADDER: eager PyTorch pays only the
board's memory, so the ladder runs to 2^20 lanes (the JAX package's stops
at 65,536, its compiled programs' limit), and a composite tree to 2^24.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.columnar.blocks import extract_values_block
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.search.agg_partials import (
    HLL_M, hll_hash, hll_register,
)

AGG_B_LADDER = tuple(1 << p for p in range(3, 21))
# calendar boundaries are walked on the host, a few floors a bucket
CAL_MAX_BUCKETS = 65536
# sums of integer-valued f64 are exact in any order while |sum| < 2^53
_EXACT_INT = float(1 << 53)
TREE_MAX_DEPTH = 3
TREE_MAX_LANES = 1 << 24
HLL_MAX_LANES = 1024

_INF = float("inf")


def bucket_count(n: int) -> Optional[int]:
    """A bucket count rounded up AGG_B_LADDER; None past its top (the
    caller takes the host path)."""
    n = max(int(n), 1)
    for b in AGG_B_LADDER:
        if b >= n:
            return b
    return None


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        dispatch.count_launch("aggs." + name,
                              bucket="x".join(map(str, t.shape)))


# ------------------------------------------------------------------- ops

def _metric_eff(vals, present, missing):
    """(values, presence) with the metric's `missing` substitute:
    `missing` is None or the value."""
    if missing is None:
        return vals, present
    return torch.where(present, vals, missing), torch.ones_like(present)


def _metric_boards(tgt, ok, v_eff, n_buckets: int):
    """(count int64, sum f64, min f64, max f64) boards of n_buckets + 1
    lanes; rows with ok False add nothing."""
    dev = tgt.device
    cnt = torch.zeros(n_buckets + 1, dtype=torch.int64, device=dev)
    cnt.scatter_add_(0, tgt, ok.to(torch.int64))
    s = torch.zeros(n_buckets + 1, dtype=torch.float64, device=dev)
    s.scatter_add_(0, tgt, torch.where(ok, v_eff, 0.0))
    mn = torch.full((n_buckets + 1,), _INF, dtype=torch.float64, device=dev)
    mn.scatter_reduce_(0, tgt, torch.where(ok, v_eff, _INF), "amin",
                       include_self=True)
    mx = torch.full((n_buckets + 1,), -_INF, dtype=torch.float64,
                    device=dev)
    mx.scatter_reduce_(0, tgt, torch.where(ok, v_eff, -_INF), "amax",
                       include_self=True)
    return cnt, s, mn, mx


def _counts_board(tgt, ok, n_lanes: int):
    cnt = torch.zeros(n_lanes, dtype=torch.int64, device=tgt.device)
    return cnt.scatter_add_(0, tgt, ok.to(torch.int64))


def _ord_targets(ords, n_buckets: int):
    o = ords.to(torch.int64)
    return torch.where((o >= 0) & (o < n_buckets), o, n_buckets)


def ord_counts(ords, mask, n_buckets: int):
    """Doc counts a global ordinal: int64 [B + 1]; lane B counts the
    matched rows missing the key."""
    _count("ord_counts", mask)
    return _counts_board(_ord_targets(ords, n_buckets), mask, n_buckets + 1)


def ord_metric(ords, mask, missing, vals, present, n_buckets: int):
    """Metric boards an ordinal (count, sum, min, max); lane B holds the
    rows missing the key."""
    _count("ord_metric", mask)
    v_eff, p_eff = _metric_eff(vals, present, missing)
    return _metric_boards(_ord_targets(ords, n_buckets), mask & p_eff,
                          v_eff, n_buckets)


def _hist_ids(keys, kpresent, hp, n_buckets: int):
    """Bucket ids from the key column: hp = (interval, offset, base, div,
    key missing or None). `div` turns date_nanos into millis; `base`
    rebases floor((v - offset) / interval) into [0, B). All in f64, the
    host's numpy key math bit for bit."""
    interval, offset, base, div, kmissing = hp
    p_eff = kpresent if kmissing is None else torch.ones_like(kpresent)
    v = torch.where(kpresent, keys / div,
                    0.0 if kmissing is None else kmissing)
    m = torch.floor((v - offset) / interval) - base
    # clamp before the cast: an id off the span lands in the trash lane
    ids = m.clamp(-1.0, float(n_buckets)).to(torch.int64)
    ok = p_eff & (ids >= 0) & (ids < n_buckets)
    return torch.where(ok, ids, n_buckets), ok


def hist_counts(keys, kpresent, mask, hp, n_buckets: int):
    _count("hist_counts", mask)
    tgt, ok = _hist_ids(keys, kpresent, hp, n_buckets)
    return _counts_board(tgt, mask & ok, n_buckets + 1)


def hist_metric(keys, kpresent, mask, hp, missing, vals, present,
                n_buckets: int):
    _count("hist_metric", mask)
    tgt, ok = _hist_ids(keys, kpresent, hp, n_buckets)
    v_eff, p_eff = _metric_eff(vals, present, missing)
    return _metric_boards(tgt, mask & ok & p_eff, v_eff, n_buckets)


def _range_members(keys, kpresent, mask, bounds, kmissing):
    """[B, R] membership: bounds f64 [B, 2] (lo, hi), -inf / +inf for open
    ends and (+inf, +inf) for pad ranges. A row may fall in several
    overlapping ranges, as on the host."""
    p_eff = kpresent if kmissing is None else torch.ones_like(kpresent)
    v = torch.where(kpresent, keys, 0.0 if kmissing is None else kmissing)
    ok = mask & p_eff
    return (v[None, :] >= bounds[:, 0:1]) & (v[None, :] < bounds[:, 1:2]) \
        & ok[None, :]


def range_counts(keys, kpresent, mask, bounds, kmissing):
    _count("range_counts", mask)
    return _range_members(keys, kpresent, mask, bounds, kmissing).sum(
        dim=1, dtype=torch.int64)


def range_metric(keys, kpresent, mask, bounds, kmissing, missing, vals,
                 present):
    _count("range_metric", mask)
    m = _range_members(keys, kpresent, mask, bounds, kmissing)
    v_eff, p_eff = _metric_eff(vals, present, missing)
    mm = m & p_eff[None, :]
    v = v_eff[None, :]
    return (mm.sum(dim=1, dtype=torch.int64),
            torch.where(mm, v, 0.0).sum(dim=1),
            torch.where(mm, v, _INF).amin(dim=1),
            torch.where(mm, v, -_INF).amax(dim=1))


def _cal_ids(keys, kpresent, cbounds, cp, n_buckets: int):
    """Calendar bucket ids: a `searchsorted` of each row's offset-shifted
    millis, truncated toward zero as the host's `int(v - offset)`, over
    the sorted `_calendar_floor` boundaries cbounds f64 [B] (+inf past the
    span); cp = (div, offset)."""
    div, offset = cp
    shifted = torch.trunc(keys / div - offset)
    ids = torch.searchsorted(cbounds, shifted, right=True) - 1
    ok = kpresent & (ids >= 0) & (ids < n_buckets)
    return torch.where(ok, ids, 0), ok


def cal_counts(keys, kpresent, mask, cbounds, cp, n_buckets: int):
    _count("cal_counts", mask)
    ids, ok = _cal_ids(keys, kpresent, cbounds, cp, n_buckets)
    return _counts_board(torch.where(ok, ids, n_buckets), mask & ok,
                         n_buckets + 1)


def cal_metric(keys, kpresent, mask, cbounds, cp, missing, vals, present,
               n_buckets: int):
    _count("cal_metric", mask)
    ids, ok = _cal_ids(keys, kpresent, cbounds, cp, n_buckets)
    v_eff, p_eff = _metric_eff(vals, present, missing)
    return _metric_boards(torch.where(ok, ids, n_buckets), mask & ok & p_eff,
                          v_eff, n_buckets)


def _tree_targets(mask, levels):
    """Composite ids over a chain of levels, `cid = cid * k + id` level by
    level; a row counts only when every level resolves. A level is
    (kind, k, args): ("ord", k, (ords, has_missing)) - an absent key takes
    the last lane when the level has a `missing` bucket, else drops out;
    ("hist", k, (keys, kpresent, hp)); ("cal", k, (keys, kpresent,
    cbounds, cp)). Returns (targets, ok, total lanes) with the target of
    a row that is not ok == total (the trash lane)."""
    cid = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    ok = mask
    total = 1
    for kind, k, args in levels:
        if kind == "ord":
            ords, has_missing = args
            o = ords.to(torch.int64)
            absent = o < 0
            ids = torch.where(absent, k - 1, o)
            lok = ~absent if not has_missing else torch.ones_like(absent)
        elif kind == "hist":
            tgt, lok = _hist_ids(*args, k)
            ids = torch.where(lok, tgt, 0)
        else:
            ids, lok = _cal_ids(*args, k)
        cid = cid * k + torch.where(lok, ids, 0)
        ok = ok & lok
        total *= k
    return torch.where(ok, cid, total), ok, total


def tree_counts(mask, levels):
    """Composite doc counts: int64 [prod(k) + 1], the last lane the trash."""
    _count("tree_counts", mask)
    tgt, ok, total = _tree_targets(mask, levels)
    return _counts_board(tgt, ok, total + 1)


def tree_metric(mask, missing, vals, present, levels):
    """Metric boards a composite bucket."""
    _count("tree_metric", mask)
    tgt, ok, total = _tree_targets(mask, levels)
    v_eff, p_eff = _metric_eff(vals, present, missing)
    return _metric_boards(tgt, ok & p_eff, v_eff, total)


def hll_board(mask, hidx, hrho, levels):
    """HLL registers a composite bucket: int32 [total + 1, HLL_M], the max
    rank of each (bucket, register). rho 0 marks an absent value, which
    raises no register; with no levels every matched row is lane 0."""
    _count("hll_board", mask)
    tgt, ok, total = _tree_targets(mask, levels)
    rho = torch.where(ok, hrho, 0)
    board = torch.zeros((total + 1) * HLL_M, dtype=torch.int32,
                        device=mask.device)
    board.scatter_reduce_(0, tgt * HLL_M + hidx.to(torch.int64), rho,
                          "amax", include_self=True)
    return board.view(total + 1, HLL_M)


# ----------------------------------------------------------------- store

class AggColumn:
    """One field's aggregation column over a reader snapshot, padded to
    the snapshot's row count: `vals` f64 (NaN where absent), `present`,
    `ords` int32 (-1 absent) with `ord_keys`, and `hll_idx` / `hll_rho`
    int32, each on the host; `device_arrays` uploads them once."""

    __slots__ = ("field", "version", "n_rows", "r_pad", "vals", "present",
                 "integral_exact", "multi_valued", "ords_built", "ords",
                 "ord_keys", "vmin", "vmax", "hll_built", "hll_idx",
                 "hll_rho", "_device")

    def __init__(self, field: str):
        self.field = field
        self.version: tuple = ()
        self.n_rows = 0
        self.r_pad = 1
        self.vals = np.full(1, np.nan, dtype=np.float64)
        self.present = np.zeros(1, dtype=bool)
        self.integral_exact = False
        self.multi_valued = False
        self.ords_built = False
        self.ords: Optional[np.ndarray] = None
        self.ord_keys: List[Any] = []
        self.vmin = None
        self.vmax = None
        self.hll_built = False
        self.hll_idx: Optional[np.ndarray] = None
        self.hll_rho: Optional[np.ndarray] = None
        self._device: Dict[Any, tuple] = {}

    def device_arrays(self, device: torch.device) -> tuple:
        """(vals f64, present bool, ords int32 or None, hll_idx, hll_rho)
        on `device`."""
        key = str(device)
        out = self._device.get(key)
        if out is None:
            def up(a):
                return None if a is None else torch.from_numpy(a).to(device)
            out = self._device[key] = (up(self.vals), up(self.present),
                                       up(self.ords), up(self.hll_idx),
                                       up(self.hll_rho))
        return out


class StoreSnapshot:
    """The row space of one reader: its live rows (ascending) and their
    padded count. Made once a pass, so a refresh meanwhile cannot move the
    rows under a request's mask."""

    __slots__ = ("version", "row_map", "n_rows", "r_pad")

    def __init__(self, version, row_map: np.ndarray):
        self.version = version
        self.row_map = row_map
        self.n_rows = len(row_map)
        self.r_pad = _pow2(max(self.n_rows, 1))

    def filter_mask(self, rows: np.ndarray) -> np.ndarray:
        """The matched rows as a bool mask over the padded rows."""
        mask = np.zeros(self.r_pad, dtype=bool)
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == self.n_rows and np.array_equal(rows, self.row_map):
            mask[:self.n_rows] = True       # every live row (match_all)
        elif len(rows) and self.n_rows:
            pos = np.searchsorted(self.row_map, rows)
            ok = pos < self.n_rows
            ok[ok] = self.row_map[pos[ok]] == rows[ok]
            mask[pos[ok]] = True
        return mask


class AggFieldStore:
    """One index's columns over its combined reader: an AggColumn a field,
    rebuilt when the segments change, each segment's values block cached
    by fingerprint (only new segments are extracted)."""

    def __init__(self):
        self._columns: Dict[str, AggColumn] = {}
        self._blocks: Dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._snap: Optional[StoreSnapshot] = None
        self.stats = {"rebuilds": 0, "columns": 0, "bytes": 0,
                      "blocks_cached": 0, "blocks_extracted": 0}
        # each field's last column (re)build: its blocks cached and
        # extracted and the composition (`profile.shards[].columnar`)
        self.columnar_refresh: Dict[str, dict] = {}

    @staticmethod
    def _version(reader) -> tuple:
        return tuple((v.segment.seg_id, v.segment.num_docs,
                      int(v.live.sum())) for v in reader.views)

    def snapshot(self, reader) -> StoreSnapshot:
        version = self._version(reader)
        with self._lock:
            if self._snap is not None and self._snap.version == version:
                return self._snap
            self._snap = StoreSnapshot(version, reader.live_global_rows())
            return self._snap

    def column(self, reader, field: str, want_ords: bool = False,
               snap: Optional[StoreSnapshot] = None,
               want_hll: bool = False) -> AggColumn:
        """The field's column for `snap`, built or rebuilt as needed."""
        if snap is None:
            snap = self.snapshot(reader)
        with self._lock:
            col = self._columns.get(field)
            if col is not None and col.version == snap.version \
                    and (not want_ords or col.ords_built) \
                    and (not want_hll or col.hll_built):
                return col
            col = self._build(reader, snap, field,
                              want_ords or (col is not None
                                            and col.ords_built),
                              want_hll or (col is not None
                                           and col.hll_built))
            self._columns[field] = col
            self.stats["rebuilds"] += 1
            self.stats["columns"] = len(self._columns)
            self.stats["bytes"] = sum(
                c.vals.nbytes + c.present.nbytes
                + (c.ords.nbytes if c.ords is not None else 0)
                + (2 * c.hll_idx.nbytes if c.hll_idx is not None else 0)
                for c in self._columns.values())
            return col

    def _block(self, view, field: str, want_objs: bool):
        """(the segment's values block, whether it was cached)."""
        from elasticsearch_tpu_torch.columnar.blocks import fingerprint
        key = fingerprint(view, (field, want_objs))
        blk = self._blocks.get(key)
        if blk is None:
            blk = self._blocks[key] = extract_values_block(view, field,
                                                           want_objs)
            self.stats["blocks_extracted"] += 1
            return blk, False
        self.stats["blocks_cached"] += 1
        return blk, True

    def _build(self, reader, snap: StoreSnapshot, field: str,
               want_ords: bool, want_hll: bool) -> AggColumn:
        col = AggColumn(field)
        col.version = snap.version
        col.n_rows = snap.n_rows
        col.r_pad = snap.r_pad
        vals = np.full(snap.r_pad, np.nan, dtype=np.float64)
        present = np.zeros(snap.r_pad, dtype=bool)
        want_objs = want_ords or want_hll
        objs = np.empty(snap.n_rows, dtype=object) if want_objs else None
        off = 0
        multi = False
        keep = set()
        n_cached = 0
        for view in reader.views:
            blk, cached = self._block(view, field, want_objs)
            n_cached += cached
            keep.add(blk.fingerprint)
            n = len(blk.vals)
            vals[off:off + n] = blk.vals
            present[off:off + n] = blk.present
            if want_objs:
                objs[off:off + n] = blk.objs
            multi = multi or blk.multi_valued
            off += n
        # blocks of segments merged away or of an older live set go
        for key in [k for k in self._blocks
                    if k[3] == field and k not in keep]:
            del self._blocks[key]
        n_blocks = len(reader.views)
        self.columnar_refresh[field] = {
            "blocks": n_blocks, "cached": n_cached,
            "extracted": n_blocks - n_cached,
            "mode": ("cached" if n_cached == n_blocks
                     else "delta" if n_cached else "full")}
        col.vals, col.present, col.multi_valued = vals, present, multi
        pv = vals[present]
        if len(pv):
            col.vmin, col.vmax = float(pv.min()), float(pv.max())
            col.integral_exact = bool(
                np.isfinite(pv).all() and np.all(pv == np.floor(pv))
                and float(np.abs(pv).sum()) < _EXACT_INT)
        else:
            col.integral_exact = True   # an empty sum is exact
        # a multi-valued column keeps its requests marked satisfied and
        # its arrays None: the plan takes the host path on multi_valued
        col.ords_built = bool(want_ords)
        col.hll_built = bool(want_hll)
        if multi or not want_objs:
            return col
        index: Dict[Any, int] = {}
        keys: List[Any] = []
        ords = np.full(snap.r_pad, -1, dtype=np.int32)
        for i, v in enumerate(objs.tolist()):
            if v is None:
                continue
            k = tuple(v) if isinstance(v, (list, tuple)) else v
            o = index.get(k)
            if o is None:
                o = index[k] = len(keys)
                keys.append(v)
            ords[i] = o
        if want_ords:
            col.ords, col.ord_keys = ords, keys
        if want_hll:
            # each distinct value hashed once, the hash the host's partial
            # walker uses, so the boards pack into the same `$p` states
            regs = np.asarray([hll_register(hll_hash(k)) for k in index],
                              dtype=np.int32).reshape(-1, 2)
            has = ords >= 0
            col.hll_idx = np.zeros(snap.r_pad, dtype=np.int32)
            col.hll_rho = np.zeros(snap.r_pad, dtype=np.int32)
            col.hll_idx[has] = regs[ords[has], 0]
            col.hll_rho[has] = regs[ords[has], 1]
        return col
