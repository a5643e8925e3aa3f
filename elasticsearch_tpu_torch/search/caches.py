"""The node's search caches and the can_match shard pre-filter (port of
`elasticsearch_tpu/search/caches.py`).

- **Shard request cache** (`RequestCache`): whole query-phase results
  keyed on the request body and the reader's content fingerprint. Bodies
  with `size: 0` cache by default, `request_cache: true` opts in and
  `request_cache: false` out, and a body with a script or a `"now"` never
  caches. Two rungs share the policy: the host rung (`request`) and the
  device rung (`device_request`), which takes every kNN-bearing body at
  any size and whole hybrid `rank: {rrf}` responses.
- **Node query cache** (`QueryCache`): the rows of a `bool`'s `filter`
  clauses keyed (reader generation, the clause's canonical `to_dict`).
  Filters never score, so a cached row array is the whole result. A
  clause whose `to_dict` leaves out an option that changes its rows is
  not cached (`search/queries.py::Query.key_is_exact`).
- **can_match**: do the query's required range clauses overlap the
  shard's field min/max (a date bound read through the field's mapper)?
  A provably empty index is skipped before its query phase.

Every cache is an entry-count LRU shared by the node's indices.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.columnar.blocks import fingerprint
from elasticsearch_tpu_torch.index.mapping import parse_date_millis


def _approx_bytes(value: Any, _depth: int = 0) -> int:
    """Approximate resident size of a cached entry: arrays by nbytes,
    strings and bytes by length, containers by a bounded recursion, other
    objects by their attributes."""
    if value is None or isinstance(value, (bool, int, float)):
        return 8
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (str, bytes)):
        return len(value)
    if _depth >= 6:
        return 64
    if isinstance(value, dict):
        return 64 + sum(_approx_bytes(k, _depth + 1)
                        + _approx_bytes(v, _depth + 1)
                        for k, v in value.items())
    if isinstance(value, (list, tuple, set, frozenset)):
        return 64 + sum(_approx_bytes(v, _depth + 1) for v in value)
    nb = getattr(value, "nbytes", None)
    if isinstance(nb, (int, np.integer)):
        return int(nb)
    d = getattr(value, "__dict__", None)
    if isinstance(d, dict):
        return 64 + sum(_approx_bytes(v, _depth + 1) for v in d.values())
    return 64


class LruCache:
    """Entry-count-bounded LRU with hit, miss, eviction and byte counts.
    HTTP threads and the hybrid batcher's finalize threads both read and
    write it, so every access takes its lock."""

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._map: "OrderedDict[Any, Any]" = OrderedDict()
        self._entry_bytes: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes = 0

    def get(self, key):
        with self._lock:
            try:
                value = self._map[key]
            except KeyError:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key, value) -> None:
        nb = _approx_bytes(key) + _approx_bytes(value)
        with self._lock:
            if key in self._map:
                self.bytes -= self._entry_bytes.get(key, 0)
            self._map[key] = value
            self._entry_bytes[key] = nb
            self.bytes += nb
            self._map.move_to_end(key)
            while len(self._map) > self.max_entries:
                old_key, _ = self._map.popitem(last=False)
                self.bytes -= self._entry_bytes.pop(old_key, 0)
                self.evictions += 1

    def clear(self) -> None:
        """Drop every entry; the counters stay, as the reference's do."""
        with self._lock:
            self._map.clear()
            self._entry_bytes.clear()
            self.bytes = 0

    def __len__(self):
        return len(self._map)

    def stats(self) -> dict:
        """The cache's section of `_stats`, in the reference's names."""
        return {"memory_size_in_bytes": self.bytes,
                "evictions": self.evictions, "hit_count": self.hits,
                "miss_count": self.misses}


def _json_default(value: Any):
    # an array keys as its values: `str` elides the middle of a long one
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    return str(value)


def _canonical(body: Any) -> str:
    return json.dumps(body, sort_keys=True, separators=(",", ":"),
                      default=_json_default)


class RequestCache(LruCache):
    """Shard request cache: (shard key, reader epoch, body) -> query-phase
    result. `skipped_uncacheable` counts bodies that asked to cache
    (`request_cache: true`) but were refused as non-deterministic."""

    def __init__(self, max_entries: int = 1024):
        super().__init__(max_entries)
        self.skipped_uncacheable = 0

    @staticmethod
    def deterministic(body: dict) -> bool:
        """False for bodies whose results can differ between identical
        requests (scripts, "now"-relative values)."""
        src = _canonical(body)
        return '"script' not in src and '"now' not in src.lower()

    @staticmethod
    def cacheable(body: dict) -> bool:
        flag = body.get("request_cache")
        if flag is False:
            return False
        if flag is not True and body.get("size", None) != 0:
            return False  # before _canonical: large bodies stay unread
        return RequestCache.deterministic(body)

    def cacheable_tracked(self, body: dict) -> bool:
        """`cacheable`, counting an opted-in non-deterministic body as
        `skipped_uncacheable`."""
        flag = body.get("request_cache")
        if flag is True and not self.deterministic(body):
            self.skipped_uncacheable += 1
            return False
        return self.cacheable(body)

    def device_cacheable(self, body: dict) -> bool:
        """The device rung's policy: a body whose query phase runs a kNN
        dispatch caches at any size (the fetch re-runs per request), and
        so does a hybrid `rank: {rrf}` body (its whole response);
        `request_cache: false` opts out and a non-deterministic body is
        refused."""
        flag = body.get("request_cache")
        if flag is False:
            return False
        q, rank = body.get("query"), body.get("rank")
        on_device = "knn" in body or (isinstance(q, dict) and "knn" in q) \
            or (isinstance(rank, dict) and "rrf" in rank)
        if not on_device:
            return False    # the host rung's policy decides
        if not self.deterministic(body):
            if flag is True:
                self.skipped_uncacheable += 1
            return False
        return True

    def key(self, shard_key: Any, reader_epoch, body: dict) -> tuple:
        """`reader_epoch` is a reader generation or a content fingerprint
        (`reader_fingerprint`), which keeps entries across refreshes that
        changed nothing."""
        return (shard_key, reader_epoch, _canonical(
            {k: v for k, v in body.items() if k != "request_cache"}))

    def stats(self) -> dict:
        return {**super().stats(),
                "skipped_uncacheable": self.skipped_uncacheable}


def reader_fingerprint(reader) -> tuple:
    """Content fingerprint of a point-in-time reader: each segment's
    (seg_id, num_docs, live_count), as the columnar blocks key their
    arrays. Any ingest, update or merge changes a component; a refresh
    that changed nothing does not. Memoized on the reader, whose live
    bitmaps are fixed when it is made."""
    fp = getattr(reader, "_content_fingerprint", None)
    if fp is None:
        fp = reader._content_fingerprint = tuple(
            fingerprint(v) for v in reader.views)
    return fp


class QueryCache(LruCache):
    """Node query cache: (reader gen, filter source) -> matching rows."""

    def get_rows(self, reader_gen: int,
                 filter_source: str) -> Optional[np.ndarray]:
        return self.get((reader_gen, filter_source))

    def put_rows(self, reader_gen: int, filter_source: str,
                 rows: np.ndarray) -> None:
        self.put((reader_gen, filter_source), rows)


# ------------------------------------------------------------------ can_match

def _iter_range_clauses(query: Optional[dict]):
    """Yield (field, bounds) for every range clause that constrains the
    whole query: a top-level range, or one under `bool.must` /
    `bool.filter` or `constant_score.filter` (a `should` range does
    not)."""
    if not isinstance(query, dict):
        return
    for kind, spec in query.items():
        if kind == "range" and isinstance(spec, dict):
            for field, bounds in spec.items():
                if isinstance(bounds, dict):
                    yield field, bounds
        elif kind == "bool" and isinstance(spec, dict):
            for clause in ("must", "filter"):
                items = spec.get(clause, [])
                if isinstance(items, dict):
                    items = [items]
                for sub in items:
                    yield from _iter_range_clauses(sub)
        elif kind == "constant_score" and isinstance(spec, dict):
            yield from _iter_range_clauses(spec.get("filter"))


def _to_number(value, mapper_service, field: str,
               round_up: bool = False) -> Optional[float]:
    """A range bound as a number, None when it is not one. A string bound
    on a `date` field is read as `RangeQuery` reads it (date math, and an
    upper bound rounded up to the end of its unit), so can_match never
    skips a shard the query would hit."""
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        mapper = mapper_service.get(field) if mapper_service else None
        if getattr(mapper, "type_name", None) == "date":
            try:
                return float(parse_date_millis(value, round_up=round_up))
            except Exception:
                return None
        try:
            return float(value)
        except ValueError:
            return None
    return None


def has_range_clauses(query: Optional[dict]) -> bool:
    """Whether the query has a range clause that constrains it whole (a
    must / filter one): the bodies can_match can prove empty."""
    return next(_iter_range_clauses(query), None) is not None


def can_match(reader, body: dict, mapper_service=None) -> bool:
    """True unless a required range clause provably excludes every live
    doc of the reader (field max < gte, or field min > lte). Anything
    unparseable means "might match"; without a mapping a date string
    is."""
    query = body.get("query")
    for field, bounds in _iter_range_clauses(query):
        stats = field_stats(reader, field)
        if stats is None:
            # a field no doc of the reader holds: a required range on it
            # matches nothing
            if reader.num_docs > 0 and not _shard_has_field(reader, field):
                return False
            continue
        fmin, fmax = stats
        gte = _to_number(bounds.get("gte", bounds.get("gt")), mapper_service,
                         field, round_up="gte" not in bounds
                         and "gt" in bounds)
        lte = _to_number(bounds.get("lte", bounds.get("lt")), mapper_service,
                         field, round_up="lte" in bounds)
        if gte is not None:
            if "gt" in bounds and "gte" not in bounds:
                if fmax <= gte:
                    return False
            elif fmax < gte:
                return False
        if lte is not None:
            if "lt" in bounds and "lte" not in bounds:
                if fmin >= lte:
                    return False
            elif fmin > lte:
                return False
    return True


def _shard_has_field(reader, field: str) -> bool:
    for v in reader.views:
        if field in v.segment.doc_values or field in v.segment.postings:
            return True
    return False


def field_stats(reader, field: str) -> Optional[Tuple[float, float]]:
    """(min, max) of a numeric field over the live docs, memoized on the
    reader."""
    cache: Dict[str, Optional[Tuple[float, float]]] = getattr(
        reader, "_field_stats_cache", None)
    if cache is None:
        cache = reader._field_stats_cache = {}
    if field in cache:
        return cache[field]
    fmin = fmax = None
    for v in reader.views:
        col = v.segment.doc_values.get(field)
        if col is None or col.numeric is None:
            continue
        mask = v.live & col.present
        if not mask.any():
            continue
        vals = col.numeric[mask]
        lo, hi = float(vals.min()), float(vals.max())
        fmin = lo if fmin is None else min(fmin, lo)
        fmax = hi if fmax is None else max(fmax, hi)
    result = None if fmin is None else (fmin, fmax)
    cache[field] = result
    return result


class NodeCaches:
    """The node's caches, shared by its indices: the host rung of the
    shard request cache (`request`), its device rung (`device_request`:
    kNN query-phase results and hybrid responses, a separate instance so
    each rung's hit rate reads apart) and the node query cache
    (`query`)."""

    def __init__(self, request_entries: int = 1024, query_entries: int = 2048,
                 device_request_entries: int = 512):
        self.request = RequestCache(request_entries)
        self.device_request = RequestCache(device_request_entries)
        self.query = QueryCache(query_entries)

    def stats(self) -> dict:
        """The node's `query_cache` and `request_cache` sections of
        `_stats`, the request cache summing both rungs, as the reference
        sums them."""
        host, dev = self.request.stats(), self.device_request.stats()
        return {"query_cache": self.query.stats(),
                "request_cache": {k: host[k] + dev[k] for k in host}}
