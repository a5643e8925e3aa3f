"""The host walkers of the reference's extended query kinds (port of
`elasticsearch_tpu/search/queries_ext.py`).

`late_interaction`:
score = sum over query tokens of the max over a doc's tokens of their dot
product (cosine normalizes both sides per token, per the field mapping), in
f32 numpy over the raw stored tokens: no quantization and no coarse
pruning. It serves a plain `_search {query: {late_interaction}}` body, as
the reference's query phase does, and it is the oracle the device path is
recall-gated against. A hybrid `late_interaction` leg never takes it.

`sparse_vector` / `weighted_tokens`: score = the sum over the tokens a doc
shares with the query of stored weight * f32(f32(query weight) *
f32(boost)), added in f32 in the query map's order, over the segments'
feature-major columns (`index/segment.py::FeatureMapColumn`), so its rows
and f32 bits are the learned-sparse board's (`ops/sparse.py`). It serves
a plain `query` and a hybrid leg on a field that holds no feature maps.

`rank_feature`: a `rank_feature` field's value, or one feature of a
`rank_features` field (`<field>.<feature>`), through `saturation` (pivot
defaulting to the mean value), `log`, `sigmoid` or `linear`, in f64, then
times the boost, to f32.

The geo queries (`geo_distance`, `geo_bounding_box` with boxes across the
dateline, `geo_polygon` by ray casting, `geo_shape` by envelope relation)
and `distance_feature` (boost * pivot / (pivot + distance) on a
`geo_point`, `date` or `date_nanos` field) read each segment's doc-values
column once into float64 arrays kept with it (`DocValuesColumn.derived`):
a doc's first point, a missing value excluded, haversine distances in
float64 with the reference's earth radius. `more_like_this` picks the
like texts' terms by tf * idf and runs them as a `bool.should`;
`terms_set` counts a doc's matching terms against a field or a script,
which is evaluated by walking its syntax tree under a whitelist, never by
`eval`. The span kinds and `intervals` work on arrays of spans (row,
start, end), paired a row at a time by `searchsorted`, over the text
postings' positions; a doc scores its number of spans. `pinned` ranks its
ids above the organic query, and `wrapper` parses its base64 query.
"""

from __future__ import annotations

import ast
import base64
import fnmatch
import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.index.mapping import (
    GeoShapeFieldMapper, RankVectorsFieldMapper, parse_date_millis,
    parse_date_nanos,
)
from elasticsearch_tpu_torch.index.segment import FeatureMapColumn
from elasticsearch_tpu_torch.search.queries import (
    BoolQuery, DocSet, Query, SearchContext, TermQuery, _check_expensive,
    _fuzzy_terms, _pattern_terms, _prefix_select, _ranges, _regex_select,
    _wildcard_regex, id_row_map, parse_query,
)

_KEYS = {"field", "query_tokens", "k", "boost"}


class LateInteractionQuery:
    def __init__(self, field: str, query_tokens, boost: float = 1.0):
        self.field = field
        q = np.asarray(query_tokens, dtype=np.float32)
        if q.ndim == 1:
            q = q.reshape(1, -1)
        if q.ndim != 2 or not q.size:
            raise ParsingError(
                "[late_interaction] query_tokens must be a non-empty "
                "array of vectors")
        self.query_tokens = q
        self.boost = float(boost)

    @classmethod
    def parse(cls, spec) -> "LateInteractionQuery":
        if not isinstance(spec, dict) or "field" not in spec \
                or "query_tokens" not in spec:
            raise ParsingError("[late_interaction] requires [field] and "
                               "[query_tokens]")
        for key in spec:
            if key not in _KEYS:
                raise ParsingError(f"[late_interaction] unknown field [{key}]")
        return cls(spec["field"], spec["query_tokens"],
                   boost=spec.get("boost", 1.0))

    def execute(self, reader, mapper_service) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """(rows [m] ascending, f32 scores [m]) of every live doc holding
        the field."""
        mapper = mapper_service.get(self.field)
        if not isinstance(mapper, RankVectorsFieldMapper):
            raise IllegalArgumentError(
                f"[late_interaction] field [{self.field}] is not a "
                f"rank_vectors field")
        cosine = mapper.similarity == "cosine"
        q = self.query_tokens
        if q.shape[1] != mapper.dims:
            raise IllegalArgumentError(
                f"[late_interaction] query tokens have {q.shape[1]} dims, "
                f"field [{self.field}] expects {mapper.dims}")
        if cosine:
            q = q / np.maximum(
                np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
        rows, scores = [], []
        for view in reader.views:
            seg = view.segment
            entry = seg.tokens.get(self.field)
            if entry is None:
                continue
            toks, offsets, present = entry
            for loc in np.nonzero(view.live & present)[0]:
                t = toks[offsets[loc]:offsets[loc + 1]]
                if cosine:
                    t = t / np.maximum(
                        np.linalg.norm(t, axis=-1, keepdims=True), 1e-30)
                dots = q @ t.T                           # [Tq, Td] f32
                rows.append(seg.base + int(loc))
                scores.append(float(dots.max(axis=1).sum()) * self.boost)
        return (np.asarray(rows, dtype=np.int64),
                np.asarray(scores, dtype=np.float32))

    def to_dict(self):
        return {"late_interaction": {
            "field": self.field,
            "query_tokens": self.query_tokens.tolist()}}



class RankFeatureQuery(Query):
    def __init__(self, field: str, saturation=None, log=None, sigmoid=None,
                 linear=None, boost: float = 1.0):
        self.field = field
        self.saturation = saturation
        self.log = log
        self.sigmoid = sigmoid
        self.linear = linear
        self.boost = boost

    def _feature_values(self, ctx: SearchContext
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows ascending, f64 values) of the live docs holding the
        feature: a number (a list gives its first), or the feature's
        weight in a doc's `rank_features` map."""
        root, _, feature = self.field.partition(".")
        mapper = ctx.mapper_service.get(root)
        use_map = bool(feature) and mapper is not None \
            and mapper.type_name == "rank_features"
        lookup = root if use_map else self.field
        rows: List[np.ndarray] = []
        vals: List[np.ndarray] = []
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(lookup)
            if col is None:
                continue
            value = np.zeros(seg.num_docs, dtype=np.float64)
            has = np.zeros(seg.num_docs, dtype=bool)
            walk = np.nonzero(col.present)[0]
            if use_map and isinstance(col, FeatureMapColumn):
                code = np.nonzero(col.names == feature)[0]
                if len(code):
                    hit = np.nonzero(col.codes == code[0])[0]
                    docs = np.searchsorted(col.offsets, hit,
                                           side="right") - 1
                    value[docs] = col.weights[hit]
                    has[docs] = True
                walk = np.asarray(sorted(col.other), dtype=np.int64)
            elif col.numeric is not None:
                value, has = col.numeric, col.present
                walk = walk[:0]
            # any other value, as the reference reads it
            for loc in walk[view.live[walk]]:
                v = col.values[loc]
                if use_map and isinstance(v, dict):
                    v = v.get(feature)
                if isinstance(v, list):
                    v = v[0] if v else None
                if v is None:
                    continue
                value[loc] = float(v)
                has[loc] = True
            keep = np.nonzero(has & view.live)[0]
            rows.append(keep + seg.base)
            vals.append(value[keep])
        if not rows:
            return np.zeros(0, dtype=np.int64), np.zeros(0)
        return np.concatenate(rows).astype(np.int64), np.concatenate(vals)

    def execute(self, ctx: SearchContext) -> DocSet:
        rows, v = self._feature_values(ctx)
        if self.log is not None:
            score = np.log(float(self.log.get("scaling_factor", 1.0)) + v)
        elif self.sigmoid is not None:
            k = float(self.sigmoid["pivot"])
            a = float(self.sigmoid["exponent"])
            score = v ** a / (k ** a + v ** a)
        elif self.linear is not None:
            score = v
        else:
            pivot = float((self.saturation or {}).get(
                "pivot", max(float(np.mean(v)) if len(v) else 1.0, 1e-9)))
            score = v / (v + pivot)
        return DocSet(rows, (self.boost * score).astype(np.float32))

    def to_dict(self):
        return {"rank_feature": {"field": self.field}}


class WeightedTokensQuery(Query):
    """`sparse_vector` / `weighted_tokens`: score = the sum over the
    tokens a doc shares with the query of stored weight * query weight *
    boost, the learned-sparse dot product over the field's feature maps.
    Each token adds, in the query map's order, its f32 weights times
    f32(f32(weight) * f32(boost)) into f32 sums: the board's order and
    bits (`ops/sparse.py`)."""

    def __init__(self, field: str, tokens: Dict, boost: float = 1.0):
        self.field = field
        self.tokens = {str(k): float(v) for k, v in tokens.items()}
        self.boost = float(boost)

    def execute(self, ctx: SearchContext) -> DocSet:
        rows: List[np.ndarray] = []
        scores: List[np.ndarray] = []
        boost = np.float32(self.boost)
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(self.field)
            if not isinstance(col, FeatureMapColumn):
                continue
            names, starts, docs, weights = col.by_feature()
            acc = np.zeros(seg.num_docs, dtype=np.float32)
            counts = np.zeros(seg.num_docs, dtype=np.int32)
            for t, w in self.tokens.items():       # the query map's order
                j = int(np.searchsorted(names, t))
                if j == len(names) or names[j] != t:
                    continue
                d = docs[starts[j]:starts[j + 1]]
                wt = weights[starts[j]:starts[j + 1]]
                if not view.all_live:
                    live = view.live[d]
                    d, wt = d[live], wt[live]
                acc[d] += wt * np.float32(np.float32(w) * boost)
                counts[d] += 1
            keep = np.nonzero(counts)[0]
            rows.append(keep.astype(np.int64) + seg.base)
            scores.append(acc[keep])
        if not rows:
            return DocSet.empty()
        return DocSet(np.concatenate(rows), np.concatenate(scores))

    def to_dict(self):
        return {"sparse_vector": {"field": self.field,
                                  "query_vector": dict(self.tokens)}}


# ------------------------------------------------------------------- helpers

EARTH_RADIUS_M = 6371008.8

_DIST_UNITS = {"m": 1.0, "meters": 1.0, "km": 1000.0, "kilometers": 1000.0,
               "mi": 1609.344, "miles": 1609.344, "yd": 0.9144, "ft": 0.3048,
               "in": 0.0254, "cm": 0.01, "mm": 0.001, "nmi": 1852.0,
               "nauticalmiles": 1852.0}


def _single_field(spec: Any) -> Tuple[str, Any]:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingError("expected a single-field query object")
    return next(iter(spec.items()))


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in meters, float64, vectorised."""
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def parse_distance(v: Any) -> float:
    """A distance in meters: a number, or a number and a unit (`12km`)."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    for unit in sorted(_DIST_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DIST_UNITS[unit]
    return float(s)


def parse_geo_point(v: Any) -> Tuple[float, float]:
    """(lat, lon) of a {lat, lon} object, a [lon, lat] array or a
    "lat,lon" string."""
    if isinstance(v, dict):
        return float(v["lat"]), float(v["lon"])
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return float(v[1]), float(v[0])
    if isinstance(v, str):
        a, b = v.split(",")
        return float(a), float(b)
    raise ParsingError(f"failed to parse geo point [{v}]")


def _first_point(v):
    """A geo doc value's (lat, lon), its first point for several, or
    None."""
    if isinstance(v, list) and v and isinstance(v[0], (list, tuple)):
        v = v[0]
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return float(v[0]), float(v[1])
    return None


def _geo_view(col) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lat, lon, present) float64 arrays of a segment's geo column, made
    once and kept with the column."""
    view = col.derived.get("geo")
    if view is None:
        n = len(col.values)
        lat, lon = np.zeros(n), np.zeros(n)
        present = np.zeros(n, dtype=bool)
        for loc in np.nonzero(col.present)[0].tolist():
            pt = _first_point(col.values[loc])
            if pt is not None:
                lat[loc], lon[loc] = pt
                present[loc] = True
        view = col.derived["geo"] = (lat, lon, present)
    return view


def geo_points(ctx: SearchContext, field: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows ascending, lat, lon) of the live docs holding a point of
    `field`."""
    rows, lats, lons = [], [], []
    for view in ctx.reader.views:
        seg = view.segment
        col = seg.doc_values.get(field)
        if col is None:
            continue
        lat, lon, present = _geo_view(col)
        keep = np.nonzero(present & view.live)[0]
        rows.append(keep.astype(np.int64) + seg.base)
        lats.append(lat[keep])
        lons.append(lon[keep])
    if not rows:
        return np.zeros(0, dtype=np.int64), np.zeros(0), np.zeros(0)
    return np.concatenate(rows), np.concatenate(lats), np.concatenate(lons)


def _ones(rows: np.ndarray) -> DocSet:
    return DocSet(rows, np.ones(len(rows), dtype=np.float32))


# --------------------------------------------------------------- geo queries

class GeoDistanceQuery(Query):
    def __init__(self, field: str, lat: float, lon: float,
                 distance_m: float):
        self.field = field
        self.lat = lat
        self.lon = lon
        self.distance_m = distance_m

    def execute(self, ctx: SearchContext) -> DocSet:
        rows, lat, lon = geo_points(ctx, self.field)
        d = haversine_m(lat, lon, self.lat, self.lon)
        return _ones(rows[d <= self.distance_m])

    def to_dict(self):
        return {"geo_distance": {"distance": f"{self.distance_m}m",
                                 self.field: {"lat": self.lat,
                                              "lon": self.lon}}}


class GeoBoundingBoxQuery(Query):
    def __init__(self, field: str, top: float, left: float,
                 bottom: float, right: float):
        self.field = field
        self.top, self.left, self.bottom, self.right = top, left, bottom, right

    def execute(self, ctx: SearchContext) -> DocSet:
        rows, lat, lon = geo_points(ctx, self.field)
        in_lat = (lat <= self.top) & (lat >= self.bottom)
        if self.left <= self.right:
            in_lon = (lon >= self.left) & (lon <= self.right)
        else:   # across the dateline
            in_lon = (lon >= self.left) | (lon <= self.right)
        return _ones(rows[in_lat & in_lon])

    def to_dict(self):
        return {"geo_bounding_box": {self.field: {
            "top_left": {"lat": self.top, "lon": self.left},
            "bottom_right": {"lat": self.bottom, "lon": self.right}}}}


class GeoPolygonQuery(Query):
    def __init__(self, field: str, points: List[Tuple[float, float]]):
        self.field = field
        self.points = points    # [(lat, lon)]

    def execute(self, ctx: SearchContext) -> DocSet:
        rows, lat, lon = geo_points(ctx, self.field)
        # ray casting over the edges; the 1e-300 keeps a horizontal edge
        # finite and puts boundary points on the reference's side
        inside = np.zeros(len(rows), dtype=bool)
        pts = self.points
        for i in range(len(pts)):
            y1, x1 = pts[i]
            y2, x2 = pts[(i + 1) % len(pts)]
            cond = (y1 > lat) != (y2 > lat)
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = (x2 - x1) * (lat - y1) / (y2 - y1 + 1e-300) + x1
            inside ^= cond & (lon < xint)
        return _ones(rows[inside])

    def to_dict(self):
        return {"geo_polygon": {self.field: {
            "points": [{"lat": a, "lon": b} for a, b in self.points]}}}


def _envelopes(col) -> Tuple[np.ndarray, np.ndarray]:
    """(doc locals, [m, 4] envelopes) of every value of a segment's column
    a `geo_shape` query relates: a shape's envelope (min_lon, min_lat,
    max_lon, max_lat), a point's (lon, lat, lon, lat); made once and kept
    with the column."""
    view = col.derived.get("envelopes")
    if view is None:
        docs, envs = [], []
        for loc in np.nonzero(col.present)[0].tolist():
            v = col.values[loc]
            for item in (v if isinstance(v, list) else [v]):
                if isinstance(item, dict) and "envelope" in item:
                    envs.append(tuple(item["envelope"]))
                elif isinstance(item, tuple) and len(item) == 2:
                    lat, lon = item
                    envs.append((lon, lat, lon, lat))
                else:
                    continue
                docs.append(loc)
        view = col.derived["envelopes"] = (
            np.asarray(docs, dtype=np.int64),
            np.asarray(envs, dtype=np.float64).reshape(-1, 4))
    return view


class GeoShapeQuery(Query):
    """`geo_shape`: the docs holding a value whose envelope stands in
    `relation` (`intersects`, `disjoint`, `within`, `contains`) to the
    query shape's envelope; a `geo_point` relates as its point."""

    def __init__(self, field: str, shape: dict, relation: str = "intersects"):
        self.field = field
        self.relation = relation
        self.query_env = GeoShapeFieldMapper("_query").coerce(
            shape)["envelope"]

    def _relates(self, env: np.ndarray) -> np.ndarray:
        qmin_lon, qmin_lat, qmax_lon, qmax_lat = self.query_env
        smin_lon, smin_lat, smax_lon, smax_lat = env.T
        if self.relation == "within":
            return ((smin_lon >= qmin_lon) & (smax_lon <= qmax_lon)
                    & (smin_lat >= qmin_lat) & (smax_lat <= qmax_lat))
        if self.relation == "contains":
            return ((smin_lon <= qmin_lon) & (smax_lon >= qmax_lon)
                    & (smin_lat <= qmin_lat) & (smax_lat >= qmax_lat))
        intersects = ((smin_lon <= qmax_lon) & (smax_lon >= qmin_lon)
                      & (smin_lat <= qmax_lat) & (smax_lat >= qmin_lat))
        if self.relation == "disjoint":
            return ~intersects
        return intersects

    def execute(self, ctx: SearchContext) -> DocSet:
        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            col = seg.doc_values.get(self.field)
            if col is None:
                continue
            docs, envs = _envelopes(col)
            hit = np.zeros(seg.num_docs, dtype=bool)
            hit[docs[self._relates(envs)]] = True
            parts.append(np.nonzero(hit & view.live)[0].astype(np.int64)
                         + seg.base)
        if not parts:
            return DocSet.empty()
        return _ones(np.sort(np.concatenate(parts)))

    def to_dict(self):
        return {"geo_shape": {self.field: {"relation": self.relation}}}

    def key_is_exact(self) -> bool:
        return False    # the reference's form leaves the shape out


def _first_numbers(ctx: SearchContext, field: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(rows ascending, f64 values) of the live docs holding a value of
    `field`, a list read as its first value."""
    rows, vals = [], []
    for view in ctx.reader.views:
        seg = view.segment
        col = seg.doc_values.get(field)
        if col is None:
            continue
        if col.numeric is not None:
            value, present = col.numeric, col.present
        else:
            value = np.zeros(seg.num_docs)
            present = np.zeros(seg.num_docs, dtype=bool)
            for loc in np.nonzero(col.present)[0].tolist():
                v = col.values[loc]
                if isinstance(v, list):
                    v = v[0] if v else None
                if v is not None:
                    value[loc], present[loc] = float(v), True
        keep = np.nonzero(present & view.live)[0]
        rows.append(keep.astype(np.int64) + seg.base)
        vals.append(value[keep])
    if not rows:
        return np.zeros(0, dtype=np.int64), np.zeros(0)
    return np.concatenate(rows), np.concatenate(vals)


class DistanceFeatureQuery(Query):
    """boost * pivot / (pivot + distance to the origin), on a `geo_point`
    (meters) or a `date` (millis) or `date_nanos` (nanos) field."""

    def __init__(self, field: str, origin: Any, pivot: Any,
                 boost: float = 1.0):
        self.field = field
        self.origin = origin
        self.pivot = pivot
        self.boost = boost

    def execute(self, ctx: SearchContext) -> DocSet:
        mapper = ctx.mapper_service.get(self.field)
        type_name = getattr(mapper, "type_name", None)
        if type_name == "geo_point":
            lat0, lon0 = parse_geo_point(self.origin)
            pivot = parse_distance(self.pivot)
            rows, lat, lon = geo_points(ctx, self.field)
            dist = haversine_m(lat, lon, lat0, lon0)
        else:
            if type_name == "date_nanos":
                origin = float(parse_date_nanos(self.origin))
                pivot = parse_time_value(self.pivot, "pivot") * 1e9
            else:
                origin = parse_date_millis(self.origin)
                pivot = parse_time_value(self.pivot, "pivot") * 1000.0
            rows, vals = _first_numbers(ctx, self.field)
            dist = np.abs(vals - origin)
        score = self.boost * pivot / (pivot + dist)
        return DocSet(rows, score.astype(np.float32))

    def to_dict(self):
        return {"distance_feature": {"field": self.field,
                                     "origin": self.origin,
                                     "pivot": self.pivot}}

    def key_is_exact(self) -> bool:
        return self.boost == 1.0


# ------------------------------------------------------------ more_like_this

_MLT_DEFAULTS = {"min_term_freq": 2, "min_doc_freq": 5,
                 "max_query_terms": 25, "minimum_should_match": "30%",
                 "include": False}


def _analyzed(mapper, text: str) -> List[str]:
    return (mapper.analyze(text) if hasattr(mapper, "analyze")
            else text.lower().split())


class MoreLikeThisQuery(Query):
    """The like texts' terms (`like` / `unlike` items: a text, an `_id`, or
    a `doc`), each field's counted after its analyzer, less the unlike
    ones; those of at least `min_term_freq` occurrences in at least
    `min_doc_freq` docs ranked by tf * idf, the top `max_query_terms` run
    as a `bool.should` with `minimum_should_match`; the liked docs left
    out unless `include`."""

    def __init__(self, fields: List[str], like: List[Any],
                 min_term_freq: int = 2, min_doc_freq: int = 5,
                 max_query_terms: int = 25,
                 minimum_should_match: Any = "30%",
                 include: bool = False, unlike: Optional[List[Any]] = None):
        self.fields = fields
        self.like = like
        self.unlike = unlike or []
        self.min_term_freq = min_term_freq
        self.min_doc_freq = min_doc_freq
        self.max_query_terms = max_query_terms
        self.minimum_should_match = minimum_should_match
        self.include = include

    @staticmethod
    def _source_of(ctx: SearchContext, row: int) -> Optional[dict]:
        for view in ctx.reader.views:
            seg = view.segment
            if seg.base <= row < seg.base + seg.num_docs:
                return seg.sources[row - seg.base]
        return None

    def _texts(self, ctx, item, fields, id_rows) -> Tuple[dict, Optional[int]]:
        """(field -> text, the liked row or None) of one like item."""
        if isinstance(item, str):
            return {f: item for f in fields}, None
        if isinstance(item, dict) and "_id" in item:
            row = id_rows.get(str(item["_id"]))
            if row is None:
                return {}, None
            src = self._source_of(ctx, row)
            return {f: src.get(f) for f in fields
                    if src and isinstance(src.get(f), str)}, row
        if isinstance(item, dict) and "doc" in item:
            return {f: item["doc"].get(f) for f in fields
                    if isinstance(item["doc"].get(f), str)}, None
        return {}, None

    def selected_terms(self, ctx: SearchContext
                       ) -> Tuple[List[Tuple[str, str]], List[int]]:
        """The (field, term) pairs the query runs, best first, and the
        liked rows."""
        id_rows = id_row_map(ctx.reader)
        fields = self.fields or [
            p for p, m in ctx.mapper_service.all_mappers()
            if getattr(m, "type_name", None) == "text"]
        liked_rows: List[int] = []
        term_freqs: Dict[Tuple[str, str], int] = {}
        for like in self.like:
            if not (isinstance(like, str) or (isinstance(like, dict) and (
                    "_id" in like or "doc" in like))):
                continue
            texts, row = self._texts(ctx, like, fields, id_rows)
            if row is not None:
                liked_rows.append(row)
            for f, text in texts.items():
                if not text:
                    continue
                for t in _analyzed(ctx.mapper_service.get(f), text):
                    term_freqs[(f, t)] = term_freqs.get((f, t), 0) + 1
        for unl in self.unlike:
            texts, _ = self._texts(ctx, unl, fields, id_rows)
            for f, text in texts.items():
                if not text:
                    continue
                for t in _analyzed(ctx.mapper_service.get(f), text):
                    term_freqs.pop((f, t), None)
        n_docs = max(ctx.reader.num_docs, 1)
        scored = []
        for (f, t), tf in term_freqs.items():
            if tf < self.min_term_freq:
                continue
            df = ctx.reader.doc_freq(f, t)
            if df < self.min_doc_freq:
                continue
            idf = math.log(1 + (n_docs - df + 0.5) / (df + 0.5))
            scored.append((tf * idf, f, t))
        scored.sort(reverse=True)
        return ([(f, t) for _, f, t in scored[: self.max_query_terms]],
                liked_rows)

    def execute(self, ctx: SearchContext) -> DocSet:
        terms, liked_rows = self.selected_terms(ctx)
        if not terms:
            return DocSet.empty()
        result = BoolQuery(
            must=[], filter=[], should=[TermQuery(f, t) for f, t in terms],
            must_not=[],
            minimum_should_match=self.minimum_should_match).execute(ctx)
        if not self.include and liked_rows:
            keep = ~np.isin(result.rows, np.asarray(liked_rows,
                                                    dtype=np.int64))
            result = DocSet(result.rows[keep],
                            None if result.scores is None
                            else result.scores[keep])
        return result

    def to_dict(self):
        return {"more_like_this": {"fields": self.fields, "like": self.like}}

    def key_is_exact(self) -> bool:
        return not self.unlike and all(
            getattr(self, k) == v for k, v in _MLT_DEFAULTS.items())


# ----------------------------------------------------------------- terms_set

_SCRIPT_OPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
               ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
               ast.FloorDiv: lambda a, b: a // b,
               ast.Mod: lambda a, b: a % b, ast.Pow: None}
_SCRIPT_NAMES = {"min": min, "max": max}


def _pow(a, b):
    if isinstance(b, (int, float)) and abs(b) > 1024:
        raise OverflowError("exponent too large")
    return a ** b


def _eval_node(node, num_terms: int):
    """One node of a `minimum_should_match_script`: numbers,
    `num_terms`, `+ - * / // % **`, unary signs, `min` / `max` and
    `Math.<name>` of Python's math module; any other form raises."""
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, num_terms)
    if isinstance(node, ast.Constant) \
            and type(node.value) in (int, float, bool):
        return node.value
    if isinstance(node, ast.Name):
        if node.id == "num_terms":
            return num_terms
        if node.id in _SCRIPT_NAMES:
            return _SCRIPT_NAMES[node.id]
        raise NameError(f"name '{node.id}' is not defined")
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "Math":
        if node.attr.startswith("_") or not hasattr(math, node.attr):
            raise AttributeError(
                f"module 'math' has no attribute '{node.attr}'")
        return getattr(math, node.attr)
    if isinstance(node, ast.BinOp) and type(node.op) in _SCRIPT_OPS:
        a = _eval_node(node.left, num_terms)
        b = _eval_node(node.right, num_terms)
        op = _SCRIPT_OPS[type(node.op)] or _pow
        return op(a, b)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                    (ast.USub, ast.UAdd)):
        v = _eval_node(node.operand, num_terms)
        return -v if isinstance(node.op, ast.USub) else +v
    if isinstance(node, ast.Call) and not node.keywords:
        fn = _eval_node(node.func, num_terms)
        if not callable(fn):
            raise TypeError(f"'{type(fn).__name__}' object is not callable")
        return fn(*[_eval_node(a, num_terms) for a in node.args])
    raise ValueError(f"unsupported expression [{ast.dump(node)}]")


def eval_msm_script(source: str, num_terms: int) -> float:
    """The value of a `minimum_should_match_script` (`params.num_terms`
    read as the number of terms); no `eval`: the syntax tree is walked
    under `_eval_node`'s whitelist. A failure is the reference's 400."""
    try:
        tree = ast.parse(source.replace("params.num_terms", "num_terms"),
                         "<msm>", "eval")
        value = _eval_node(tree, num_terms)
        if not isinstance(value, (int, float)):
            raise TypeError(f"not a number: {value!r}")
        return value
    except Exception as e:
        raise IllegalArgumentError(
            f"failed to evaluate minimum_should_match_script: {e}")


class TermsSetQuery(Query):
    """The docs matching at least the required number of `terms` (each a
    `term` query): a field's value, a script's, or 1; scored by the sum of
    their term scores."""

    def __init__(self, field: str, terms: List[Any],
                 minimum_should_match_field: Optional[str] = None,
                 minimum_should_match_script: Optional[dict] = None):
        self.field = field
        self.terms = terms
        self.msm_field = minimum_should_match_field
        self.msm_script = minimum_should_match_script

    def execute(self, ctx: SearchContext) -> DocSet:
        sets = [TermQuery(self.field, t).execute(ctx).with_scores()
                for t in self.terms]
        if not sets or not any(len(s.rows) for s in sets):
            return DocSet.empty()
        all_rows = np.concatenate([s.rows for s in sets])
        rows, inv = np.unique(all_rows, return_inverse=True)
        counts = np.bincount(inv, minlength=len(rows))
        sums = np.bincount(inv, weights=np.concatenate(
            [s.scores for s in sets]).astype(np.float64),
            minlength=len(rows))
        required = np.ones(len(rows))
        if self.msm_field:
            have_rows, vals = _first_numbers(ctx, self.msm_field)
            required[:] = len(self.terms) + 1
            at = np.searchsorted(have_rows, rows)
            found = (at < len(have_rows)) & (
                have_rows[np.minimum(at, len(have_rows) - 1)] == rows) \
                if len(have_rows) else np.zeros(len(rows), dtype=bool)
            required[found] = vals[at[found]]
        elif self.msm_script:
            required[:] = eval_msm_script(self.msm_script.get("source", ""),
                                          len(self.terms))
        keep = counts >= required
        return DocSet(rows[keep], sums[keep].astype(np.float32))

    def to_dict(self):
        return {"terms_set": {self.field: {"terms": self.terms}}}

    def key_is_exact(self) -> bool:
        return not self.msm_field and not self.msm_script


# ------------------------------------------------------ spans and intervals

def _unique_spans(cols: List[np.ndarray]) -> List[np.ndarray]:
    """Columns (rows, start, end[, covered]) sorted by row, then start,
    end and covered, each span once."""
    if not len(cols[0]):
        return [np.zeros(0, dtype=np.int64) for _ in cols]
    order = np.lexsort(tuple(reversed(cols)))
    cols = [c[order].astype(np.int64, copy=False) for c in cols]
    same = np.ones(len(order) - 1, dtype=bool)
    for c in cols:
        same &= c[1:] == c[:-1]
    keep = np.concatenate(([True], ~same))
    return [c[keep] for c in cols]


def _empty_spans(width: int) -> List[np.ndarray]:
    return [np.zeros(0, dtype=np.int64) for _ in range(width)]


def _row_pairs(ra: np.ndarray, rb: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Every (i, j) with ra[i] == rb[j], rb ascending."""
    lo = np.searchsorted(rb, ra, side="left")
    hi = np.searchsorted(rb, ra, side="right")
    return np.repeat(np.arange(len(ra)), hi - lo), _ranges(lo, hi)


def _spans_scored(spans: List[np.ndarray]) -> DocSet:
    """A doc for each row holding spans, scored by their number."""
    rows, counts = np.unique(spans[0], return_counts=True)
    return DocSet(rows.astype(np.int64), counts.astype(np.float32))


def _term_spans(ctx: SearchContext, field: str, term: str
                ) -> List[np.ndarray]:
    """(rows, starts, ends) of every position of `term` in the live docs
    of a text field: the span [p, p + 1)."""
    rows, starts = [], []
    for view in ctx.reader.views:
        seg = view.segment
        fp = seg.postings.get(field)
        p = fp.get(term) if fp is not None else None
        if p is None or p.positions is None:
            continue
        pos, ps = p.positions
        counts = np.diff(ps)
        docs = p.doc_ids.astype(np.int64)
        at = pos[ps[0]:ps[-1]].astype(np.int64)
        if not view.all_live:
            live = np.repeat(view.live[docs], counts)
            at = at[live]
            counts = counts[view.live[docs]]
            docs = docs[view.live[docs]]
        rows.append(np.repeat(docs + seg.base, counts))
        starts.append(at)
    if not rows:
        return _empty_spans(3)
    r, s = np.concatenate(rows), np.concatenate(starts)
    if len(rows) > 1 and np.any(np.diff(r) < 0):
        order = np.argsort(r, kind="stable")
        r, s = r[order], s[order]
    # each posting's positions as the analyzer gave them, rows ascending
    return [r, s, s + 1]


def _union_spans(parts: List[List[np.ndarray]], width: int
                 ) -> List[np.ndarray]:
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return _empty_spans(width)
    return _unique_spans([np.concatenate([p[j] for p in parts])
                          for j in range(width)])


def _term_union(ctx: SearchContext, field: str, terms) -> List[np.ndarray]:
    return _union_spans([_term_spans(ctx, field, t) for t in terms], 3)


def _combine_near(a, b, slop: int, in_order: bool) -> List[np.ndarray]:
    """`span_near` of two span lists: each pair of a row's spans, one from
    each, that do not overlap and leave at most `slop` positions between
    them (with `in_order`, b's starting at or after a's end), as the span
    covering both."""
    i, j = _row_pairs(a[0], b[0])
    s1, e1, s2, e2 = a[1][i], a[2][i], b[1][j], b[2][j]
    if in_order:
        keep = (s2 >= e1) & (s2 - e1 <= slop)
        lo, hi = s1, e2
    else:
        lo, hi = np.minimum(s1, s2), np.maximum(e1, e2)
        gap = hi - lo - (e1 - s1) - (e2 - s2)
        keep = (gap <= slop) & ~((s1 < e2) & (s2 < e1))
    return _unique_spans([a[0][i][keep], lo[keep], hi[keep]])


def _any_pair(n: int, i: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """For each of n spans, whether any of its pairs (index i) hit."""
    out = np.zeros(n, dtype=bool)
    out[i[hit]] = True
    return out


class SpanQuery(Query):
    """`span_term`, `span_near` (`slop`, `in_order`), `span_or`,
    `span_not`, `span_first` and, as a clause, `span_multi` (`prefix`,
    `wildcard`): the span tree evaluated to each row's spans; a doc with
    any matches, scored by their number."""

    def __init__(self, spec_kind: str, spec: dict):
        self.kind = spec_kind
        self.spec = spec

    def _spans_of(self, ctx, clause: dict):
        k, s = next(iter(clause.items()))
        return self._spans(ctx, k, s)

    def _spans(self, ctx: SearchContext, kind: str, spec: dict):
        if kind == "span_term":
            field, v = _single_field(spec)
            term = v.get("value") if isinstance(v, dict) else v
            mapper = ctx.mapper_service.get(field)
            if mapper is not None and hasattr(mapper, "analyze"):
                toks = mapper.analyze(str(term))
                term = toks[0] if toks else str(term)
            return _term_spans(ctx, field, str(term))
        if kind == "span_near":
            clauses = spec.get("clauses", [])
            slop = int(spec.get("slop", 0))
            in_order = bool(spec.get("in_order", True))
            if not clauses:
                return _empty_spans(3)
            acc = self._spans_of(ctx, clauses[0])
            for c in clauses[1:]:
                acc = _combine_near(acc, self._spans_of(ctx, c), slop,
                                    in_order)
            return acc
        if kind == "span_or":
            return _union_spans([self._spans_of(ctx, c)
                                 for c in spec.get("clauses", [])], 3)
        if kind == "span_first":
            inner = self._spans_of(ctx, spec["match"])
            keep = inner[2] <= int(spec.get("end", 1))
            return [c[keep] for c in inner]
        if kind == "span_not":
            inc = self._spans_of(ctx, spec["include"])
            exc = self._spans_of(ctx, spec["exclude"])
            i, j = _row_pairs(inc[0], exc[0])
            overlap = (inc[1][i] < exc[2][j]) & (exc[1][j] < inc[2][i])
            keep = ~_any_pair(len(inc[0]), i, overlap)
            return [c[keep] for c in inc]
        if kind == "span_multi":
            inner = spec.get("match") or {}
            ikind, ispec = (next(iter(inner.items())) if inner
                            else ("match_all", {}))
            if ikind in ("prefix", "wildcard"):
                field, v = _single_field(ispec)
                pat = v.get("value", v.get("prefix", v.get("wildcard"))) \
                    if isinstance(v, dict) else v
                pat = str(pat).lower()
                select = (_prefix_select(pat) if ikind == "prefix" else
                          _regex_select(re.compile(fnmatch.translate(pat))))
                return _term_union(ctx, field,
                                   _pattern_terms(ctx, field, select))
            raise ParsingError(
                f"unsupported span_multi inner query [{ikind}]")
        raise ParsingError(f"unknown span query [{kind}]")

    def execute(self, ctx: SearchContext) -> DocSet:
        return _spans_scored(self._spans(ctx, self.kind, self.spec))

    def to_dict(self):
        return {self.kind: self.spec}


_INTERVAL_FILTERS = ("containing", "not_containing", "contained_by",
                     "not_contained_by", "overlapping", "not_overlapping",
                     "before", "after")


class IntervalsQuery(Query):
    """`intervals` over one text field: `match` (`ordered`, `max_gaps`),
    `all_of`, `any_of`, `prefix`, `wildcard` and `fuzzy` rules, with a
    `filter` (`containing`, `contained_by`, `overlapping`, their `not_`
    forms, `before`, `after`) at any level. A span carries the tokens it
    covers, so `max_gaps` bounds the gaps of the whole combination; a doc
    scores its number of spans."""

    def __init__(self, field: str, rule: dict):
        self.field = field
        self.rule = rule

    def _analyzed_terms(self, ctx, text: str) -> List[str]:
        mapper = ctx.mapper_service.get(self.field)
        if mapper is not None and hasattr(mapper, "search_analyzer"):
            return mapper.search_analyzer.terms(str(text))
        if mapper is not None and hasattr(mapper, "analyze"):
            return mapper.analyze(str(text))
        return str(text).lower().split()

    def _term3(self, ctx, term: str) -> List[np.ndarray]:
        r, s, e = _term_spans(ctx, self.field, term)
        return [r, s, e, e - s]

    def _terms3(self, ctx, terms) -> List[np.ndarray]:
        r, s, e = _term_union(ctx, self.field, terms)
        return [r, s, e, e - s]

    @staticmethod
    def _near3(a, b, max_gaps: int, ordered: bool) -> List[np.ndarray]:
        """Pairs of a row's spans, one from each, that do not overlap (b's
        after a's with `ordered`), whose total gaps stay within
        `max_gaps` (-1: any)."""
        bound = max_gaps if max_gaps >= 0 else 10 ** 9
        i, j = _row_pairs(a[0], b[0])
        s1, e1, c1 = a[1][i], a[2][i], a[3][i]
        s2, e2, c2 = b[1][j], b[2][j], b[3][j]
        keep = ~((s1 < e2) & (s2 < e1))
        if ordered:
            keep &= s2 >= e1
        lo, hi, covered = np.minimum(s1, s2), np.maximum(e1, e2), c1 + c2
        keep &= (hi - lo) - covered <= bound
        return _unique_spans([a[0][i][keep], lo[keep], hi[keep],
                              covered[keep]])

    def _spans_for(self, ctx, rule: dict) -> List[np.ndarray]:
        kind, spec = next(iter(rule.items()))
        spec = spec if isinstance(spec, dict) else {"query": spec}
        filt = spec.get("filter")
        if kind == "match":
            terms = self._analyzed_terms(ctx, spec.get("query", ""))
            ordered = bool(spec.get("ordered", False))
            max_gaps = int(spec.get("max_gaps", -1))
            spans = self._term3(ctx, terms[0]) if terms else _empty_spans(4)
            for t in terms[1:]:
                spans = self._near3(spans, self._term3(ctx, t), max_gaps,
                                    ordered)
        elif kind == "all_of":
            children = [self._spans_for(ctx, r)
                        for r in spec.get("intervals", [])]
            max_gaps = int(spec.get("max_gaps", -1))
            ordered = bool(spec.get("ordered", False))
            spans = children[0] if children else _empty_spans(4)
            for child in children[1:]:
                spans = self._near3(spans, child, max_gaps, ordered)
        elif kind == "any_of":
            spans = _union_spans([self._spans_for(ctx, r)
                                  for r in spec.get("intervals", [])], 4)
        elif kind == "prefix":
            p = str(spec.get("prefix", spec.get("query", ""))).lower()
            spans = self._terms3(ctx, _pattern_terms(
                ctx, self.field, _prefix_select(p)))
        elif kind == "wildcard":
            # only * and ? are special
            pat = str(spec.get("pattern", spec.get("query", ""))).lower()
            spans = self._terms3(ctx, _pattern_terms(
                ctx, self.field, _regex_select(_wildcard_regex(pat))))
        elif kind == "fuzzy":
            term = str(spec.get("term", spec.get("query", ""))).lower()
            fuzz = spec.get("fuzziness", "auto")
            if str(fuzz).lower() == "auto":
                k = 0 if len(term) < 3 else (1 if len(term) < 6 else 2)
            else:
                k = int(fuzz)
            spans = self._terms3(ctx, _fuzzy_terms(ctx, self.field, term, k))
        else:
            raise ParsingError(f"unsupported intervals rule [{kind}]")
        if filt:
            spans = self._apply_filter(ctx, spans, filt)
        return spans

    def _apply_filter(self, ctx, spans, filt: dict) -> List[np.ndarray]:
        if not isinstance(filt, dict) or len(filt) != 1:
            raise ParsingError(
                "intervals [filter] must define exactly one rule")
        ((mode, inner_rule),) = filt.items()
        fs = self._spans_for(ctx, inner_rule)
        if not len(spans[0]):
            return spans
        if mode not in _INTERVAL_FILTERS:
            raise ParsingError(f"unknown intervals filter [{mode}]")
        i, j = _row_pairs(spans[0], fs[0])
        s, e = spans[1][i], spans[2][i]
        fs_s, fs_e = fs[1][j], fs[2][j]
        base = mode[4:] if mode.startswith("not_") else mode
        hit = {"containing": (s <= fs_s) & (fs_e <= e),
               "contained_by": (fs_s <= s) & (e <= fs_e),
               "overlapping": (s < fs_e) & (fs_s < e),
               "before": e <= fs_s,
               "after": s >= fs_e}[base]
        keep = _any_pair(len(spans[0]), i, hit)
        if mode.startswith("not_"):
            keep = ~keep
        return [c[keep] for c in spans]

    def execute(self, ctx: SearchContext) -> DocSet:
        return _spans_scored(self._spans_for(ctx, self.rule))

    def to_dict(self):
        return {"intervals": {self.field: self.rule}}


# ------------------------------------------------------------ pinned, wrapper

class PinnedQuery(Query):
    """The `ids` first, in their order, scored above every organic hit,
    then the organic query's other hits."""

    def __init__(self, ids: List[str], organic: Query):
        self.ids = ids
        self.organic = organic

    def execute(self, ctx: SearchContext) -> DocSet:
        organic = self.organic.execute(ctx).with_scores()
        id_rows = id_row_map(ctx.reader)
        pinned = np.asarray([id_rows[i] for i in self.ids if i in id_rows],
                            dtype=np.int64)
        top = float(organic.scores.max()) if len(organic.scores) else 0.0
        pinned_scores = top + len(pinned) - np.arange(len(pinned)) + 1.0
        rest = ~np.isin(organic.rows, pinned)
        rows = np.concatenate([pinned, organic.rows[rest]])
        scores = np.concatenate([pinned_scores,
                                 organic.scores[rest].astype(np.float64)])
        order = np.argsort(rows, kind="stable")
        return DocSet(rows[order], scores[order].astype(np.float32))

    def to_dict(self):
        return {"pinned": {"ids": self.ids,
                           "organic": self.organic.to_dict()}}

    def key_is_exact(self) -> bool:
        return self.organic.key_is_exact()


def parse_extended(kind: str, spec: Any) -> Optional[Query]:
    """The extended kinds' queries (None for another kind)."""
    if kind == "geo_distance":
        spec = dict(spec)
        distance = parse_distance(spec.pop("distance"))
        spec.pop("distance_type", None)
        spec.pop("validation_method", None)
        field, point = next(iter(spec.items()))
        lat, lon = parse_geo_point(point)
        return GeoDistanceQuery(field, lat, lon, distance)
    if kind == "geo_bounding_box":
        spec = dict(spec)
        spec.pop("validation_method", None)
        field, box = next(iter(spec.items()))
        tl = parse_geo_point(box["top_left"])
        br = parse_geo_point(box["bottom_right"])
        return GeoBoundingBoxQuery(field, tl[0], tl[1], br[0], br[1])
    if kind == "geo_shape":
        spec = dict(spec)
        spec.pop("ignore_unmapped", None)
        field, body = next(iter(spec.items()))
        shape = body.get("shape")
        if shape is None and "indexed_shape" in body:
            raise ParsingError("[geo_shape] indexed_shape is not supported; "
                               "inline the shape")
        return GeoShapeQuery(field, shape,
                             str(body.get("relation", "intersects")).lower())
    if kind == "geo_polygon":
        spec = dict(spec)
        spec.pop("validation_method", None)
        field, poly = next(iter(spec.items()))
        return GeoPolygonQuery(field, [parse_geo_point(p)
                                       for p in poly["points"]])
    if kind == "distance_feature":
        return DistanceFeatureQuery(spec["field"], spec["origin"],
                                    spec["pivot"],
                                    float(spec.get("boost", 1.0)))
    if kind == "more_like_this":
        like = spec.get("like", [])
        unlike = spec.get("unlike", [])
        return MoreLikeThisQuery(
            fields=spec.get("fields", []),
            like=like if isinstance(like, list) else [like],
            min_term_freq=int(spec.get("min_term_freq", 2)),
            min_doc_freq=int(spec.get("min_doc_freq", 5)),
            max_query_terms=int(spec.get("max_query_terms", 25)),
            minimum_should_match=spec.get("minimum_should_match", "30%"),
            include=bool(spec.get("include", False)),
            unlike=unlike if isinstance(unlike, list) else [unlike])
    if kind == "terms_set":
        field, v = _single_field(spec)
        return TermsSetQuery(field, v.get("terms", []),
                             v.get("minimum_should_match_field"),
                             v.get("minimum_should_match_script"))
    if kind in ("span_term", "span_near", "span_or", "span_first",
                "span_not"):
        return SpanQuery(kind, spec)
    if kind == "intervals":
        field, rule = _single_field(spec)
        return IntervalsQuery(field, rule)
    if kind == "wrapper":
        return parse_query(json.loads(base64.b64decode(spec["query"])))
    if kind == "pinned":
        return PinnedQuery([str(i) for i in spec.get("ids", [])],
                           parse_query(spec.get("organic",
                                                {"match_all": {}})))
    if kind == "nested":
        return NestedQuery(spec["path"], spec.get("query", {"match_all": {}}),
                           spec.get("score_mode", "avg"))
    if kind == "has_child":
        return HasChildQuery(spec["type"],
                             parse_query(spec.get("query",
                                                  {"match_all": {}})),
                             spec.get("score_mode", "none"))
    if kind == "has_parent":
        return HasParentQuery(spec["parent_type"],
                              parse_query(spec.get("query",
                                                   {"match_all": {}})),
                              bool(spec.get("score", False)))
    if kind == "parent_id":
        return ParentIdQuery(spec["type"], str(spec["id"]))
    if kind == "percolate":
        docs = spec.get("documents")
        if docs is None:
            docs = [spec["document"]] if "document" in spec else []
        return PercolateQuery(spec["field"], docs)
    return None


# ------------------------------------------------ the source matcher

def _values_at(obj: Any, path: str) -> List[Any]:
    """Every value at a dotted path inside a plain source object (a list
    on the way is walked item by item)."""
    current = [obj]
    for p in path.split("."):
        nxt: List[Any] = []
        for c in current:
            if isinstance(c, dict) and p in c:
                v = c[p]
                if isinstance(v, list):
                    nxt.extend(v)
                else:
                    nxt.append(v)
        current = nxt
    return current


def _number_or_date(val: Any) -> float:
    """A value as `range` reads it in the source matcher: a number, a
    numeric string, else a date string's epoch millis (raises when it is
    none of these)."""
    if not isinstance(val, str):
        return float(val)
    if val.replace(".", "").replace("-", "").isdigit():
        return float(val)
    return parse_date_millis(val)


def _range_bound(bound: Any) -> float:
    if isinstance(bound, str) and not bound.replace(
            ".", "").replace("-", "").isdigit():
        return parse_date_millis(bound)
    return float(bound)


def source_matches(query: dict, source: dict, mapper_service=None) -> bool:
    """A query DSL object evaluated against one plain source object (the
    percolator's one-document index, and each object of a `nested`
    query). Kinds: `match_all`, `match_none`, `bool` (`minimum_should_match`
    an integer), `term`, `terms`, `match` (`operator`), `range` (numbers,
    numeric strings and dates), `exists`, `prefix`, `wildcard`, and `ids`,
    which never matches; any other kind raises. A field's mapper, looked
    up by the name as given, decides how strings compare (`_term_eq`,
    `_analyze`)."""
    if not isinstance(query, dict) or len(query) != 1:
        raise ParsingError("query must have exactly one key")
    kind, spec = next(iter(query.items()))
    if kind == "match_all":
        return True
    if kind == "match_none":
        return False
    if kind == "bool":
        for q in _as_list(spec.get("must")) + _as_list(spec.get("filter")):
            if not source_matches(q, source, mapper_service):
                return False
        for q in _as_list(spec.get("must_not")):
            if source_matches(q, source, mapper_service):
                return False
        should = _as_list(spec.get("should"))
        if should:
            msm = spec.get("minimum_should_match")
            need = int(msm) if msm is not None else (
                1 if not (spec.get("must") or spec.get("filter")) else 0)
            got = sum(1 for q in should
                      if source_matches(q, source, mapper_service))
            return got >= need
        return True
    if kind == "term":
        field, v = _single(spec)
        target = v.get("value") if isinstance(v, dict) else v
        return any(_term_eq(val, target, field, mapper_service)
                   for val in _values_at(source, field))
    if kind == "terms":
        field, targets = _single(spec)
        return any(_term_eq(val, t, field, mapper_service)
                   for val in _values_at(source, field) for t in targets)
    if kind == "match":
        field, v = _single(spec)
        text = v.get("query") if isinstance(v, dict) else v
        operator = v.get("operator", "or") if isinstance(v, dict) else "or"
        tokens = _analyze(field, text, mapper_service)
        doc_tokens: set = set()
        for val in _values_at(source, field):
            if isinstance(val, str):
                doc_tokens.update(_analyze(field, val, mapper_service))
            else:
                doc_tokens.add(str(val).lower())
        hits = [t in doc_tokens for t in tokens]
        return all(hits) if operator == "and" else any(hits)
    if kind == "range":
        field, v = _single(spec)
        for val in _values_at(source, field):
            try:
                x = _number_or_date(val)
            except Exception:
                continue
            ok = True
            if v.get("gte") is not None and not x >= _range_bound(v["gte"]):
                ok = False
            if v.get("gt") is not None and not x > _range_bound(v["gt"]):
                ok = False
            if v.get("lte") is not None and not x <= _range_bound(v["lte"]):
                ok = False
            if v.get("lt") is not None and not x < _range_bound(v["lt"]):
                ok = False
            if ok:
                return True
        return False
    if kind == "exists":
        return len(_values_at(source, spec["field"])) > 0
    if kind == "prefix":
        field, v = _single(spec)
        p = (v.get("value") if isinstance(v, dict) else v) or ""
        return any(isinstance(val, str) and val.lower().startswith(p.lower())
                   for val in _values_at(source, field))
    if kind == "wildcard":
        field, v = _single(spec)
        pat = (v.get("value") or v.get("wildcard")) if isinstance(v, dict) \
            else v
        return any(isinstance(val, str)
                   and fnmatch.fnmatchcase(val.lower(), pat.lower())
                   for val in _values_at(source, field))
    if kind == "ids":
        return False   # a bare source object has no _id
    raise ParsingError(
        f"[{kind}] query is not supported in this context (percolate/nested)")


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _single(spec):
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ParsingError("expected a single-field query object")
    return next(iter(spec.items()))


def _analyze(field: str, text: str, mapper_service) -> List[str]:
    mapper = mapper_service.get(field) if mapper_service else None
    if mapper is not None and hasattr(mapper, "analyze"):
        return mapper.analyze(text)
    return str(text).lower().split()


def _term_eq(doc_val, target, field, mapper_service) -> bool:
    if isinstance(doc_val, str) and isinstance(target, str):
        mapper = mapper_service.get(field) if mapper_service else None
        if mapper is not None and getattr(mapper, "type_name", "") == "text":
            return target in _analyze(field, doc_val, mapper_service)
        return doc_val == target
    if isinstance(doc_val, bool) or isinstance(target, bool):
        return doc_val == target
    try:
        return float(doc_val) == float(target)
    except (TypeError, ValueError):
        return doc_val == target


# ----------------------------------------- the source matcher, vectorized

class _Objects:
    """The objects a `nested` path holds in one segment, flattened: object
    j belongs to local doc `locals_[j]`. Each inner field's values are
    kept the first time a query reads them (`values_of`): value i belongs
    to object `owner[i]`, with its string (for `term`) and its kind;
    the number or date `range` reads of each (NaN where it reads none)
    the first time a `range` asks (`numbers_of`)."""

    __slots__ = ("locals_", "objs", "_fields", "_numbers")

    def __init__(self, locals_: np.ndarray, objs: List[dict]):
        self.locals_ = locals_
        self.objs = objs
        self._fields: Dict[str, tuple] = {}
        self._numbers: Dict[str, np.ndarray] = {}

    def values_of(self, field: str) -> tuple:
        """(owner, values, strings, kinds: 1 a string, 2 a number)."""
        got = self._fields.get(field)
        if got is None:
            owner, vals = [], []
            for j, obj in enumerate(self.objs):
                vs = _values_at(obj, field)
                owner.extend([j] * len(vs))
                vals.extend(vs)
            strs = np.empty(len(vals), dtype=object)
            kinds = np.zeros(len(vals), dtype=np.int8)
            for i, val in enumerate(vals):
                if isinstance(val, str):
                    strs[i], kinds[i] = val, 1
                elif isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    kinds[i] = 2
            got = (np.asarray(owner, dtype=np.int64), vals, strs, kinds)
            self._fields[field] = got
        return got

    def numbers_of(self, field: str) -> np.ndarray:
        got = self._numbers.get(field)
        if got is None:
            vals = self.values_of(field)[1]
            got = np.full(len(vals), np.nan)
            for i, val in enumerate(vals):
                try:
                    got[i] = _number_or_date(val)
                except Exception:
                    pass
            self._numbers[field] = got
        return got


def _leaf_field(spec) -> Optional[Tuple[str, Any]]:
    if not isinstance(spec, dict) or len(spec) != 1:
        return None
    return next(iter(spec.items()))


def _vectorizable(query, mapper_service) -> bool:
    """Whether `_objects_mask` gives exactly what `source_matches` gives
    object by object: a well-formed tree of `match_all`, `match_none`,
    `bool` (an integer `minimum_should_match`), `term` / `terms` whose
    targets are strings or numbers on a field not mapped as text,
    `range` with bounds that convert, `exists` and `ids`. Anything else
    runs the evaluator itself."""
    if not isinstance(query, dict) or len(query) != 1:
        return False
    kind, spec = next(iter(query.items()))
    if kind in ("match_all", "match_none", "ids"):
        return True
    if kind == "bool":
        if not isinstance(spec, dict):
            return False
        msm = spec.get("minimum_should_match")
        if msm is not None and not (isinstance(msm, int)
                                    and not isinstance(msm, bool)):
            return False
        return all(_vectorizable(q, mapper_service)
                   for key in ("must", "filter", "must_not", "should")
                   for q in _as_list(spec.get(key)))
    if kind == "exists":
        return isinstance(spec, dict) and isinstance(spec.get("field"), str)
    leaf = _leaf_field(spec)
    if leaf is None or not isinstance(leaf[0], str):
        return False
    field, v = leaf
    if kind in ("term", "terms"):
        if kind == "term":
            targets = [v.get("value") if isinstance(v, dict) else v]
        elif isinstance(v, (list, tuple)):
            targets = list(v)
        else:
            return False
        mapper = mapper_service.get(field) if mapper_service else None
        if getattr(mapper, "type_name", "") == "text":
            return False
        return all(isinstance(t, str) or (isinstance(t, (int, float))
                                          and not isinstance(t, bool))
                   for t in targets)
    if kind == "range":
        if not isinstance(v, dict):
            return False
        try:
            for b in ("gte", "gt", "lte", "lt"):
                if v.get(b) is not None:
                    _range_bound(v[b])
        except Exception:
            return False
        return True
    return False


def _objects_mask(query: dict, objs: _Objects) -> np.ndarray:
    """`source_matches` of a `_vectorizable` query over every object, as
    a bool array. `term` on a string target matches a string value equal
    to it, and a numeric value when both read as the same number; on a
    numeric target, a number or a numeric string equal to it."""
    n = len(objs.objs)
    kind, spec = next(iter(query.items()))
    if kind == "match_all":
        return np.ones(n, dtype=bool)
    if kind in ("match_none", "ids"):
        return np.zeros(n, dtype=bool)
    if kind == "bool":
        out = np.ones(n, dtype=bool)
        for q in _as_list(spec.get("must")) + _as_list(spec.get("filter")):
            out &= _objects_mask(q, objs)
        for q in _as_list(spec.get("must_not")):
            out &= ~_objects_mask(q, objs)
        should = _as_list(spec.get("should"))
        if should:
            msm = spec.get("minimum_should_match")
            need = int(msm) if msm is not None else (
                1 if not (spec.get("must") or spec.get("filter")) else 0)
            got = np.zeros(n, dtype=np.int64)
            for q in should:
                got += _objects_mask(q, objs)
            out &= got >= need
        return out
    if kind == "exists":
        owner = objs.values_of(spec["field"])[0]
        out = np.zeros(n, dtype=bool)
        out[owner] = True
        return out
    field, v = next(iter(spec.items()))
    owner, vals, strs, kinds = objs.values_of(field)
    if kind == "range":
        nums = objs.numbers_of(field)
        hit = ~np.isnan(nums)
        with np.errstate(invalid="ignore"):
            if v.get("gte") is not None:
                hit &= nums >= _range_bound(v["gte"])
            if v.get("gt") is not None:
                hit &= nums > _range_bound(v["gt"])
            if v.get("lte") is not None:
                hit &= nums <= _range_bound(v["lte"])
            if v.get("lt") is not None:
                hit &= nums < _range_bound(v["lt"])
    else:
        targets = [v.get("value") if isinstance(v, dict) else v] \
            if kind == "term" else list(v)
        hit = np.zeros(len(vals), dtype=bool)
        for t in targets:
            hit |= _term_hits(t, vals, strs, kinds)
    out = np.zeros(n, dtype=bool)
    out[owner[hit]] = True
    return out


def _term_hits(target, vals, strs, kinds) -> np.ndarray:
    """`_term_eq(value, target)` of every value, for a string or numeric
    target on a field not mapped as text."""
    if isinstance(target, str):
        hit = (kinds == 1) & (strs == target)
        try:
            t = float(target)
        except ValueError:
            return hit
        # a number value compares as a number with the string
        other = np.nonzero(kinds != 1)[0]
        for i in other.tolist():
            if not isinstance(vals[i], bool) \
                    and _term_eq(vals[i], target, "", None):
                hit[i] = True
        return hit
    hit = np.zeros(len(vals), dtype=bool)
    t = float(target)
    num = kinds == 2
    with np.errstate(invalid="ignore"):
        hit[num] = np.asarray([float(vals[i]) for i in np.nonzero(num)[0]],
                              dtype=np.float64) == t
    for i in np.nonzero(~num)[0].tolist():
        if _term_eq(vals[i], target, "", None):
            hit[i] = True
    return hit


# ------------------------------------------------------------- nested

def _nested_objects(seg, path: str) -> _Objects:
    """A segment's objects at a `nested` path, read from each document's
    source once and kept with the segment (a key named as the path, else
    the dicts at the dotted path), deleted documents included."""
    key = ("nested", path)
    got = seg.derived.get(key)
    if got is None:
        locals_, objs = [], []
        for local in range(seg.num_docs):
            src = seg.sources[local] or {}
            items = src.get(path)
            if items is None and "." in path:
                items = [v for v in _values_at(src, path)
                         if isinstance(v, dict)]
            if not isinstance(items, list):
                items = [items] if isinstance(items, dict) else []
            for obj in items:
                if isinstance(obj, dict):
                    locals_.append(local)
                    objs.append(obj)
        got = _Objects(np.asarray(locals_, dtype=np.int64), objs)
        seg.derived[key] = got
    return got


class NestedQuery(Query):
    """`nested`: the documents where one object at `path` matches the whole
    inner query, its fields named less the `path.` prefix, by the source
    matcher. Each match scores 1.0, whatever `score_mode` says. A query
    the vectorized matcher covers runs over the segment's objects at once;
    any other runs the matcher object by object."""

    def __init__(self, path: str, query_dict: dict, score_mode: str = "avg"):
        self.path = path
        self.query_dict = query_dict
        self.score_mode = score_mode

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "joining")
        inner = _strip_path_prefix(self.query_dict, self.path)
        fast = _vectorizable(inner, ctx.mapper_service)
        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            objs = _nested_objects(seg, self.path)
            if not len(objs.objs):
                continue
            live = view.live[objs.locals_]
            if fast:
                hit = _objects_mask(inner, objs) & live
            else:
                hit = np.zeros(len(objs.objs), dtype=bool)
                done = np.zeros(seg.num_docs, dtype=bool)
                for j in np.nonzero(live)[0].tolist():
                    local = objs.locals_[j]
                    if not done[local] and source_matches(
                            inner, objs.objs[j], ctx.mapper_service):
                        hit[j] = done[local] = True
            locs = np.unique(objs.locals_[hit])
            parts.append(locs + seg.base)
        rows = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return DocSet(rows, np.ones(len(rows), dtype=np.float32))

    def to_dict(self):
        return {"nested": {"path": self.path, "query": self.query_dict}}


def _strip_path_prefix(query: dict, path: str) -> dict:
    """The query with every `path.field` key renamed `field`."""
    out: Any = json.loads(json.dumps(query))
    prefix = path + "."

    def walk(node):
        if isinstance(node, dict):
            for k in list(node):
                v = node.pop(k)
                node[k[len(prefix):] if k.startswith(prefix) else k] = \
                    walk(v)
            return node
        if isinstance(node, list):
            return [walk(x) for x in node]
        return node
    return walk(out)


# -------------------------------------------------------- parent-join

def _join_mapper(ctx: SearchContext):
    for name, mapper in ctx.mapper_service.all_mappers():
        if getattr(mapper, "type_name", "") == "join":
            return name, mapper
    raise IllegalArgumentError("no [join] field defined in the mapping")


def _join_codes(seg, field: str) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(relation name, parent id, parent id as a string) of each local doc
    of a segment, from its `join` doc value (a list's first value), kept
    with the segment: object arrays, None where the doc holds no {name} /
    no parent, and a str array, "" where the parent is not a string (no
    `_id` is empty)."""
    key = ("join", field)
    got = seg.derived.get(key)
    if got is None:
        names = np.full(seg.num_docs, None, dtype=object)
        parents = np.full(seg.num_docs, None, dtype=object)
        col = seg.doc_values.get(field)
        if col is not None:
            for local in np.nonzero(col.present)[0].tolist():
                jv = col.values[local]
                if isinstance(jv, list):
                    jv = jv[0] if jv else None
                if isinstance(jv, dict):
                    names[local] = jv.get("name")
                    parents[local] = jv.get("parent")
        strs = np.asarray([p if isinstance(p, str) else "" for p in parents],
                          dtype=str)
        got = (names, parents, strs)
        seg.derived[key] = got
    return got


def _is_value(arr: np.ndarray, value) -> np.ndarray:
    """`x == value` of each element of an object array."""
    if isinstance(value, str):
        return np.asarray(arr == value, dtype=bool)
    return np.fromiter((x == value for x in arr), dtype=bool,
                       count=len(arr))


def _row_codes(ctx: SearchContext, field: str, rows: np.ndarray):
    """(relation name, parent id) of global rows."""
    names = np.empty(len(rows), dtype=object)
    parents = np.empty(len(rows), dtype=object)
    if len(rows):
        vi, local = ctx.reader.locate_many(rows)
        for v in np.unique(vi).tolist():
            at = np.nonzero(vi == v)[0]
            n, p, _s = _join_codes(ctx.reader.views[v].segment, field)
            names[at], parents[at] = n[local[at]], p[local[at]]
    return names, parents


def _ones_sorted(rows) -> DocSet:
    rows = np.asarray(sorted(rows), dtype=np.int64)
    return DocSet(rows, np.ones(len(rows), dtype=np.float32))


class HasChildQuery(Query):
    """`has_child`: the parents, found by id in the same reader, of the
    inner query's hits whose relation is `type`. Each scores 1.0."""

    def __init__(self, child_type: str, query: Query,
                 score_mode: str = "none"):
        self.child_type = child_type
        self.query = query
        self.score_mode = score_mode

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "joining")
        join_field, _ = _join_mapper(ctx)
        child_rows = self.query.execute(ctx).rows
        names, parents = _row_codes(ctx, join_field, child_rows)
        id_rows = id_row_map(ctx.reader)
        wanted = _is_value(names, self.child_type)
        return _ones_sorted({id_rows[p] for p in parents[wanted]
                             if p is not None and p in id_rows})

    def to_dict(self):
        return {"has_child": {"type": self.child_type,
                              "query": self.query.to_dict()}}

    def key_is_exact(self) -> bool:
        return self.query.key_is_exact()


class HasParentQuery(Query):
    """`has_parent`: the documents whose parent id is the id of one of the
    inner query's hits with the relation `parent_type`. Each scores
    1.0."""

    def __init__(self, parent_type: str, query: Query, score: bool = False):
        self.parent_type = parent_type
        self.query = query
        self.score = score

    def execute(self, ctx: SearchContext) -> DocSet:
        _check_expensive(ctx, "joining")
        join_field, _ = _join_mapper(ctx)
        parent_rows = self.query.execute(ctx).rows
        names, _p = _row_codes(ctx, join_field, parent_rows)
        parent_ids = np.asarray(sorted({
            ctx.reader.get_id(int(r)) for r in
            parent_rows[_is_value(names, self.parent_type)]}), dtype=str)
        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            strs = _join_codes(seg, join_field)[2]
            hit = np.isin(strs, parent_ids) & view.live
            parts.append(np.nonzero(hit)[0].astype(np.int64) + seg.base)
        return _ones_sorted(np.concatenate(parts) if parts else [])

    def to_dict(self):
        return {"has_parent": {"parent_type": self.parent_type,
                               "query": self.query.to_dict()}}

    def key_is_exact(self) -> bool:
        return self.query.key_is_exact()


class ParentIdQuery(Query):
    """`parent_id`: the documents of relation `type` whose parent is
    `id`."""

    def __init__(self, child_type: str, parent_id: str):
        self.child_type = child_type
        self.parent_id = parent_id

    def execute(self, ctx: SearchContext) -> DocSet:
        join_field, _ = _join_mapper(ctx)
        parts = []
        for view in ctx.reader.views:
            seg = view.segment
            names, parents, _s = _join_codes(seg, join_field)
            hit = _is_value(names, self.child_type) \
                & _is_value(parents, self.parent_id) & view.live
            parts.append(np.nonzero(hit)[0].astype(np.int64) + seg.base)
        return _ones_sorted(np.concatenate(parts) if parts else [])

    def to_dict(self):
        return {"parent_id": {"type": self.child_type, "id": self.parent_id}}


# ----------------------------------------------------------- percolate

class _MemoMapper:
    """A mapper whose `analyze` keeps its answers (analysis is a pure
    function of the text), for one request's source matching."""

    def __init__(self, mapper):
        self._mapper = mapper
        self._memo: Dict[Any, List[str]] = {}
        self.type_name = getattr(mapper, "type_name", "")

    def analyze(self, text):
        try:
            got = self._memo.get(text)
        except TypeError:       # not hashable: analyzed as it comes
            return self._mapper.analyze(text)
        if got is None:
            got = self._memo[text] = self._mapper.analyze(text)
        return got


class _MemoMappers:
    """The mapping as the source matcher reads it (`get`), each mapper
    that analyzes wrapped in `_MemoMapper`: a document's texts are
    analyzed once for all the stored queries that read them."""

    def __init__(self, mapper_service):
        self._ms = mapper_service
        self._mappers: Dict[str, Any] = {}

    def get(self, field: str):
        if field not in self._mappers:
            mapper = self._ms.get(field)
            self._mappers[field] = _MemoMapper(mapper) if hasattr(
                mapper, "analyze") else mapper
        return self._mappers[field]


def _stored_queries(seg, field: str) -> List[Tuple[int, dict]]:
    """A segment's stored queries of a `percolator` field, (local, query),
    read from its column once and kept with the segment."""
    key = ("percolator", field)
    got = seg.derived.get(key)
    if got is None:
        got = []
        col = seg.doc_values.get(field)
        if col is not None:
            for local in np.nonzero(col.present)[0].tolist():
                stored = col.values[local]
                if isinstance(stored, list):
                    stored = stored[0] if stored else None
                if isinstance(stored, dict):
                    got.append((local, stored))
        seg.derived[key] = got
    return got


class PercolateQuery(Query):
    """`percolate`: the stored queries of a `percolator` field that match
    one of the given documents (`document` or `documents`), each by the
    source matcher; a stored query of a kind the matcher does not know is
    skipped. Each match scores 1.0."""

    def __init__(self, field: str, documents: List[dict]):
        self.field = field
        self.documents = documents

    def execute(self, ctx: SearchContext) -> DocSet:
        mappers = _MemoMappers(ctx.mapper_service)
        rows_out = []
        for view in ctx.reader.views:
            seg = view.segment
            for local, stored in _stored_queries(seg, self.field):
                if not view.live[local]:
                    continue
                try:
                    if any(source_matches(stored, doc, mappers)
                           for doc in self.documents):
                        rows_out.append(seg.base + local)
                except ParsingError:
                    continue
        return _ones_sorted(rows_out)

    def to_dict(self):
        return {"percolate": {"field": self.field,
                              "documents": self.documents}}
