"""Field mappers and the index's mapping (port of the served subset of
`elasticsearch_tpu/index/mapping.py`).

`text` takes `analyzer` and `search_analyzer` (the built-in, language and
the index's own `index.analysis.*` analyzers, through the index's
`AnalysisRegistry`); its values index analyzed terms with their positions
and the field's length a document, and it keeps no doc values.

`dense_vector` takes dims, similarity, and `index_options` with `type`
(`flat`, `int8_flat`, `int4_flat`, `ivf`, `int8_ivf`, `int4_ivf`), `nlist`,
`nprobe`, `rescore` and `rescore_oversample`; `rank_vectors` (late
interaction) takes dims, similarity and the token-block storage knobs;
`keyword` (with `ignore_above`), `long`, `integer`, `short`, `byte`,
`double`, `float`, `half_float`, `scaled_float` and `boolean` fields give
each value its index terms (the filter queries' postings) and its doc
value (the range queries' column), coerced and rejected as the reference
does; `ignore_malformed` drops a bad value and records the field in
`_ignored`. `date` (epoch millis: `strict_date_optional_time||
epoch_millis`, date math, `format` with `epoch_second` or a custom
pattern and its `locale`) and `date_nanos` (epoch nanos) index the number
as their term and doc value; `ip` stores an address in the 128-bit IPv6
space (IPv4 as `::ffff:a.b.c.d`); the doc-values columns hold all three
as float64 as the reference's do, so a date_nanos past 2^53 ns and an
IPv6 address lose the same low bits in both. `geo_point` keeps its (lat,
lon) as a doc value, `geo_shape` its parsed shape and bounding envelope
(GeoJSON or WKT), which the geo queries read. The six range types keep
each value as an inclusive interval {gte, lte} that `term` and `range`
(`relation`) scan. `rank_feature` (a positive float,
`positive_score_impact`) keeps its value as a doc value; `rank_features`
and the legacy `sparse_vector` keep a feature -> weight map (an object,
keys as strings, weights coerced with `float`), which `parse_document`
hands to the engine as its keys and weights for the segment's feature-map
column (a list of maps stays a plain doc value, as the reference keeps
it). `_source.enabled` is honoured.

`MapperService` holds the mapping as a flat map of dotted paths: a
definition with `properties` is an object (its `type` is `object` when it
has none), `fields` adds multi-fields that index every value of their
parent, and `dynamic` (a boolean, or the string "true"; any other string,
such as "strict", reads as false, as in the reference) maps a document's
unmapped fields from their first value: boolean, long, float, a
`yyyy-MM-dd` date string as `date`, any other string as `text` with a
`keyword` sub-field at `ignore_above: 256`. An object in a document is
walked by path; an array of objects is flattened into its paths, a
`nested` one too (its objects stay in `_source`, where the `nested` query,
inner hits and aggregation read them), and
`index.mapping.nested_objects.limit` bounds the nested objects of a
document. `join` ({name, parent}), `percolator` (a query, parsed at write
time), `binary`, `search_as_you_type` (with its shingle and prefix
sub-fields), `token_count`, `wildcard`, `constant_keyword`, `murmur3`,
`histogram`, `flattened`, `annotated_text` and `alias` are mapped as the
reference maps them: the port maps every type it registers.
"""

from __future__ import annotations

import base64
import binascii
import calendar
import datetime as _dt
import ipaddress
import math
import re
import threading
import time
import urllib.parse
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.cluster.routing import murmur3_x86_32_many
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, MapperParsingError,
)
from elasticsearch_tpu_torch.index.analysis import AnalysisRegistry, Token

# --------------------------------------------------------------- dates

_DATE_PATTERNS = (
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M:%S.%f",
    "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d", "%Y/%m/%d",
)
_DATE_MATH_TOKEN = re.compile(r"([+\-/])(\d*)([yMwdhHms])")
_ROUND_SPAN_MS = {"s": 1000, "m": 60_000, "h": 3_600_000, "H": 3_600_000,
                  "d": 86_400_000, "w": 7 * 86_400_000}


def _apply_date_math(millis: int, expr: str, round_up: bool = False) -> int:
    """A date-math suffix (`||+1d/d`, `now-1h`): +/- offsets and /unit
    rounding. `round_up` rounds to the end of the unit (gt / lte bounds).
    A malformed expression raises."""
    tokens = _DATE_MATH_TOKEN.findall(expr)
    if "".join(op + num + unit for op, num, unit in tokens) \
            != expr.replace(" ", ""):
        raise MapperParsingError(
            f"failed to parse date math expression [{expr}]")
    for op, num, unit in tokens:
        if op == "/":
            if num:
                raise MapperParsingError(
                    f"rounding does not take a number [{op}{num}{unit}]")
            d = _dt.datetime.fromtimestamp(millis / 1000.0,
                                           tz=_dt.timezone.utc)
            if unit == "d":
                d = d.replace(hour=0, minute=0, second=0, microsecond=0)
            elif unit in ("h", "H"):
                d = d.replace(minute=0, second=0, microsecond=0)
            elif unit == "m":
                d = d.replace(second=0, microsecond=0)
            elif unit == "s":
                d = d.replace(microsecond=0)
            elif unit == "M":
                d = d.replace(day=1, hour=0, minute=0, second=0,
                              microsecond=0)
            elif unit == "y":
                d = d.replace(month=1, day=1, hour=0, minute=0, second=0,
                              microsecond=0)
            elif unit == "w":
                d = (d - _dt.timedelta(days=d.weekday())).replace(
                    hour=0, minute=0, second=0, microsecond=0)
            millis = int(d.timestamp() * 1000)
            if round_up:
                if unit in _ROUND_SPAN_MS:
                    millis += _ROUND_SPAN_MS[unit] - 1
                else:  # a month or year: the next unit's start less 1 ms
                    months = 12 if unit == "y" else 1
                    millis = _shift_months(millis, months) - 1
            continue
        n = int(num or 1)
        if unit in _ROUND_SPAN_MS:
            delta = n * _ROUND_SPAN_MS[unit]
            millis += delta if op == "+" else -delta
        else:  # calendar months and years, the day clamped
            months = n * (12 if unit == "y" else 1)
            millis = _shift_months(millis, months if op == "+" else -months)
    return millis


def _shift_months(millis: int, months: int) -> int:
    d = _dt.datetime.fromtimestamp(millis / 1000.0, tz=_dt.timezone.utc)
    total = d.month - 1 + months
    year = d.year + total // 12
    month = total % 12 + 1
    day = min(d.day, calendar.monthrange(year, month)[1])
    return int(d.replace(year=year, month=month, day=day).timestamp() * 1000)


def parse_date_millis(value: Any, round_up: bool = False) -> int:
    """A date as epoch millis (`strict_date_optional_time||epoch_millis`
    with date math): a number is millis; `now` reads the clock; a
    `yyyy-MM-dd` bound with `round_up` (gt / lte) is the day's last
    millisecond."""
    if isinstance(value, bool):
        raise MapperParsingError(f"cannot parse date from boolean [{value}]")
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if s.startswith("now"):
        return _apply_date_math(int(time.time() * 1000), s[3:], round_up)
    if "||" in s:
        base, _, math_expr = s.partition("||")
        return _apply_date_math(parse_date_millis(base), math_expr, round_up)
    if round_up and re.fullmatch(r"\d{4}-\d{2}-\d{2}", s):
        return parse_date_millis(s) + 86_400_000 - 1
    if re.fullmatch(r"-?\d{5,}", s):
        # epoch_millis takes any numeric string but a bare 4-digit year
        return int(s)
    norm = s.replace("Z", "+0000")
    if re.search(r"[+-]\d{2}:\d{2}$", norm):
        norm = norm[:-3] + norm[-2:]
    for pat in _DATE_PATTERNS:
        try:
            dt = _dt.datetime.strptime(norm, pat)
        except ValueError:
            continue
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        return int(dt.timestamp() * 1000)
    raise MapperParsingError(f"failed to parse date field [{value}]")


# localized day and month names, read as English before strptime
_LOCALE_NAMES = {
    "de": {"Mo": "Mon", "Di": "Tue", "Mi": "Wed", "Do": "Thu", "Fr": "Fri",
           "Sa": "Sat", "So": "Sun",
           "Jan": "Jan", "Feb": "Feb", "Mär": "Mar", "Mrz": "Mar",
           "Apr": "Apr", "Mai": "May", "Jun": "Jun", "Jul": "Jul",
           "Aug": "Aug", "Sep": "Sep", "Okt": "Oct", "Nov": "Nov",
           "Dez": "Dec"},
}


def parse_custom_date(value: str, fmt: str, locale: str = "") -> int:
    """Epoch millis of a date under a joda-style pattern (`E, d MMM yyyy
    HH:mm:ss Z`), day and month names read in the mapping's locale."""
    s = str(value).strip()
    names = _LOCALE_NAMES.get(str(locale or "").split("_")[0].lower())
    if names:
        for loc, eng in names.items():
            s = re.sub(rf"\b{loc}\b", eng, s)
    py = fmt
    for joda, strp in (("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"),
                       ("MMM", "%b"), ("MM", "%m"), ("dd", "%d"),
                       ("EEEE", "%A"), ("E", "%a"), ("HH", "%H"),
                       ("mm", "%M"), ("ss", "%S"), ("Z", "%z")):
        py = py.replace(joda, strp)
    py = re.sub(r"(?<!%)\bd\b", "%d", py)
    py = re.sub(r"(?<!%)\bM\b", "%m", py)
    d = _dt.datetime.strptime(s, py)
    if d.tzinfo is None:
        d = d.replace(tzinfo=_dt.timezone.utc)
    return int(d.timestamp() * 1000)


def parse_date_nanos(value: Any) -> int:
    """A date as epoch nanos: a number is epoch millis; a string keeps up
    to 9 fraction digits."""
    if isinstance(value, bool):
        raise MapperParsingError(f"cannot parse date from boolean [{value}]")
    if isinstance(value, (int, float)):
        return int(value) * 1_000_000
    s = str(value).strip()
    if re.fullmatch(r"-?\d{10,}", s):
        return int(s) * 1_000_000
    m = re.match(r"^(.*?)(?:\.(\d{1,9}))?((?:Z|[+-]\d{2}:?\d{2})?)$", s)
    base, frac, tz = m.groups()
    millis = parse_date_millis(base + (tz or ""))
    return millis * 1_000_000 + int((frac or "0").ljust(9, "0")[:9])


# ------------------------------------------------------------- mappers

class FieldMapper:
    type_name = "base"

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = dict(params or {})

    def index_terms(self, value: Any) -> List[str]:
        """The value's terms in the field's postings; none by default."""
        return []

    def doc_value(self, value: Any) -> Any:
        """The value's doc-values form, or None (no column)."""
        return None

    def to_def(self) -> dict:
        """The definition `GET /_mapping` renders: the type, then the
        parameters as given."""
        return {"type": self.type_name, **self.params}


class KeywordFieldMapper(FieldMapper):
    type_name = "keyword"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.ignore_above = self.params.get("ignore_above")

    def index_terms(self, value):
        s = str(value)
        if self.ignore_above is not None and len(s) > self.ignore_above:
            return []
        return [s]

    def doc_value(self, value):
        return str(value)


class TextFieldMapper(FieldMapper):
    type_name = "text"

    def __init__(self, name, params=None,
                 registry: Optional[AnalysisRegistry] = None):
        super().__init__(name, params)
        if registry is None:
            from elasticsearch_tpu_torch.index import analysis
            registry = analysis.DEFAULT_REGISTRY
        self.analyzer = registry.get(self.params.get("analyzer", "standard"))
        self.search_analyzer = registry.get(self.params.get(
            "search_analyzer", self.params.get("analyzer", "standard")))

    def analyze(self, value) -> List[str]:
        return self.analyzer.terms(str(value))

    def analyze_positions(self, value):
        return self.analyzer.analyze(str(value))

    def index_terms(self, value):
        return self.analyze(value)


class _NumericMapper(FieldMapper):
    py_type = float

    def coerce(self, value: Any):
        if isinstance(value, bool):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}]: boolean")
        try:
            v = self.py_type(value)
        except (TypeError, ValueError):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}] value [{value}]")
        if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
            raise MapperParsingError(
                f"[{self.name}] non-finite value [{value}]")
        return v

    def index_terms(self, value):
        return [repr(self.coerce(value))]

    def doc_value(self, value):
        return self.coerce(value)


class LongFieldMapper(_NumericMapper):
    type_name = "long"
    py_type = int


class IntegerFieldMapper(LongFieldMapper):
    type_name = "integer"


class ShortFieldMapper(LongFieldMapper):
    type_name = "short"


class ByteFieldMapper(LongFieldMapper):
    type_name = "byte"


class DoubleFieldMapper(_NumericMapper):
    type_name = "double"
    py_type = float


class FloatFieldMapper(DoubleFieldMapper):
    type_name = "float"


class HalfFloatFieldMapper(DoubleFieldMapper):
    type_name = "half_float"


class ScaledFloatFieldMapper(_NumericMapper):
    type_name = "scaled_float"
    py_type = float

    def doc_value(self, value):
        factor = self.params.get("scaling_factor", 100)
        return round(self.coerce(value) * factor) / factor


class BooleanFieldMapper(FieldMapper):
    type_name = "boolean"

    def coerce(self, value):
        if isinstance(value, bool):
            return value
        if value in ("true", "True"):
            return True
        if value in ("false", "False", ""):
            return False
        raise MapperParsingError(
            f"failed to parse boolean field [{self.name}] value [{value}]")

    def index_terms(self, value):
        return ["T" if self.coerce(value) else "F"]

    def doc_value(self, value):
        return self.coerce(value)


class DateFieldMapper(FieldMapper):
    """`date`: epoch millis. `format` with `epoch_second` scales a number
    by 1,000; a custom pattern with day or month names (`E`, `MMM`)
    parses in the mapping's `locale`; anything else takes
    `strict_date_optional_time||epoch_millis`."""

    type_name = "date"

    def _parse(self, value):
        fmt = str(self.params.get("format", ""))
        if "epoch_second" in fmt:
            try:
                return int(float(value) * 1000)
            except (TypeError, ValueError):
                pass
        if isinstance(value, str) and fmt and ("E" in fmt or "MMM" in fmt):
            try:
                return parse_custom_date(value, fmt,
                                         self.params.get("locale", ""))
            except (ValueError, MapperParsingError):
                pass
        return parse_date_millis(value)

    def index_terms(self, value):
        return [str(self._parse(value))]

    def doc_value(self, value):
        return self._parse(value)


class DateNanosFieldMapper(DateFieldMapper):
    """`date_nanos`: epoch nanos, from 1970 to 2262-04-11 (int64)."""

    type_name = "date_nanos"

    def index_terms(self, value):
        return [str(parse_date_nanos(value))]

    def doc_value(self, value):
        nanos = parse_date_nanos(value)
        if nanos < 0:
            raise MapperParsingError(
                f"failed to parse field [{self.name}]",
                caused_by={"reason": f"date[{value}] is before the epoch in "
                           "1970 and cannot be stored in nanosecond "
                           "resolution"})
        if nanos > 9223372036854775807:
            raise MapperParsingError(
                f"failed to parse field [{self.name}]",
                caused_by={"reason": f"date[{value}] is after "
                           "2262-04-11T23:47:16.854775807 and cannot be "
                           "stored in nanosecond resolution"})
        return nanos


class IpFieldMapper(FieldMapper):
    type_name = "ip"

    @staticmethod
    def parse_ip(value) -> int:
        """An address as an integer of the 128-bit IPv6 space, IPv4 as
        ::ffff:a.b.c.d, so `::1` and `0.0.0.1` stay apart. Doc values and
        query bounds both go through this one transform."""
        ip = ipaddress.ip_address(str(value))
        if isinstance(ip, ipaddress.IPv4Address):
            ip = ipaddress.IPv6Address(b"\x00" * 10 + b"\xff\xff" + ip.packed)
        return int(ip)

    def coerce(self, value) -> int:
        try:
            return self.parse_ip(value)
        except ValueError:
            raise MapperParsingError(
                f"failed to parse IP [{value}] for field [{self.name}]")

    @staticmethod
    def format_value(stored: int) -> str:
        """The address a stored integer names (IPv4 in dotted form)."""
        v = int(stored)
        if 0xFFFF_0000_0000 <= v <= 0xFFFF_FFFF_FFFF:
            return f"{v >> 24 & 255}.{v >> 16 & 255}.{v >> 8 & 255}.{v & 255}"
        addr = ipaddress.IPv6Address(v)
        return str(addr.ipv4_mapped or addr)

    def index_terms(self, value):
        return [str(self.coerce(value))]

    def doc_value(self, value):
        return self.coerce(value)


def _geohash_decode(gh: str) -> Tuple[float, float]:
    """A geohash's cell centre as (lat, lon)."""
    bits = "0123456789bcdefghjkmnpqrstuvwxyz"
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for ch in gh:
        cd = bits.index(ch)
        for mask in (16, 8, 4, 2, 1):
            if even:
                mid = (lon_lo + lon_hi) / 2
                if cd & mask:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if cd & mask:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return ((lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2)


class GeoPointFieldMapper(FieldMapper):
    """`geo_point`: a {lat, lon} object, a [lon, lat] array, a "lat,lon"
    string or a geohash, kept as its (lat, lon) doc value."""

    type_name = "geo_point"

    def coerce(self, value) -> Tuple[float, float]:
        if isinstance(value, dict):
            try:
                return float(value["lat"]), float(value["lon"])
            except (KeyError, TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse geo_point [{value}]")
        if isinstance(value, (list, tuple)) and len(value) == 2:
            return float(value[1]), float(value[0])
        if isinstance(value, str):
            parts = value.split(",")
            if len(parts) == 2:
                return float(parts[0]), float(parts[1])
            if re.fullmatch(r"[0123456789bcdefghjkmnpqrstuvwxyz]{1,12}",
                            value.lower()):
                return _geohash_decode(value.lower())
        raise MapperParsingError(f"failed to parse geo_point [{value}]")

    def doc_value(self, value):
        return self.coerce(value)


class GeoShapeFieldMapper(FieldMapper):
    """`geo_shape`: a GeoJSON geometry (a `geometrycollection` of them) or
    a WKT string (`parse_wkt`), kept as {shape, envelope}: the shape as
    parsed and its bounding envelope (`shape_envelope`), which the
    `geo_shape` query relates, as the reference does."""

    type_name = "geo_shape"

    def coerce(self, value) -> dict:
        shape = self._parse_shape(value)
        return {"shape": shape, "envelope": shape_envelope(shape)}

    def _parse_shape(self, value) -> dict:
        if isinstance(value, dict) and "type" in value:
            t = str(value["type"]).lower()
            if t == "geometrycollection":
                return {"type": "geometrycollection",
                        "geometries": [self._parse_shape(g) for g in
                                       value.get("geometries", [])]}
            if "coordinates" not in value:
                raise MapperParsingError(
                    f"[{self.name}] geo_shape requires [coordinates]")
            return {"type": t, "coordinates": value["coordinates"]}
        if isinstance(value, str):
            return parse_wkt(value, self.name)
        raise MapperParsingError(
            f"[{self.name}] failed to parse geo_shape value [{value}]")

    def doc_value(self, value):
        return self.coerce(value)


def shape_envelope(shape: dict) -> Tuple[float, float, float, float]:
    """(min_lon, min_lat, max_lon, max_lat) of a parsed shape."""
    if shape["type"] == "geometrycollection":
        envs = [shape_envelope(g) for g in shape["geometries"]]
        return (min(e[0] for e in envs), min(e[1] for e in envs),
                max(e[2] for e in envs), max(e[3] for e in envs))
    coords = shape["coordinates"]
    if shape["type"] == "envelope":
        # [[min_lon, max_lat], [max_lon, min_lat]], the envelope's order
        (min_lon, max_lat), (max_lon, min_lat) = coords
        return (float(min_lon), float(min_lat), float(max_lon),
                float(max_lat))
    pts = list(_iter_positions(coords))
    if not pts:
        raise MapperParsingError("geo_shape has no coordinates")
    lons = [p[0] for p in pts]
    lats = [p[1] for p in pts]
    return (min(lons), min(lats), max(lons), max(lats))


def _iter_positions(coords):
    """Every (lon, lat) position of nested coordinate arrays."""
    if isinstance(coords, (list, tuple)):
        if len(coords) >= 2 and all(
                isinstance(c, (int, float)) for c in coords[:2]):
            yield float(coords[0]), float(coords[1])
        else:
            for c in coords:
                yield from _iter_positions(c)


def parse_wkt(s: str, field: str = "") -> dict:
    """WKT `POINT`, `ENVELOPE` (min_lon, max_lon, max_lat, min_lat),
    `LINESTRING` and `POLYGON` as a parsed shape."""
    m = re.match(r"\s*(\w+)\s*\((.*)\)\s*$", s, re.DOTALL)
    if not m:
        raise MapperParsingError(f"[{field}] failed to parse WKT [{s}]")
    kind = m.group(1).upper()
    body = m.group(2)

    def pts(text):
        out = []
        for pair in text.split(","):
            xy = pair.split()
            out.append([float(xy[0]), float(xy[1])])
        return out

    if kind == "POINT":
        return {"type": "point", "coordinates": pts(body)[0]}
    if kind == "ENVELOPE":
        v = [float(x) for x in body.split(",")]
        return {"type": "envelope",
                "coordinates": [[v[0], v[2]], [v[1], v[3]]]}
    if kind == "LINESTRING":
        return {"type": "linestring", "coordinates": pts(body)}
    if kind == "POLYGON":
        rings = re.findall(r"\(([^()]*)\)", body)
        return {"type": "polygon", "coordinates": [pts(r) for r in rings]}
    raise MapperParsingError(f"[{field}] unsupported WKT type [{kind}]")


class ObjectMapper(FieldMapper):
    """`object`: a path whose properties are fields of their own; it
    indexes nothing itself."""

    type_name = "object"


class RangeFieldMapperBase(FieldMapper):
    """The range types: a value is an object of gt / gte / lt / lte
    bounds, kept as the inclusive interval {gte, lte} (an exclusive bound
    moves by 1 on the discrete types, by one float step on the others),
    which `term` (membership) and `range` (`relation`) scan."""

    discrete = True

    def _bound(self, value) -> float:
        return float(value)

    def coerce(self, value) -> dict:
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"[{self.name}] range field value must be an object of "
                "bounds")
        lo, hi = -math.inf, math.inf
        for k, v in value.items():
            if k == "gte":
                lo = self._bound(v)
            elif k == "gt":
                b = self._bound(v)
                lo = b + 1 if self.discrete \
                    else float(np.nextafter(b, math.inf))
            elif k == "lte":
                hi = self._bound(v)
            elif k == "lt":
                b = self._bound(v)
                hi = b - 1 if self.discrete \
                    else float(np.nextafter(b, -math.inf))
            else:
                raise MapperParsingError(
                    f"[{self.name}] unknown range bound [{k}]")
        if lo > hi:
            raise MapperParsingError(
                f"[{self.name}] range lower bound greater than upper bound")
        return {"gte": lo, "lte": hi}

    def doc_value(self, value):
        return self.coerce(value)

    def query_bound(self, value, round_up: bool = False) -> float:
        """A query's bound in the stored unit; `round_up` matters for
        date ranges only (date-math rounding)."""
        return self._bound(value)


class IntegerRangeFieldMapper(RangeFieldMapperBase):
    type_name = "integer_range"

    def _bound(self, value):
        return float(int(value))


class LongRangeFieldMapper(IntegerRangeFieldMapper):
    type_name = "long_range"


class FloatRangeFieldMapper(RangeFieldMapperBase):
    type_name = "float_range"
    discrete = False


class DoubleRangeFieldMapper(FloatRangeFieldMapper):
    type_name = "double_range"


class DateRangeFieldMapper(RangeFieldMapperBase):
    type_name = "date_range"

    def _bound(self, value):
        return float(parse_date_millis(value))

    def query_bound(self, value, round_up: bool = False) -> float:
        return float(parse_date_millis(value, round_up=round_up))


class IpRangeFieldMapper(RangeFieldMapperBase):
    """`ip_range`: bounds as plain address integers (IPv4 not moved into
    the ::ffff: space, unlike `ip`, as in the reference), or a CIDR
    string."""

    type_name = "ip_range"

    def _bound(self, value):
        return float(int(ipaddress.ip_address(str(value))))

    def coerce(self, value):
        if isinstance(value, str):
            try:
                net = ipaddress.ip_network(value, strict=False)
            except ValueError:
                raise MapperParsingError(
                    f"[{self.name}] failed to parse ip range [{value}]")
            return {"gte": float(int(net.network_address)),
                    "lte": float(int(net.broadcast_address))}
        return super().coerce(value)


class RankFeatureFieldMapper(FieldMapper):
    """`rank_feature`: a positive float consumed by `rank_feature`
    queries; negative values are refused unless `positive_score_impact`
    is false."""

    type_name = "rank_feature"

    def coerce(self, value) -> float:
        v = float(value)
        if v < 0 and self.params.get("positive_score_impact", True) \
                is not False:
            raise MapperParsingError(
                f"[{self.name}] rank_feature fields only support positive "
                f"values, got [{value}]")
        return v

    def doc_value(self, value):
        return self.coerce(value)


class RankFeaturesFieldMapper(FieldMapper):
    """`rank_features`: a sparse map feature -> weight (the learned-sparse
    field `ops/sparse.py` scores)."""

    type_name = "rank_features"

    def coerce(self, value) -> dict:
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"[{self.name}] {self.type_name} value must be an object")
        return {str(k): float(v) for k, v in value.items()}

    def doc_value(self, value):
        return self.coerce(value)


class SparseVectorFieldMapper(RankFeaturesFieldMapper):
    """`sparse_vector` (the legacy map type): a map dimension -> weight,
    stored and scored as `rank_features` is."""

    type_name = "sparse_vector"


class DenseVectorFieldMapper(FieldMapper):
    """`dense_vector`: dims (required), similarity (cosine|dot_product|
    l2_norm|max_inner_product, default cosine), index_options.type — the
    quantization-ladder rung (flat = the store's bf16, int8_flat, int4_flat
    packed nibbles) on the exhaustive engine, or the same rung on the
    partitioned `tpu_ivf` engine (ivf, int8_ivf, int4_ivf), overriding
    `index.knn.engine`; index_options.nlist / nprobe (per-field IVF
    overrides); index_options.rescore (int8: keep the residual level and
    re-rank the kernel's top candidates; int4, on by default: exact f32
    rescore of the coarse window) and rescore_oversample (sizes those
    windows). The binary rungs are not ported."""

    type_name = "dense_vector"

    INDEX_OPTIONS_TYPES = ("flat", "int8_flat", "int4_flat",
                           "ivf", "int8_ivf", "int4_ivf")

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.dims = self.params.get("dims")
        if self.dims is None:
            raise MapperParsingError(f"[{name}] dense_vector requires [dims]")
        self.dims = int(self.dims)
        self.similarity = self.params.get("similarity", "cosine")
        if self.similarity not in ("cosine", "dot_product", "l2_norm",
                                   "max_inner_product"):
            raise MapperParsingError(
                f"[{name}] unknown similarity [{self.similarity}]")
        opts = self.params.get("index_options") or {}
        otype = opts.get("type")
        if otype is not None and otype not in self.INDEX_OPTIONS_TYPES:
            raise MapperParsingError(
                f"[{name}] unknown index_options type [{otype}]; expected "
                f"one of {list(self.INDEX_OPTIONS_TYPES)}")
        # the packed rung's bit layout needs even dims: reject at mapping
        # time, not at first refresh
        if otype in ("int4_flat", "int4_ivf") and self.dims % 2:
            raise MapperParsingError(
                f"[{name}] index_options type [{otype}] requires even "
                f"[dims], got [{self.dims}]")
        for opt_key in ("nlist", "nprobe", "rescore_oversample"):
            v = opts.get(opt_key)
            if v is None or (opt_key == "nprobe" and v == "auto"):
                continue  # "auto" is meaningful only for nprobe
            try:
                ok = int(v) >= 1
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise MapperParsingError(
                    f"[{name}] index_options [{opt_key}] must be an "
                    f"integer >= 1, got [{v}]")

    def coerce(self, value) -> np.ndarray:
        if isinstance(value, np.ndarray):
            arr = value.astype(np.float32, copy=False)
        elif isinstance(value, (list, tuple)):
            arr = np.asarray(value, dtype=np.float32)
        else:
            raise MapperParsingError(
                f"[{self.name}] dense_vector value must be an array")
        if arr.ndim != 1 or arr.shape[0] != self.dims:
            raise MapperParsingError(
                f"[{self.name}] vector has "
                f"[{arr.shape[0] if arr.ndim == 1 else '?'}] "
                f"dimensions, mapping requires [{self.dims}]")
        if not np.isfinite(arr).all():
            raise MapperParsingError(
                f"[{self.name}] vector contains non-finite values")
        return arr


class RankVectorsFieldMapper(FieldMapper):
    """`rank_vectors` (the late-interaction field): each doc holds a ragged
    list of token vectors, scored by MaxSim against a multi-token query.

    params: dims (required), similarity (cosine|dot_product, default
    cosine), index_options.encoding — the token-block storage rung
    (f32|bf16|int8|int4, default int8), index_options.oversample — the
    coarse pooled-centroid window multiplier (default 4),
    index_options.coarse — storage rung of the pooled centroid matrix
    (f32|bf16|int8|int4, default f32; `binary` is not ported). Each is read
    from `index_options` or from the top level."""

    type_name = "rank_vectors"

    ENCODINGS = ("f32", "bf16", "int8", "int4")
    COARSE = ("f32", "bf16", "int8", "int4", "binary")

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.dims = self.params.get("dims")
        if self.dims is None:
            raise MapperParsingError(f"[{name}] rank_vectors requires [dims]")
        self.dims = int(self.dims)
        self.similarity = self.params.get("similarity", "cosine")
        if self.similarity not in ("cosine", "dot_product"):
            raise MapperParsingError(
                f"[{name}] unknown similarity [{self.similarity}] for "
                "rank_vectors; expected cosine or dot_product")
        opts = self.params.get("index_options") or {}
        self.encoding = opts.get("encoding",
                                 self.params.get("encoding", "int8"))
        if self.encoding not in self.ENCODINGS:
            raise MapperParsingError(
                f"[{name}] unknown index_options encoding "
                f"[{self.encoding}]; expected one of {list(self.ENCODINGS)}")
        if self.encoding == "int4" and self.dims % 2:
            raise MapperParsingError(
                f"[{name}] index_options encoding [int4] requires even "
                f"[dims], got [{self.dims}]")
        self.coarse = opts.get("coarse", self.params.get("coarse", "f32"))
        if self.coarse not in self.COARSE:
            raise MapperParsingError(
                f"[{name}] unknown index_options coarse [{self.coarse}]; "
                f"expected one of {list(self.COARSE)}")
        if self.coarse == "binary":
            raise MapperParsingError(
                f"[{name}] index_options coarse [binary] is not supported "
                "by this build: the binary rung is not ported")
        oversample = opts.get("oversample",
                              self.params.get("oversample", 4))
        try:
            ok = int(oversample) >= 1
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise MapperParsingError(
                f"[{name}] index_options [oversample] must be an integer "
                f">= 1, got [{oversample}]")
        self.oversample = int(oversample)

    def coerce(self, value) -> np.ndarray:
        if not isinstance(value, (list, tuple)) or not value:
            raise MapperParsingError(
                f"[{self.name}] rank_vectors value must be a non-empty "
                "array of vectors")
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.ndim != 2 or arr.shape[1] != self.dims:
            raise MapperParsingError(
                f"[{self.name}] rank_vectors rows must have [{self.dims}] "
                "dimensions")
        if not np.isfinite(arr).all():
            raise MapperParsingError(
                f"[{self.name}] rank_vectors contains non-finite values")
        return arr


class CompletionFieldMapper(FieldMapper):
    """`completion`: a string, a list of strings or an object of `input`
    (one or several), `weight` and `contexts`. The inputs index as exact
    terms; the doc value keeps {input, weight, contexts}, which the
    completion suggester (`search/extras.py`) reads. A field with
    contexts defined needs them in the value unless each reads a
    document path."""

    type_name = "completion"

    def _inputs(self, value) -> Tuple[List[str], int, dict]:
        if isinstance(value, str):
            return [value], 1, {}
        if isinstance(value, list):
            return [str(v) for v in value], 1, {}
        if isinstance(value, dict):
            inp = value.get("input", [])
            inputs = [inp] if isinstance(inp, str) else [str(v) for v in inp]
            return (inputs, int(value.get("weight", 1)),
                    value.get("contexts") or {})
        raise MapperParsingError(
            f"[{self.name}] completion value must be string, array or "
            f"object")

    def index_terms(self, value):
        return self._inputs(value)[0]

    def doc_value(self, value):
        inputs, weight, contexts = self._inputs(value)
        defs = self.params.get("contexts") or []
        needs = [d for d in defs if not d.get("path")]
        if needs and not contexts:
            raise MapperParsingError(
                f"Contexts are mandatory in context enabled completion "
                f"field [{self.name}]")
        return {"input": inputs, "weight": weight, "contexts": contexts}


class NestedMapper(FieldMapper):
    """`nested`: an object (or an array of objects) whose objects are
    documents of their own to the `nested` query, inner hits and the
    `nested` aggregation. Its fields are mapped by path as an object's
    are, and a document keeps its objects flattened into those paths, as
    the reference keeps them."""

    type_name = "nested"


class JoinFieldMapper(FieldMapper):
    """`join`: `relations` maps a parent name to its children. A value is
    a relation name or {name, parent}; the name indexes as a term and the
    value stays as the doc value the parent-join queries read."""

    type_name = "join"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.relations: Dict[str, List[str]] = {}
        for parent, children in (self.params.get("relations") or {}).items():
            self.relations[parent] = (children if isinstance(children, list)
                                      else [children])

    def coerce(self, value):
        if isinstance(value, str):
            return {"name": value}
        if isinstance(value, dict) and "name" in value:
            return value
        raise MapperParsingError(f"[{self.name}] join value must be a "
                                 f"relation name or {{name, parent}}")

    def index_terms(self, value):
        return [self.coerce(value)["name"]]

    def doc_value(self, value):
        return self.coerce(value)


class PercolatorFieldMapper(FieldMapper):
    """`percolator`: a stored query, parsed when the document is written
    (a query that does not parse fails the document) and kept as its doc
    value for the `percolate` query."""

    type_name = "percolator"

    def coerce(self, value):
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"[{self.name}] percolator field must hold a query object")
        from elasticsearch_tpu_torch.search.queries import parse_query
        parse_query(value)
        return value

    def doc_value(self, value):
        return self.coerce(value)


class BinaryFieldMapper(FieldMapper):
    """`binary`: a base64 string, checked, kept as a doc value (unless
    `doc_values: false`) and never searchable."""

    type_name = "binary"

    def coerce(self, value) -> str:
        s = str(value)
        try:
            base64.b64decode(s, validate=True)
        except (binascii.Error, ValueError):
            raise MapperParsingError(
                f"[{self.name}] failed to parse base64 binary value")
        return s

    def doc_value(self, value):
        return self.coerce(value) if self.params.get("doc_values", True) \
            else None


class _ShingleAnalyzer:
    """Word shingles of size n over a base analyzer's terms (the index
    and search side of the `search_as_you_type` shingle sub-fields)."""

    def __init__(self, base, n: int):
        self.base = base
        self.n = n

    def terms(self, text: str) -> List[str]:
        base = self.base.terms(text)
        return [" ".join(base[i:i + self.n])
                for i in range(len(base) - self.n + 1)]

    def analyze(self, text: str):
        return [Token(t, i, 0, 0) for i, t in enumerate(self.terms(text))]


class _ShingleTextMapper(TextFieldMapper):
    """A `search_as_you_type` sub-field of word shingles of size n."""

    type_name = "text"

    def __init__(self, name, params=None, shingle_size=2):
        super().__init__(name, params)
        self.shingle_size = shingle_size
        self.analyzer = _ShingleAnalyzer(self.analyzer, shingle_size)
        self.search_analyzer = _ShingleAnalyzer(self.search_analyzer,
                                                shingle_size)


class _PrefixTextMapper(TextFieldMapper):
    """The `search_as_you_type` `._index_prefix` sub-field: the edge
    n-grams (1 to 19 characters) of the 1-, 2- and 3-word shingles."""

    type_name = "text"

    def analyze(self, value):
        base = super().analyze(value)
        out = []
        for n in (1, 2, 3):
            for i in range(max(0, len(base) - n + 1)):
                shingle = " ".join(base[i:i + n])
                out.extend(shingle[:j]
                           for j in range(1, min(len(shingle), 19) + 1))
        return sorted(set(out))

    def analyze_positions(self, value):
        return [Token(t, i, 0, 0) for i, t in enumerate(self.analyze(value))]


class SearchAsYouTypeFieldMapper(TextFieldMapper):
    """`search_as_you_type`: a text field; the mapping adds its `._2gram`
    and `._3gram` shingle sub-fields and its `._index_prefix` edge n-gram
    sub-field, which `multi_match` `bool_prefix` reads."""

    type_name = "search_as_you_type"


class TokenCountFieldMapper(FieldMapper):
    """`token_count`: the number of tokens the field's `analyzer` makes
    of a value, indexed as a number; an integer value is the count."""

    type_name = "token_count"

    def __init__(self, name, params=None,
                 registry: Optional[AnalysisRegistry] = None):
        super().__init__(name, params)
        if registry is None:
            from elasticsearch_tpu_torch.index import analysis
            registry = analysis.DEFAULT_REGISTRY
        self.analyzer = registry.get(self.params.get("analyzer", "standard"))

    def count(self, value) -> int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        return len(self.analyzer.terms(str(value)))

    def index_terms(self, value):
        return [repr(self.count(value))]

    def doc_value(self, value):
        return self.count(value)


class WildcardFieldMapper(KeywordFieldMapper):
    """`wildcard`: indexed as `keyword`."""

    type_name = "wildcard"


class ConstantKeywordFieldMapper(FieldMapper):
    """`constant_keyword`: one value for every document of the index. The
    first value written sets the mapping's `value` (under the mapping's
    lock, `MapperService._fix_constant`) unless the mapping gave it; a
    value that differs is a mapper-parsing error. A query-side value never
    sets it."""

    type_name = "constant_keyword"

    def coerce(self, value) -> str:
        s = str(value)
        const = self.params.get("value")
        if const is not None and s != const:
            raise MapperParsingError(
                f"[{self.name}] constant_keyword field is already set to "
                f"[{const}], cannot index [{s}]")
        return s

    def index_terms(self, value):
        return [self.coerce(value)]

    def doc_value(self, value):
        return self.coerce(value)


class Murmur3FieldMapper(FieldMapper):
    """`murmur3`: the value's murmur3 hash (seed 0 over its UTF-8 bytes)
    as a signed 32-bit doc value."""

    type_name = "murmur3"

    def doc_value(self, value):
        return int(murmur3_x86_32_many([str(value).encode("utf-8")])[0])


class HistogramFieldMapper(FieldMapper):
    """`histogram`: a pre-aggregated {values, counts} doc value: as many
    counts as values, counts >= 0, values increasing."""

    type_name = "histogram"

    def coerce(self, value) -> dict:
        if not isinstance(value, dict) or "values" not in value \
                or "counts" not in value:
            raise MapperParsingError(
                f"[{self.name}] histogram must be {{values, counts}}")
        values = [float(v) for v in value["values"]]
        counts = [int(c) for c in value["counts"]]
        if len(values) != len(counts):
            raise MapperParsingError(
                f"[{self.name}] expected same length for values and counts")
        if any(c < 0 for c in counts):
            raise MapperParsingError(f"[{self.name}] counts must be >= 0")
        if values != sorted(values):
            raise MapperParsingError(
                f"[{self.name}] values must be in increasing order")
        return {"values": values, "counts": counts}

    def doc_value(self, value):
        return self.coerce(value)


class FlattenedFieldMapper(FieldMapper):
    """`flattened`: a whole object indexed as keywords. The field's own
    terms are every leaf value, and `field.key.path` holds that key's
    values (`MapperService._index_one` indexes both); objects deeper than
    `depth_limit` (20) are a mapper-parsing error."""

    type_name = "flattened"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.depth_limit = int(self.params.get("depth_limit", 20))

    def coerce(self, value) -> dict:
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"[{self.name}] flattened field value must be an object")
        return value

    def index_terms(self, value):
        # a query value: a leaf's term
        if isinstance(value, dict):
            return []
        return [_flat_str(value)]

    def leaves(self, value, prefix: str = "", depth: int = 0):
        """(key path, leaf string) of every leaf of an object."""
        if depth > self.depth_limit:
            raise MapperParsingError(
                f"[{self.name}] object depth exceeds depth_limit "
                f"[{self.depth_limit}]")
        for k, v in value.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                yield from self.leaves(v, path + ".", depth + 1)
            elif isinstance(v, list):
                for item in v:
                    if isinstance(item, dict):
                        yield from self.leaves(item, path + ".", depth + 1)
                    elif item is not None:
                        yield path, _flat_str(item)
            elif v is not None:
                yield path, _flat_str(v)

    def doc_value(self, value):
        return self.coerce(value)


def _flat_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class AnnotatedTextFieldMapper(TextFieldMapper):
    """`annotated_text`: text where `[text](annotation)` indexes the text
    and each `&`-separated, URL-decoded annotation as well."""

    type_name = "annotated_text"

    _ANNOTATION = re.compile(r"\[([^\]]+)\]\(([^)]+)\)")

    def _expand(self, value: str) -> str:
        annotations = []

        def sub(m):
            annotations.extend(urllib.parse.unquote(part)
                               for part in m.group(2).split("&"))
            return m.group(1)

        text = self._ANNOTATION.sub(sub, str(value))
        return text + ("\n" + "\n".join(annotations) if annotations else "")

    def analyze(self, value):
        return super().analyze(self._expand(str(value)))

    def analyze_positions(self, value):
        return super().analyze_positions(self._expand(str(value)))


class AliasFieldMapper(FieldMapper):
    """`alias`: another name of the field at `path`, for queries,
    aggregations, sorts and collapse (`MapperService.get` and
    `resolve_field` follow it one hop); a write to it is a 400."""

    type_name = "alias"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        if not self.params.get("path"):
            raise MapperParsingError(f"[{name}] alias requires [path]")
        self.path = self.params["path"]


FIELD_TYPES = {m.type_name: m for m in (
    TextFieldMapper, KeywordFieldMapper, LongFieldMapper, IntegerFieldMapper,
    ShortFieldMapper, ByteFieldMapper, DoubleFieldMapper, FloatFieldMapper,
    HalfFloatFieldMapper, ScaledFloatFieldMapper, BooleanFieldMapper,
    DateFieldMapper, DateNanosFieldMapper, IpFieldMapper, GeoPointFieldMapper,
    GeoShapeFieldMapper, ObjectMapper, NestedMapper, DenseVectorFieldMapper,
    RankVectorsFieldMapper, RankFeatureFieldMapper, RankFeaturesFieldMapper,
    SparseVectorFieldMapper, JoinFieldMapper, PercolatorFieldMapper,
    BinaryFieldMapper,
    IntegerRangeFieldMapper, LongRangeFieldMapper, FloatRangeFieldMapper,
    DoubleRangeFieldMapper, DateRangeFieldMapper, IpRangeFieldMapper,
    CompletionFieldMapper, SearchAsYouTypeFieldMapper, TokenCountFieldMapper,
    WildcardFieldMapper, ConstantKeywordFieldMapper, Murmur3FieldMapper,
    HistogramFieldMapper, FlattenedFieldMapper, AnnotatedTextFieldMapper,
    AliasFieldMapper)}

# mappers whose value may be an array of JSON objects, each one value,
# not an object of fields (a `join` or `percolator` value is one object,
# and an array of objects under them is walked as objects, as in the
# reference)
_OBJECT_VALUED = (GeoPointFieldMapper, GeoShapeFieldMapper,
                  RangeFieldMapperBase, RankFeaturesFieldMapper,
                  CompletionFieldMapper, FlattenedFieldMapper,
                  HistogramFieldMapper)


def build_mapper(name: str, definition: dict,
                 registry: Optional[AnalysisRegistry] = None) -> FieldMapper:
    """One field's mapper from its definition: `type` (`object` when it
    has `properties` and no type), its parameters less `properties` and
    `fields`, which the mapping holds apart."""
    if name.rpartition(".")[2] == "":
        raise IllegalArgumentError("field name cannot be an empty string")
    t = definition.get("type", "object" if "properties" in definition
                       else None)
    if t is None:
        raise MapperParsingError(f"no type specified for field [{name}]")
    cls = FIELD_TYPES.get(t)
    if cls is None:
        raise MapperParsingError(
            f"No handler for type [{t}] declared on field [{name}]")
    params = {k: v for k, v in definition.items()
              if k not in ("type", "properties", "fields")}
    if issubclass(cls, (TextFieldMapper, TokenCountFieldMapper)):
        return cls(name, params, registry=registry)
    return cls(name, params)


class MapperService:
    """The (additive-only) mapping of one index, shared by its shards:
    dotted path -> mapper, and a field's multi-fields. A write (a merge,
    a dynamic field) takes the service's lock, works on copies of the
    maps and publishes them when it ends, the multi-fields first: a
    reader on another thread never takes the lock, and a field it sees
    comes with its sub-fields."""

    def __init__(self, mapping: Optional[dict] = None,
                 registry: Optional[AnalysisRegistry] = None):
        self._mappers: Dict[str, FieldMapper] = {}
        # path -> {sub-field name -> mapper}
        self._multi_fields: Dict[str, Dict[str, FieldMapper]] = {}
        self._meta: dict = {}
        self.source_enabled = True
        self.dynamic = True
        # `index.mapping.nested_objects.limit` (no limit when None)
        self.nested_objects_limit: Optional[int] = None
        # the index's analyzers (`AnalysisRegistry.from_index_settings`)
        self.registry = registry
        self._lock = threading.Lock()
        self._next: Optional[tuple] = None  # the copies a write works on
        if mapping:
            self.merge(mapping)

    def merge(self, mapping: dict) -> None:
        """Add a mapping's fields (`PUT /{index}/_mapping` too): a body of
        `properties`, or a bare field object less its metadata keys. A
        field whose type changes is the reference's 400, and the fields
        before it in the body stay merged, as there."""
        if not isinstance(mapping, dict):
            raise MapperParsingError("mapping must be an object")
        if "properties" in mapping:
            props = mapping["properties"]
        else:
            props = {k: v for k, v in mapping.items()
                     if not k.startswith("_") and k != "dynamic"}
        with self._writing():
            if "dynamic" in mapping:
                dyn = mapping["dynamic"]
                self.dynamic = dyn if isinstance(dyn, bool) else dyn == "true"
            if "_meta" in mapping:
                self._meta = mapping["_meta"]
            src = mapping.get("_source")
            if isinstance(src, dict) and src.get("enabled") is False:
                # _source disabled: never rendered in hits or GET
                self.source_enabled = False
            self._merge_props(props, prefix="")

    def _merge_props(self, props: dict, prefix: str) -> None:
        for name, definition in props.items():
            path = f"{prefix}{name}"
            if not isinstance(definition, dict):
                raise MapperParsingError(
                    f"invalid mapping definition for [{path}]")
            if "properties" in definition:
                self._merge_props(definition["properties"], prefix=path + ".")
                if definition.get("type") == "nested":
                    self._put(path, NestedMapper(path, {}))
                continue
            mapper = build_mapper(path, definition, self.registry)
            self._put(path, mapper)
            for sub_name, sub_def in (definition.get("fields") or {}).items():
                sub = build_mapper(f"{path}.{sub_name}", sub_def,
                                   self.registry)
                self._put_multi_field(path, sub_name, sub)
            if isinstance(mapper, SearchAsYouTypeFieldMapper):
                # the shingle and prefix sub-fields, analyzed as the field
                analyzer_params = {k: v for k, v in mapper.params.items()
                                   if k in ("analyzer", "search_analyzer")}
                for sub_name, sub in (
                        ("_2gram", _ShingleTextMapper(
                            f"{path}._2gram", analyzer_params, 2)),
                        ("_3gram", _ShingleTextMapper(
                            f"{path}._3gram", analyzer_params, 3)),
                        ("_index_prefix", _PrefixTextMapper(
                            f"{path}._index_prefix", analyzer_params))):
                    self._put_multi_field(path, sub_name, sub)

    @contextmanager
    def _writing(self):
        """Hold the lock and work on copies of the maps, published when
        the write ends, also when it fails (the fields before a failing
        one stay merged, as in the reference)."""
        with self._lock:
            self._next = (dict(self._mappers), dict(self._multi_fields))
            try:
                yield
            finally:
                mappers, multi = self._next
                self._next = None
                self._multi_fields = multi
                self._mappers = mappers

    def _put(self, path: str, mapper: FieldMapper) -> None:
        """Map a path inside `_writing`; a type change is the reference's
        400."""
        mappers = self._next[0]
        existing = mappers.get(path)
        if existing is not None and existing.type_name != mapper.type_name:
            raise IllegalArgumentError(
                f"mapper [{path}] cannot be changed from type "
                f"[{existing.type_name}] to [{mapper.type_name}]")
        mappers[path] = mapper

    def _put_multi_field(self, path: str, sub_name: str,
                         sub: FieldMapper) -> None:
        multi = self._next[1]
        multi[path] = {**multi.get(path, {}), sub_name: sub}
        self._put(f"{path}.{sub_name}", sub)

    def get(self, path: str) -> Optional[FieldMapper]:
        """The mapper of a path; an `alias` gives its target's (None for
        an alias of an alias)."""
        mapper = self._mappers.get(path)
        if isinstance(mapper, AliasFieldMapper):
            target = self._mappers.get(mapper.path)
            return None if isinstance(target, AliasFieldMapper) else target
        return mapper

    def get_raw(self, path: str) -> Optional[FieldMapper]:
        """The mapper of a path as mapped, an `alias` itself."""
        return self._mappers.get(path)

    def resolve_field(self, path: str) -> str:
        """The field an `alias` names (one hop), else the path."""
        mapper = self._mappers.get(path)
        return mapper.path if isinstance(mapper, AliasFieldMapper) else path

    def maps_object(self, path: str) -> bool:
        """Whether `path` is an object of the mapping: mapped as one, or
        the prefix of a mapped path."""
        prefix = path + "."
        return isinstance(self._mappers.get(path),
                          (ObjectMapper, NestedMapper)) or any(
            p.startswith(prefix) for p in self._mappers)

    def to_dict(self) -> dict:
        """The mapping as `GET /_mapping` renders it: objects as nested
        `properties` (an `object` mapped without properties renders
        nothing, as in the reference), multi-fields under their parent's
        `fields`, each field's type and its parameters as given, and
        `_meta`."""
        mappers, multi = self._mappers, self._multi_fields
        root: dict = {}
        for path in sorted(mappers):
            mapper = mappers[path]
            if isinstance(mapper, ObjectMapper):
                continue
            parts = path.split(".")
            parent = ".".join(parts[:-1])
            if parts[-1] in multi.get(parent, {}):
                continue
            node = root
            for p in parts[:-1]:
                node = node.setdefault("properties", {}).setdefault(p, {})
            leaf = node.setdefault("properties", {}).setdefault(parts[-1], {})
            leaf.update(mapper.to_def())
            if path in multi:
                leaf["fields"] = {sub: m.to_def()
                                  for sub, m in multi[path].items()}
        out = {"properties": root.get("properties", {})}
        if self._meta:
            out["_meta"] = self._meta
        return out

    def all_mappers(self):
        return list(self._mappers.items())

    def field_names(self) -> List[str]:
        return sorted(self._mappers)

    def vector_fields(self) -> Dict[str, DenseVectorFieldMapper]:
        return {p: m for p, m in self._mappers.items()
                if isinstance(m, DenseVectorFieldMapper)}

    def token_fields(self) -> Dict[str, RankVectorsFieldMapper]:
        return {p: m for p, m in self._mappers.items()
                if isinstance(m, RankVectorsFieldMapper)}

    # ---------------------------------------------------------- parsing
    def parse_document(self, source: dict) -> "ParsedFields":
        """The document's mapped values, validated, as the reference's
        `DocumentParser` makes them: objects walked by dotted path (an
        array of objects flattened into its paths), unmapped fields mapped
        dynamically when `dynamic` holds; dense_vector values as f32 rows,
        rank_vectors values as f32 [n_tokens, dims] matrices, text values
        as analyzed terms with their positions and the field's length, a
        feature map (`rank_features`, `sparse_vector`) as its keys and
        coerced weights, and every other mapped field's index terms and
        doc value (a list holds several values; one value stays a scalar);
        each multi-field indexes every value of its parent."""
        if not isinstance(source, dict):
            raise MapperParsingError("document source must be an object")
        limit = self.nested_objects_limit
        if limit is not None and self._count_nested_docs(source, "") > limit:
            raise IllegalArgumentError(
                f"The number of nested documents has exceeded the allowed "
                f"limit of [{limit}]. This limit can be set by changing "
                f"the [index.mapping.nested_objects.limit] index level "
                f"setting.")
        parsed = ParsedFields()
        self._parse_object(source, "", parsed)
        return parsed

    def _count_nested_docs(self, obj: dict, prefix: str) -> int:
        """The nested documents an object holds: each object under a
        `nested` path, at every depth."""
        total = 0
        for k, v in obj.items():
            path = prefix + k
            is_nested = isinstance(self.get(path), NestedMapper)
            if isinstance(v, list):
                items = [i for i in v if isinstance(i, dict)]
                if is_nested:
                    total += len(items)
                for item in items:
                    total += self._count_nested_docs(item, path + ".")
            elif isinstance(v, dict):
                if is_nested:
                    total += 1
                total += self._count_nested_docs(v, path + ".")
        return total

    def _parse_object(self, obj: dict, prefix: str,
                      parsed: "ParsedFields") -> None:
        for key, value in obj.items():
            path = f"{prefix}{key}"
            mapper = self.get(path)
            if isinstance(value, dict):
                if mapper is None \
                        or isinstance(mapper, (ObjectMapper, NestedMapper)):
                    self._parse_object(value, path + ".", parsed)
                    continue
            elif isinstance(value, list) and value \
                    and isinstance(value[0], dict) \
                    and not isinstance(mapper, _OBJECT_VALUED):
                # an array of objects: each item's fields, flattened
                for item in value:
                    if isinstance(item, dict):
                        self._parse_object(item, path + ".", parsed)
                continue
            self._parse_field(path, value, parsed)

    def _parse_field(self, path: str, value: Any,
                     parsed: "ParsedFields") -> None:
        mapper = self._mappers.get(path)
        if isinstance(mapper, AliasFieldMapper):
            raise MapperParsingError(
                f"Cannot write to a field alias [{path}].")
        if mapper is None:
            if value is None or not self.dynamic:
                return  # unmapped: kept in _source, not indexed
            mapper = self._map_dynamic(path, value)
            if mapper is None:
                return
        if value is None:
            return
        if isinstance(mapper, DenseVectorFieldMapper):
            parsed.vectors[path] = mapper.coerce(value)
            return
        if isinstance(mapper, RankVectorsFieldMapper):
            # each element is one token row ([] indexes no token)
            rows = [mapper.coerce(v) for v in
                    (value if isinstance(value, list) else [value])
                    if v is not None]
            if rows:
                parsed.vectors[path] = (rows[0] if len(rows) == 1
                                        else np.concatenate(rows))
            return
        if isinstance(mapper, GeoPointFieldMapper) \
                and isinstance(value, (list, tuple)) and len(value) == 2 \
                and all(isinstance(v, (int, float))
                        and not isinstance(v, bool) for v in value):
            values = [value]     # one [lon, lat] point
        else:
            values = value if isinstance(value, list) else [value]
        subs = self._multi_fields.get(path, {})
        for v in values:
            if v is None:
                continue
            try:
                self._index_one(path, mapper, v, parsed)
            except MapperParsingError:
                # ignore_malformed: drop the unparseable value, keep the
                # doc; the field lands in the searchable `_ignored` field
                if not mapper.params.get("ignore_malformed"):
                    raise
                ignored = parsed.doc_values.setdefault("_ignored", [])
                if path not in ignored:
                    ignored.append(path)
                    parsed.terms.setdefault("_ignored", []).append(path)
                continue
            for sub_name, sub in subs.items():
                self._index_one(f"{path}.{sub_name}", sub, v, parsed)
        if isinstance(mapper, RankFeaturesFieldMapper) \
                and isinstance(parsed.doc_values.get(path), dict):
            fmap = parsed.doc_values.pop(path)
            parsed.features[path] = (list(fmap), list(fmap.values()))

    def _index_one(self, path: str, mapper: FieldMapper, v: Any,
                   parsed: "ParsedFields") -> None:
        if isinstance(mapper, AliasFieldMapper):
            raise MapperParsingError(
                f"Cannot write to a field alias [{path}].")
        if isinstance(mapper, FlattenedFieldMapper):
            # the root field holds every leaf, `path.key` that key's
            obj = mapper.coerce(v)
            root_terms = parsed.terms.setdefault(path, [])
            for key_path, leaf in mapper.leaves(obj):
                root_terms.append(leaf)
                parsed.terms.setdefault(f"{path}.{key_path}", []).append(leaf)
            parsed.doc_values[path] = obj
            return
        if isinstance(mapper, TextFieldMapper):
            # a later value of a multi-valued field continues the
            # positions where the one before ended
            tokens = mapper.analyze_positions(v)
            base = parsed.field_lengths.get(path, 0)
            parsed.terms.setdefault(path, []).extend([t[0] for t in tokens])
            parsed.term_positions.setdefault(path, []).extend(
                [base + t[1] for t in tokens])
            parsed.field_lengths[path] = base + len(tokens)
            return
        # the terms land before the doc value is read, so they stay when
        # it then fails, as in the reference (an `ignore_malformed`
        # date_nanos keeps them)
        terms = mapper.index_terms(v)
        if terms:
            parsed.terms.setdefault(path, []).extend(terms)
        if isinstance(mapper, ConstantKeywordFieldMapper):
            self._fix_constant(mapper, v)
        dv = mapper.doc_value(v)
        if dv is not None:
            existing = parsed.doc_values.get(path)
            if existing is None:
                parsed.doc_values[path] = dv
            elif isinstance(existing, list):
                existing.append(dv)
            else:
                parsed.doc_values[path] = [existing, dv]

    def _fix_constant(self, mapper: "ConstantKeywordFieldMapper",
                      value: Any) -> None:
        """The first value a `constant_keyword` field is written with sets
        its mapping's `value`, under the lock the index's shards share."""
        if mapper.params.get("value") is None:
            with self._lock:
                if mapper.params.get("value") is None:
                    mapper.params["value"] = str(value)

    def _map_dynamic(self, path: str, value: Any) -> Optional[FieldMapper]:
        """Map an unmapped path from its value, under the lock: a field
        another writer mapped first is used as it mapped it. A dynamic
        text field gets the `keyword` sub-field."""
        with self._writing():
            mapper = self._mappers.get(path)
            if mapper is not None:
                return mapper
            mapper = self._dynamic_mapper(path, value)
            if mapper is None:
                return None
            self._put(path, mapper)
            if isinstance(mapper, TextFieldMapper):
                self._put_multi_field(path, "keyword", KeywordFieldMapper(
                    f"{path}.keyword", {"ignore_above": 256}))
            return mapper

    def _dynamic_mapper(self, path: str, value: Any) -> Optional[FieldMapper]:
        probe = value[0] if isinstance(value, list) and value else value
        if isinstance(probe, bool):
            return BooleanFieldMapper(path, {})
        if isinstance(probe, int):
            return LongFieldMapper(path, {})
        if isinstance(probe, float):
            return FloatFieldMapper(path, {})
        if isinstance(probe, str):
            if re.match(r"\d{4}-\d{2}-\d{2}", probe):
                try:
                    parse_date_millis(probe)
                except MapperParsingError:
                    pass
                else:
                    return DateFieldMapper(path, {})
            return TextFieldMapper(path, {}, registry=self.registry)
        return None


class ParsedFields:
    """One document's mapped values: field -> vector (or token matrix),
    field -> index terms (duplicates kept, for term frequencies), field ->
    doc value (a scalar, or a list for a multi-valued field); for text
    fields, field -> each term's position (parallel to its terms) and
    field -> token count; for a feature-map field holding one map, field ->
    (its keys, its weights as floats), in the map's order. Fields are
    dotted paths."""

    __slots__ = ("vectors", "terms", "doc_values", "term_positions",
                 "field_lengths", "features")

    def __init__(self):
        self.vectors: Dict[str, np.ndarray] = {}
        self.terms: Dict[str, List[str]] = {}
        self.doc_values: Dict[str, Any] = {}
        self.term_positions: Dict[str, List[int]] = {}
        self.field_lengths: Dict[str, int] = {}
        self.features: Dict[str, tuple] = {}
