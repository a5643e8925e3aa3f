"""Mapping breadth through both packages on the CPU: two REST faults the
port had (a multi-field accepted and then left unindexed, and a JSON
object in a document dropped with no dynamic mapping), then the date
parsing and date math, the IP transform, each new mapper's index terms and
doc values, and `MapperService.to_dict` after merges and dynamic updates,
held to the JAX package's `index/mapping.py` on the same inputs.

Tolerance: none. Every value compared here (epoch millis and nanos, the
128-bit IP integers, index terms, doc values, mappings) is an integer, a
string or a dict of them and must be equal; geo points and range bounds
are floats computed by the same arithmetic and compared with `==`.
"""

import pytest

from tests.torch_rest_pair import Pair, hit_ids


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def test_fault_multi_field_term_on_sub_field(pair):
    """A `text` field with a `keyword` multi-field: `term` on the `.raw`
    path finds the document (a port that keeps `fields` as a plain
    parameter indexes nothing under it), and `GET /_mapping` renders the
    sub-field under `fields`."""
    pair.same("PUT", "/k", {"mappings": {"properties": {
        "req": {"type": "text", "fields": {"raw": {"type": "keyword"}}}}}})
    pair.same("PUT", "/k/_doc/1", {"req": "GET /a HTTP/1.0"},
              query={"refresh": "true"})
    pair.same("PUT", "/k/_doc/2", {"req": ["GET /b HTTP/1.0", "x"]},
              query={"refresh": "true"})
    want, got = pair.same("POST", "/k/_search", {"query": {"term": {
        "req.raw": "GET /a HTTP/1.0"}}})
    assert hit_ids(got) == ["1"]
    _, got = pair.same("POST", "/k/_search", {"query": {"term": {
        "req.raw": "x"}}})
    assert hit_ids(got) == ["2"]
    pair.same("POST", "/k/_search", {"query": {"match": {"req": "http"}}})
    pair.same("POST", "/k/_search", {"query": {"exists": {
        "field": "req.raw"}}})
    pair.same("POST", "/k/_search", {"sort": [{"req.raw": "desc"}],
                                     "docvalue_fields": ["req.raw"]})
    _, got = pair.same("GET", "/k/_mapping")
    assert got["k"]["mappings"]["properties"]["req"]["fields"] == {
        "raw": {"type": "keyword"}}


def test_fault_object_and_dynamic_fields(pair):
    """A document with a JSON object and unmapped fields maps them
    dynamically (text with a `.keyword` sub-field, long, float, boolean,
    a `yyyy-MM-dd` string as date), and `match` / `term` / `range` /
    `exists` find it, as in the reference; `GET /_mapping` lists them."""
    pair.same("PUT", "/d/_doc/1", {"geo": {"city": "Paris", "zip": 75001},
                                    "n": 3, "f": 1.5, "ok": True,
                                    "day": "2015-01-01"},
              query={"refresh": "true"})
    pair.same("PUT", "/d/_doc/2", {"geo": {"city": "Lyon Nord"}, "n": 9},
              query={"refresh": "true"})
    for q, ids in (({"match": {"geo.city": "paris"}}, ["1"]),
                   ({"term": {"geo.city.keyword": "Lyon Nord"}}, ["2"]),
                   ({"range": {"n": {"gte": 2, "lt": 4}}}, ["1"]),
                   ({"range": {"day": {"gte": "2014-12-31"}}}, ["1"]),
                   ({"term": {"ok": True}}, ["1"]),
                   ({"range": {"geo.zip": {"gt": 75000}}}, ["1"]),
                   ({"exists": {"field": "geo"}}, ["1", "2"])):
        _, got = pair.same("POST", "/d/_search",
                           {"query": q, "sort": ["_doc"]})
        assert hit_ids(got) == ids, q
    _, got = pair.same("GET", "/d/_mapping")
    props = got["d"]["mappings"]["properties"]
    assert props["geo"]["properties"]["city"]["fields"]["keyword"] == {
        "type": "keyword", "ignore_above": 256}
    assert (props["n"]["type"], props["f"]["type"], props["ok"]["type"],
            props["day"]["type"]) == ("long", "float", "boolean", "date")


# ------------------------------------------------ dates, date math, IPs

import time  # noqa: E402

import numpy as np  # noqa: E402

from elasticsearch_tpu.index import mapping as ref_mapping  # noqa: E402
from elasticsearch_tpu_torch.index import mapping as port_mapping  # noqa: E402

# 2015-03-31T10:20:30.456Z, a month end (day clamping) and not a week start
FROZEN_NOW = 1427797230.456


@pytest.fixture
def frozen(monkeypatch):
    """`now` at FROZEN_NOW in both packages (both read `time.time`)."""
    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)


def _both(fn_name, *args, **kwargs):
    """The function's result in each package, or its error (type name and
    message)."""
    out = []
    for mod in (ref_mapping, port_mapping):
        try:
            out.append(getattr(mod, fn_name)(*args, **kwargs))
        except Exception as e:   # noqa: BLE001 - the error is the result
            out.append((type(e).__name__, str(e)))
    return out


DATE_CASES = [
    1427797230456, 14.9, "1427797230456", "2015", "2015-03-31",
    "2015/03/31", "2015-03-31 10:20:30", "2015-03-31T10:20:30",
    "2015-03-31T10:20:30.456", "2015-03-31T10:20:30Z",
    "2015-03-31T10:20:30.456789Z", "2015-03-31T10:20:30+02:00",
    "2015-03-31T10:20:30-0530", "  2015-03-31  ",
    "now", "now-1h", "now+1d/d", "now/M", "now-1M", "now+1y/y", "now/w",
    "now-3w/w", "now-7d/d", "now/s", "now/H", "now-90m/m",
    "2015-03-31||+1M", "2015-01-31||+1M", "2016-02-29||+1y",
    "2015-03-31||/d", "2015-03-31T10:20:30Z||-1d/d", "2015-03-31||/M",
    "2015-03-31||/y", "2015-03-31||/w", "2015-03-31||-2M/M",
    # malformed: each raises the reference's error
    "now-1x", "now/2d", "now+", "2015-03-31||+1q", "31/03/2015",
    "not a date", True, "",
]


@pytest.mark.parametrize("round_up", [False, True])
@pytest.mark.parametrize("value", DATE_CASES,
                         ids=[str(i) for i in range(len(DATE_CASES))])
def test_parse_date_millis(frozen, value, round_up):
    ref, port = _both("parse_date_millis", value, round_up=round_up)
    assert port == ref


NANOS_CASES = [
    1427797230456, "1427797230456", "2015-03-31T10:20:30Z",
    "2015-03-31T10:20:30.123456789Z", "2015-03-31T10:20:30.1Z",
    "2015-03-31T10:20:30.123456+01:00", "2015-03-31", "1969-12-31",
    "2262-04-12", "2015-03-31T10:20:30.1234567891Z", False, "junk",
]


@pytest.mark.parametrize("value", NANOS_CASES,
                         ids=[str(i) for i in range(len(NANOS_CASES))])
def test_parse_date_nanos(value):
    ref, port = _both("parse_date_nanos", value)
    assert port == ref


@pytest.mark.parametrize("value,fmt,locale", [
    ("Tue, 31 Mar 2015 10:20:30 +0000", "E, d MMM yyyy HH:mm:ss Z", ""),
    ("Di, 31 Mär 2015 10:20:30 +0200", "E, d MMM yyyy HH:mm:ss Z", "de"),
    ("31 Okt 2015", "dd MMM yyyy", "de_DE"),
    ("March 31 15", "MMMM dd yy", ""),
])
def test_parse_custom_date(value, fmt, locale):
    ref, port = _both("parse_custom_date", value, fmt, locale)
    assert port == ref


IP_CASES = ["0.0.0.0", "0.0.0.1", "192.168.1.7", "255.255.255.255", "::",
            "::1", "::ffff:10.0.0.1", "2001:db8::8a2e:370:7334",
            "fe80::1", "300.1.1.1", "not-an-ip", "10.0.0.0/8", "01.2.3.4",
            "1.2.3.4\n", " 1.2.3.4", "1.2.3", "\u0661.2.3.4", "256.0.0.1",
            "1.2.3.04", "99.199.249.255", 167838211]


@pytest.mark.parametrize("value", IP_CASES)
def test_ip_transform(value):
    """The 128-bit integer of an address (IPv4 as ::ffff:a.b.c.d) and the
    address `format_value` gives back."""
    ref, port = (m.IpFieldMapper("ip") for m in (ref_mapping, port_mapping))
    out = []
    for mapper in (ref, port):
        try:
            stored = mapper.coerce(value)
            out.append((stored, mapper.index_terms(value),
                        mapper.format_value(stored)))
        except Exception as e:   # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]


# ------------------------------------------------------ the new mappers

MAPPER_CASES = [
    ("date", {}, ["2015-03-31T10:20:30Z", 1427797230456, "2015-03-31",
                  "1427797230456", "bad", None, False]),
    ("date", {"format": "strict_date_optional_time||epoch_second"},
     [893974217, "893974217", 893974217.5, "1998-05-01T00:10:17Z", "x"]),
    ("date", {"format": "E, d MMM yyyy HH:mm:ss Z", "locale": "de"},
     ["Di, 31 Mär 2015 10:20:30 +0200", "2015-03-31", "Di, 99 X"]),
    ("date_nanos", {}, ["2015-03-31T10:20:30.123456789Z", 1427797230456,
                        "1969-12-31T23:59:59Z", "2262-04-12", "junk"]),
    ("ip", {}, ["10.1.2.3", "::1", "2001:db8::1", 167838211, "x"]),
    ("geo_point", {}, [{"lat": 48.85, "lon": 2.35}, [2.35, 48.85],
                       "48.85,2.35", "u09tvw0", "u09tvw0f6szy", {"lat": 1},
                       "zz,top", "!!", 7]),
    ("integer_range", {}, [{"gte": 1, "lt": 10}, {"gt": 1, "lte": 10},
                           {}, {"gte": 5, "lte": 1}, {"gte": "3"},
                           {"from": 1}, 5]),
    ("long_range", {}, [{"gt": 2 ** 40, "lt": 2 ** 41}]),
    ("float_range", {}, [{"gt": 1.5, "lt": 2.5}, {"gte": -1, "lte": 1}]),
    ("double_range", {}, [{"gt": 0.1}, {"lt": 1e300}]),
    ("date_range", {}, [{"gte": "2015-03-01", "lt": "2015-04-01"},
                        {"gt": "2015-03-31||/d"}, {"gte": "now"}]),
    ("ip_range", {}, [{"gte": "10.0.0.0", "lte": "10.0.0.255"},
                      "192.168.0.0/16", "2001:db8::/32", "bad/99",
                      {"gt": "10.0.0.1"}]),
    ("object", {}, ["x", 3]),
    # the older mappers, whose terms and doc values the write path reads
    ("scaled_float", {"scaling_factor": 10}, [2.37, "4.44", "x", True]),
    ("long", {}, [3, "7", 2.5, "x"]), ("float", {}, [1.25, "2", None]),
    ("keyword", {"ignore_above": 3}, ["ab", "abcd", 12]),
    ("boolean", {}, [True, "false", "maybe"]),
]


@pytest.mark.parametrize("tname,params,values", MAPPER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(MAPPER_CASES)])
def test_mapper_terms_and_doc_values(frozen, tname, params, values):
    """Each value's index terms and doc value (or the error, its type and
    message, and for date_nanos its `caused_by`), equal in both
    packages."""
    ref = ref_mapping.FIELD_TYPES[tname]("f", params)
    port = port_mapping.FIELD_TYPES[tname]("f", params)
    for v in values:
        out = []
        for fn in (lambda v: (ref.index_terms(v), ref.doc_value(v)),
                   lambda v: (port.index_terms(v), port.doc_value(v))):
            try:
                out.append(fn(v))
            except Exception as e:   # noqa: BLE001
                out.append((type(e).__name__, str(e),
                            getattr(e, "metadata", None)))
        assert out[1] == out[0], (tname, v)
    assert port.to_def() == ref.to_def()
    if hasattr(ref, "query_bound"):
        for b, up in (("2015-03-31||/M", True), ("2015-03-31", False),
                      (7, False), ("10.0.0.9", False)):
            out = []
            for mapper in (ref, port):
                try:
                    out.append(mapper.query_bound(b, round_up=up))
                except Exception as e:   # noqa: BLE001
                    out.append((type(e).__name__, str(e)))
            assert out[1] == out[0], (tname, b)


# ----------------------------------------- MapperService: merges, to_dict

MAPPINGS = [
    {"properties": {"a": {"type": "keyword"}}},
    {"properties": {"geo": {"properties": {
        "city": {"type": "keyword"},
        "loc": {"type": "geo_point"},
        "deep": {"properties": {"x": {"type": "long"}}}}}}},
    {"properties": {"geo": {"type": "object", "properties": {
        "c": {"type": "ip"}}}, "o": {"type": "object"}}},
    {"properties": {"req": {"type": "text", "analyzer": "whitespace",
                            "fields": {"raw": {"type": "keyword",
                                               "ignore_above": 32},
                                       "len": {"type": "integer"}}}}},
    {"properties": {"a.b.c": {"type": "date", "format": "epoch_second"},
                    "a.d": {"type": "date_nanos"}}},
    {"dynamic": "strict", "_meta": {"v": 1}, "properties": {
        "r1": {"type": "integer_range"}, "r2": {"type": "ip_range"},
        "r3": {"type": "date_range"}, "r4": {"type": "double_range"}}},
    {"properties": {"x": {"type": "long"}}, "dynamic": False},
    {"k": {"type": "keyword"}, "n": {"type": "float"}},
]


def _ref_service(mapping):
    return ref_mapping.MapperService(mapping)


@pytest.mark.parametrize("mapping", MAPPINGS,
                         ids=[str(i) for i in range(len(MAPPINGS))])
def test_merge_and_to_dict(mapping):
    ref, port = _ref_service(mapping), port_mapping.MapperService(mapping)
    assert port.to_dict() == ref.to_dict()
    assert sorted(p for p, _ in port.all_mappers()) == sorted(
        p for p, _ in ref.all_mappers())
    assert port.dynamic == ref.dynamic


@pytest.mark.parametrize("body", [
    {"properties": {"a": {"type": "long"}}},
    {"properties": {"geo": {"properties": {"city": {"type": "text"}}}}},
    {"properties": {"req": {"type": "text", "fields": {
        "raw": {"type": "long"}}}}},
    {"properties": {"n": {"type": "nested", "properties": {
        "x": {"type": "keyword"}}}}},
    {"properties": {"w": {"type": "wildcard"}}},
    {"properties": {"p": {"dynamic": True}}},
    {"properties": {"": {"type": "keyword"}}},
])
def test_merge_errors(body):
    """A type change is the reference's 400 (the fields before it stay
    merged); `nested`, `wildcard`, a field with no type or an empty name,
    as the reference."""
    base = MAPPINGS[1]
    base = {"properties": dict(base["properties"], a={"type": "keyword"},
                               req={"type": "text", "fields": {
                                   "raw": {"type": "keyword"}}})}
    ref, port = _ref_service(base), port_mapping.MapperService(base)
    errs = []
    for svc in (ref, port):
        try:
            svc.merge(body)
            errs.append(None)
        except Exception as e:   # noqa: BLE001
            errs.append((type(e).__name__, str(e)))
    assert errs[1] == errs[0]
    assert port.to_dict() == ref.to_dict()


DOCS = [
    {"geo": {"city": "Paris", "zip": 75001, "pt": {"lat": 1.5, "lon": 2}},
     "n": 3, "f": 1.5, "ok": True, "day": "2015-01-01", "bad": "2015-99-99",
     "tags": ["a", "b"], "nums": [1, 2.5], "none": None, "empty": [],
     "objs": [{"x": 1, "y": "u"}, {"x": 3, "z": False}, 7],
     "mixed": [{"q": 1}], "req": "GET /x HTTP/1.0"},
    {"geo": {"city": "Lyon", "extra": {"deep": "2015-02-03T04:05:06Z"}},
     "n": [4, 5], "day": ["2015-01-02", "2015-01-03"], "late": 9},
    {"n": "12", "f": 7, "ok": "false", "geo": {"city": ["A", "B"]},
     "r": {"gte": 1, "lt": 5}, "req": ["GET /y HTTP/1.0", "POST /z"]},
]


def _parsed(parsed):
    """A parsed document's terms, doc values and field lengths (the
    packages hold positions in different shapes)."""
    return ({k: sorted(map(str, v)) for k, v in parsed.terms.items()},
            parsed.doc_values, dict(parsed.field_lengths))


@pytest.mark.parametrize("mapping", [
    {},
    {"properties": {"req": {"type": "text", "fields": {
        "raw": {"type": "keyword"}}}, "r": {"type": "integer_range"},
        "geo": {"properties": {"pt": {"type": "geo_point"}}}}},
    {"dynamic": "strict", "properties": {"n": {"type": "long"}}},
    {"dynamic": "true", "properties": {"ok": {"type": "keyword"}}},
], ids=["dynamic", "typed", "strict", "string-true"])
def test_parse_documents_and_dynamic_updates(mapping):
    """Each document's terms, doc values and field lengths, then the
    mapping the dynamic fields left, equal in both packages (parse
    errors too)."""
    ref, port = _ref_service(mapping), port_mapping.MapperService(mapping)
    for i, doc in enumerate(DOCS):
        out = []
        for parse in (lambda d: ref.parse_document(str(i), d),
                      port.parse_document):
            try:
                out.append(_parsed(parse(doc)))
            except Exception as e:   # noqa: BLE001
                out.append((type(e).__name__, str(e)))
        assert out[1] == out[0], i
        assert port.to_dict() == ref.to_dict(), i


def test_ignore_malformed_date_and_sub_field_error():
    """`ignore_malformed` on a date drops the value into `_ignored`; a
    multi-field that cannot take its parent's value fails the document,
    as in the reference (its own `ignore_malformed` is not read)."""
    mapping = {"properties": {
        "d": {"type": "date", "ignore_malformed": True},
        "k": {"type": "keyword", "fields": {"n": {
            "type": "long", "ignore_malformed": True}}},
        "dn": {"type": "date_nanos", "ignore_malformed": True}}}
    ref, port = _ref_service(mapping), port_mapping.MapperService(mapping)
    for doc in ({"d": "nope", "k": "12"}, {"d": ["2015-01-01", "x"]},
                {"k": "abc"}, {"dn": "1960-01-01"}):
        out = []
        for parse in (lambda d: ref.parse_document("1", d),
                      port.parse_document):
            try:
                out.append(_parsed(parse(doc)))
            except Exception as e:   # noqa: BLE001
                out.append((type(e).__name__, str(e)))
        assert out[1] == out[0], doc


def test_dynamic_mapping_under_threads():
    """More threads than cores parse documents with the same new fields
    under a short switch interval: every document indexes every field,
    each field is mapped once (the first thread's mapper), and no dynamic
    text field lost its `keyword` sub-field (a lost update of the
    copy-on-write maps would drop one)."""
    import os
    import sys
    import threading
    port = port_mapping.MapperService({})
    errors, missing = [], []

    def work(k):
        try:
            for j in range(40):
                parsed = port.parse_document(
                    {f"f{j}": k, "obj": {f"g{j}": f"s{k}"}})
                if f"f{j}" not in parsed.terms or \
                        f"obj.g{j}.keyword" not in parsed.terms:
                    missing.append((k, j))
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    n_threads = 2 * (os.cpu_count() or 4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not missing
    props = port.to_dict()["properties"]
    assert len(props) == 41 and len(props["obj"]["properties"]) == 40
    assert all(props[f"f{j}"] == {"type": "long"} for j in range(40))
    assert all(props["obj"]["properties"][f"g{j}"] == {
        "type": "text", "fields": {"keyword": {"type": "keyword",
                                               "ignore_above": 256}}}
        for j in range(40))
