"""The mapping breadth through both REST layers on the CPU, request for
request (`tests/torch_rest_pair.py`): `chip_smoke.py`'s serve_logs
bodies (its generator, mapping and requests, at a few hundred lines) at 1
and 2 shards, held to the reference and, at one shard, to numpy as the
card's run holds them; sorts over `date` and `date_nanos` indices with
`numeric_type`, the date formats of `docvalue_fields`, the range types
with `relation`, filtered kNN on date and ip ranges, can_match on date
bounds, and `PUT` / `GET _mapping`, updates and dynamic fields.

Tolerance: `Pair`'s, scores within 1e-4 (every score here is a constant
or a kNN score of both packages' exact f32 route); everything else is
equal.
"""

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest

from elasticsearch_tpu.vectors import store as ref_store
from tests.torch_rest_pair import Pair, hit_ids

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip)

N_LINES = 400
N_EACH = 3
SEED = 7


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def logs(request, tmp_path_factory):
    """Both layers holding the logs index of N_LINES lines (over `_bulk`,
    as the card's run loads its first lines), with its columns."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_store.native, "AVAILABLE", False)
    pair = Pair(tmp_path_factory.mktemp("logs"), mp)
    shards = request.param
    paths = chip.logs_paths()
    cols = chip.logs_columns(SEED, N_LINES)
    pair.same("PUT", "/logs", {"settings": {"number_of_shards": shards},
                               "mappings": chip.LOGS_MAPPING})
    ops = []
    for i, doc in enumerate(chip.logs_sources(cols, 0, N_LINES, paths)):
        ops += [{"index": {"_id": str(i)}}, doc]
    want, _ = pair.same("POST", "/logs/_bulk", ops, ndjson=True)
    assert not want["errors"]
    pair.same("POST", "/logs/_refresh")
    requests = chip.logs_requests(cols, paths, SEED, N_EACH)
    yield pair, shards, cols, requests
    pair.close()
    mp.undo()


@pytest.mark.parametrize("kind", chip.LOGS_KINDS)
def test_logs_bodies(logs, kind):
    """Each serve_logs body of the kind answers alike in both layers, and
    at one shard as numpy says (ids, totals, sort values, formatted
    doc values)."""
    pair, shards, _cols, requests = logs
    sent = 0
    for k, body, want in requests:
        if k != kind:
            continue
        _, got = pair.same("POST", "/logs/_search", body)
        if shards == 1:
            chip.check_logs_response(kind, got, want)
        sent += 1
    assert sent >= N_EACH


def test_logs_mapping_and_source(logs):
    """`GET /_mapping` (the object, the multi-field, "strict" read as
    false and not rendered), a GET of a line, and the `geoip` object and
    `request.raw` through `exists`, `terms` and `match`."""
    pair, _shards, _cols, _ = logs
    _, got = pair.same("GET", "/logs/_mapping")
    assert got["logs"]["mappings"]["properties"]["geoip"]["properties"][
        "location"] == {"type": "geo_point"}
    pair.same("GET", "/logs/_doc/5")
    for q in ({"exists": {"field": "geoip.location"}},
              {"exists": {"field": "geoip.nope"}},
              {"terms": {"geoip.city_name": ["Paris", "Tokyo"]}},
              {"match": {"request": "html"}},
              {"term": {"status": 404}},
              {"range": {"size": {"gte": 10_000}}},
              {"range": {"@timestamp": {"gte": "now-30y/y"}}},
              {"range": {"clientip": {"gte": "::ffff:0.0.0.0",
                                      "lte": "::ffff:127.255.255.255"}}},
              {"term": {"clientip": chip.ipv4(logs[2]["ip"][3])}},
              {"term": {"@timestamp": int(logs[2]["ts"][9]) * 1000}}):
        pair.same("POST", "/logs/_search", {"query": q, "size": 20,
                                            "track_total_hits": True})


def test_logs_sorts_and_doc_values(logs):
    """Sorts on the date, the ip and a multi-field with `docvalue_fields`
    of every kind (the ip and the geo point as stored)."""
    pair, _shards, _cols, _ = logs
    for sort in ([{"@timestamp": {"order": "desc", "numeric_type": "long"}},
                  "_doc"],
                 [{"clientip": "asc"}, {"@timestamp": "desc"}],
                 [{"request.raw": "desc"}, "_doc"],
                 [{"geoip.city_name": {"order": "asc", "missing": "_first"}},
                  {"size": "desc"}]):
        want, _ = pair.same("POST", "/logs/_search", {
            "sort": sort, "size": 15, "_source": False,
            "docvalue_fields": [
                "@timestamp", "clientip", "geoip.location", "status",
                {"field": "@timestamp", "format": "yyyy-MM-dd"},
                {"field": "@timestamp", "format": "epoch_millis"}]})
        pair.same("POST", "/logs/_search", {
            "sort": sort, "size": 15, "_source": False,
            "search_after": want["hits"]["hits"][-1]["sort"]})


# --------------------------------------------- date_nanos, numeric_type

@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _load(pair, name, mapping, docs, shards=1):
    pair.same("PUT", f"/{name}", {"settings": {"number_of_shards": shards},
                                  "mappings": mapping})
    ops = []
    for i, doc in enumerate(docs):
        ops += [{"index": {"_id": f"{name}{i}"}}, doc]
    want, _ = pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
    pair.same("POST", f"/{name}/_refresh")
    return want


@pytest.mark.parametrize("shards", [1, 2])
def test_numeric_type_across_date_and_date_nanos(pair, shards):
    """A `date` index and a `date_nanos` one under one field: each sorted
    alone and together with `numeric_type` date, date_nanos and none,
    pages by `search_after`, and every date format of `docvalue_fields`
    (nanosecond patterns, `epoch_millis`, `strict_date_optional_time`,
    joda patterns, the defaults)."""
    rng = np.random.default_rng(5)
    base = 1_427_797_230_456
    ms = base + rng.integers(0, 10 ** 9, 30)
    _load(pair, "a", {"properties": {"t": {"type": "date"}}},
          [{"t": int(m)} for m in ms[:15]] + [{}], shards)
    frac = rng.integers(0, 10 ** 6, 15)
    docs = [{"t": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(
        int(m) // 1000)) + f".{int(m) % 1000:03d}{int(f):06d}Z"}
        for m, f in zip(ms[15:], frac)]
    docs[3]["t"] = docs[2]["t"]          # a tie
    _load(pair, "b", {"properties": {"t": {"type": "date_nanos"}}},
          docs + [{"x": 1}], shards)
    fmts = [None, "epoch_millis", "strict_date_optional_time",
            "uuuu-MM-dd'T'HH:mm:ss.SSSSSSSSSX", "yyyy-MM-dd HH:mm:ss",
            "date_time", "e"]
    dvf = [("t" if f is None else {"field": "t", "format": f}) for f in fmts]
    for path in ("/a/_search", "/b/_search", "/a,b/_search"):
        for ntype in (None, "date", "date_nanos", "double"):
            clause = {"order": "desc"}
            if ntype:
                clause["numeric_type"] = ntype
            body = {"sort": [{"t": clause}, "_doc"], "size": 7,
                    "docvalue_fields": dvf}
            want, _ = pair.same("POST", path, body)
            pages = 0
            while want["hits"]["hits"] and pages < 6:
                want, _ = pair.same("POST", path, dict(
                    body, search_after=want["hits"]["hits"][-1]["sort"]))
                pages += 1
            assert pages >= 2
    for q in ({"range": {"t": {"gte": "2015-03-31T12:00:00.000000001Z"}}},
              {"range": {"t": {"gt": "2015-04-01||/d", "lt": "now"}}},
              {"term": {"t": docs[2]["t"]}},
              {"range": {"t": {"lte": base + 5 * 10 ** 8}}}):
        pair.same("POST", "/a,b/_search", {"query": q, "sort": ["_doc"]})


# -------------------------------------------------------- range types

RANGE_MAPPING = {"properties": {
    "ir": {"type": "integer_range"}, "lr": {"type": "long_range"},
    "fr": {"type": "float_range"}, "dr": {"type": "double_range"},
    "tr": {"type": "date_range"}, "pr": {"type": "ip_range"}}}


def _range_docs(rng, n):
    docs = []
    for i in range(n):
        a = int(rng.integers(0, 90))
        b = a + int(rng.integers(0, 20))
        doc = {"ir": {"gte": a, "lt": b + 1},
               "lr": [{"gt": a * 10, "lte": b * 10 + 10}, {"gte": 5000}],
               "fr": {"gte": a / 4, "lt": b / 4 + 0.25},
               "dr": {"gt": a * 0.5},
               "tr": {"gte": f"2015-03-{1 + a % 28:02d}",
                      "lt": f"2015-03-{1 + a % 28:02d}||+{1 + b - a}d"},
               "pr": f"10.{a}.0.0/{16 + i % 9}" if i % 2 else
               {"gte": f"192.168.{a}.0", "lte": f"192.168.{b}.255"}}
        if i % 7 == 0:
            doc.pop("dr")
        docs.append(doc)
    return docs


@pytest.mark.parametrize("shards", [1, 2])
def test_range_type_queries(pair, shards):
    """`term` (membership) and `range` under each `relation` on each range
    type, `exists`, and the mapping, as the reference answers them."""
    docs = _range_docs(np.random.default_rng(9), 60)
    want = _load(pair, "r", RANGE_MAPPING, docs, shards)
    assert not want["errors"]
    pair.same("GET", "/r/_mapping")
    queries = [
        {"term": {"ir": 42}}, {"term": {"lr": 5500}}, {"term": {"fr": 3.3}},
        {"term": {"tr": "2015-03-10"}}, {"term": {"pr": "10.5.1.1"}},
        {"term": {"pr": "192.168.40.7"}}, {"terms": {"ir": [1, 2]}},
        {"exists": {"field": "dr"}}]
    for rel in ("intersects", "within", "contains", "INTERSECTS"):
        for field, lo, hi in (("ir", 20, 40), ("lr", 100, 300),
                              ("fr", 5.5, 9.75), ("dr", 10, 30),
                              ("tr", "2015-03-05", "2015-03-09||/d"),
                              ("pr", "10.3.0.0", "10.40.255.255")):
            queries.append({"range": {field: {"gte": lo, "lt": hi,
                                              "relation": rel}}})
            queries.append({"range": {field: {"gt": lo, "lte": hi,
                                              "relation": rel}}})
    for q in queries:
        pair.same("POST", "/r/_search", {"query": q, "size": 60,
                                         "sort": ["_doc"]})
    for body in ({"query": {"range": {"ir": {"gte": "x"}}}},
                 {"query": {"range": {"tr": {"gte": "not a date"}}}}):
        pair.same("POST", "/r/_search", body)


# ---------------------------------------------- filtered kNN, can_match

def _vector_logs(pair, shards):
    rng = np.random.default_rng(31)
    n, d = 240, 8
    cols = chip.logs_columns(3, n)
    docs = chip.logs_sources(cols, 0, n, chip.logs_paths())
    vecs = rng.standard_normal((n, d)).round(4)
    for doc, v in zip(docs, vecs):
        doc["v"] = v.tolist()
    mapping = {**chip.LOGS_MAPPING, "properties": {
        **chip.LOGS_MAPPING["properties"],
        "v": {"type": "dense_vector", "dims": d, "similarity": "cosine"}}}
    _load(pair, "vl", mapping, docs, shards)
    return cols, rng


@pytest.mark.parametrize("shards", [1, 2])
def test_filtered_knn_on_dates_and_ips(pair, shards):
    """kNN bodies filtered by a date range (ISO, date math), an ip range
    and an `exists` on the `geoip` object: hits equal between the
    packages, and every hit inside its filter."""
    cols, rng = _vector_logs(pair, shards)
    day = chip._iso(chip._day(40))
    lo = int(np.quantile(cols["ip"], 0.2))
    filters = [
        {"range": {"@timestamp": {"gte": day, "lt": day[:10] + "||+20d"}}},
        {"range": {"@timestamp": {"gt": "1998-05-20||/d",
                                  "lte": "1998-06-30||/M"}}},
        {"range": {"clientip": {"gte": chip.ipv4(lo),
                                "lt": chip.ipv4(lo + (1 << 30))}}},
        {"bool": {"filter": [{"exists": {"field": "geoip"}},
                             {"term": {"status": 200}}]}},
    ]
    for filt in filters:
        for q in rng.standard_normal((3, 8)).round(4):
            body = {"knn": {"field": "v", "query_vector": q.tolist(),
                            "k": 10, "num_candidates": 40, "filter": filt},
                    "size": 10, "_source": False}
            _, got = pair.same("POST", "/vl/_search", body)
            assert got["hits"]["hits"]
            ids = [h["_id"] for h in got["hits"]["hits"]]
            _, inside = pair.same("POST", "/vl/_search", {
                "query": {"bool": {"filter": [filt, {"ids": {
                    "values": ids}}]}}, "size": 10})
            assert len(inside["hits"]["hits"]) == len(ids)
    # the hybrid plan's kNN leg with a date filter: its rows reach the
    # store's mask alike (the fused response has no `_shards` in the
    # reference, so the hits are compared)
    q = rng.standard_normal(8).round(4)
    body = {"query": {"match": {"request": "html"}},
            "knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                    "num_candidates": 40, "filter": filters[1]},
            "rank": {"rrf": {}}, "size": 10, "_source": False}
    (s1, want), (s2, got) = (pair.ref("POST", "/vl/_search", body),
                             pair.port("POST", "/vl/_search", body))
    assert s1 == s2 == 200 and want["hits"]["hits"]
    pair.match(want["hits"], got["hits"], "rrf")


def test_can_match_on_date_bounds(pair, monkeypatch):
    """Two time-partitioned indices: with `pre_filter_shard_size` a date
    range (ISO, date math, a rounded `lte`, a `gt` on the last line's
    time) skips the index that cannot match, as in the reference; a
    `now` body is never served from the request cache."""
    monkeypatch.setattr(time, "time", lambda: 1_500_000_000.0)
    cols = chip.logs_columns(11, 200)
    docs = chip.logs_sources(cols, 0, 200, chip.logs_paths())
    _load(pair, "early", chip.LOGS_MAPPING, docs[:100])
    _load(pair, "late", chip.LOGS_MAPPING, docs[100:])
    last_early = chip._iso(cols["ts"][99])
    for rng_body in ({"gte": chip._iso(chip._day(80))},
                     {"lte": last_early[:10] + "||/d"},
                     {"gt": last_early},
                     {"gte": last_early},
                     {"lt": "1998-05-01"},
                     {"gte": "now-30y/y", "lte": "now"},
                     {"gte": "garbage"}):
        body = {"query": {"bool": {"filter": [
            {"range": {"@timestamp": rng_body}}]}}, "size": 5,
            "sort": ["_doc"]}
        pair.same("POST", "/early,late/_search", body,
                  query={"pre_filter_shard_size": "1"})
    for _ in range(2):
        pair.same("POST", "/early/_search", {"size": 0, "query": {
            "range": {"@timestamp": {"gte": "now-30y"}}}})
        pair.same("POST", "/early/_search", {"size": 0, "query": {
            "range": {"@timestamp": {"gte": "1998-05-01"}}}})
    # the counts (the byte estimates of the two packages' entries differ)
    stats = [body["_all"]["total"]["request_cache"] for _, body in (
        pair.ref("GET", "/early/_stats/request_cache"),
        pair.port("GET", "/early/_stats/request_cache"))]
    assert [(s["hit_count"], s["miss_count"]) for s in stats] == [(1, 1)] * 2


# ------------------------------------------------ _mapping and updates

def test_put_mapping_objects_multi_fields_and_dynamic(pair):
    """`PUT _mapping` with objects, dotted paths, multi-fields and
    `dynamic` (false, "strict", "true"), a type change (400, the fields
    before it merged), a `nested` object, then writes, updates whose `doc`
    adds object fields, and `GET _mapping` after each step."""
    pair.same("PUT", "/m", {"mappings": {"properties": {
        "a": {"type": "keyword"}}}})
    steps = [
        {"properties": {"o": {"properties": {"x": {"type": "long"},
                                             "y.z": {"type": "ip"}}}}},
        {"properties": {"t": {"type": "text", "fields": {
            "raw": {"type": "keyword", "ignore_above": 8}}}}},
        {"dynamic": False},
        {"properties": {"b": {"type": "date"}, "a": {"type": "long"}}},
        {"dynamic": "strict", "properties": {"o": {"properties": {
            "w": {"type": "geo_point"}}}}},
        {"dynamic": "true"},
        {"properties": {"n": {"type": "nested", "properties": {
            "q": {"type": "keyword"}}}}},
    ]
    for body in steps[:3]:
        pair.same("PUT", "/m/_mapping", body)
        pair.same("GET", "/m/_mapping")
    pair.same("PUT", "/m/_doc/1", {"a": "k", "new": 1, "o": {"x": 2}},
              query={"refresh": "true"})
    pair.same("GET", "/m/_mapping")
    for body in steps[3:6]:
        pair.same("PUT", "/m/_mapping", body)
        pair.same("GET", "/m/_mapping")
    # a `nested` object, once refused, maps as the reference maps it
    pair.same("PUT", "/m/_mapping", steps[6])
    pair.same("GET", "/m/_mapping")
    pair.same("POST", "/m/_update/1", {"doc": {
        "o": {"v": "2015-01-01", "y": {"z": "10.0.0.1"}},
        "t": "Hello World Again", "more": [1.5, 2]}},
        query={"refresh": "true"})
    pair.same("GET", "/m/_doc/1")
    pair.same("GET", "/m/_mapping")
    for q in ({"term": {"o.v": "2015-01-01"}}, {"term": {"more": 1.5}},
              {"term": {"t.raw": "Hello World Again"}},
              {"match": {"t": "again"}}, {"exists": {"field": "o.y"}},
              {"term": {"new": 1}}, {"range": {"o.y.z": {
                  "gte": "10.0.0.0", "lte": "10.0.0.255"}}}):
        _, got = pair.same("POST", "/m/_search", {"query": q})
    pair.same("POST", "/m/_search", {"query": {"exists": {"field": "o"}}})
    assert hit_ids(got) == ["1"]


@pytest.mark.parametrize("label", sorted(chip.aggs_kinds_bodies({})))
def test_aggs_kinds_bodies(logs, label):
    """Each body of the card's [aggs_kinds] part answers alike in both
    layers (its composite pages too), and at one shard as its numpy check
    says; the pair's bodies over two indices of the first and the last
    150 lines."""
    pair, shards, cols, _requests = logs
    parts = {"logs_early": (0, 150), "logs_late": (N_LINES - 150, N_LINES)}
    if label.startswith("pair"):
        paths = chip.logs_paths()
        for name, (lo, hi) in parts.items():
            pair.same("PUT", f"/{name}", {"settings": {
                "number_of_shards": shards}, "mappings": chip.LOGS_MAPPING})
            ops = []
            for i, doc in enumerate(chip.logs_sources(cols, lo, hi, paths)):
                ops += [{"index": {"_id": str(lo + i)}}, doc]
            pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
            pair.same("POST", f"/{name}/_refresh")
    try:
        path, body = chip.aggs_kinds_bodies(cols)[label]
        want, got = pair.same("POST", path, body)
        assert want["aggregations"] == got["aggregations"]
        pages = {}
        for side, send in (("ref", pair.ref), ("port", pair.port)):
            pages[side] = chip.with_pages(
                label, path, body, got["aggregations"] if side == "port"
                else want["aggregations"],
                lambda p, b, send=send: send("POST", p, b)[1])
        assert pages["ref"] == pages["port"]
        if shards == 1:
            chip.check_aggs_kinds(label, pages["port"], cols,
                                  chip.aggs_kinds_sel(label, cols, parts),
                                  chip.logs_paths())
    finally:
        if label.startswith("pair"):
            for name in parts:
                pair.same("DELETE", f"/{name}")
