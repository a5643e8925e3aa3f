"""The document API through both REST layers on the CPU, request for
request (`tests/torch_rest_pair.py`), at 1 and 3 shards: index, create and
auto-id writes, GET and `_source` with the URL's source filters, delete
(404 `not_found` when missing), update (`doc`, noop, `upsert`,
`doc_as_upsert`, `_source` as `get`), `_bulk` with its four actions and
per-item errors, `_mget`, the version and seq_no conflicts,
`refresh=wait_for`, and kNN after deletes and updates; a `script` update
as the reference answers it. Then the
five REST faults the port answered 200 to (the URL parameters it did not
read, `track_total_hits`, `index.max_result_window`, the `_bulk` item key
of an `index` with no `_id`, the "already exists" reason) and the `terms`
lookup it answered 400 to, the engine's
realtime GET of a sealed row, and an update of a document ingested as a
vector block."""

import numpy as np
import pytest

from elasticsearch_tpu_torch.index import engine as engine_mod
from tests.torch_rest_pair import Pair, hit_ids

D = 8


def _mapping(shards: int) -> dict:
    return {"settings": {"number_of_shards": shards,
                         "number_of_replicas": 0},
            "mappings": {"properties": {
                "v": {"type": "dense_vector", "dims": D,
                      "similarity": "cosine"},
                "k": {"type": "keyword"}, "n": {"type": "long"},
                "t": {"type": "text"}}}}


@pytest.fixture
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _vec(rng):
    return rng.standard_normal(D).astype(np.float32).tolist()


@pytest.mark.parametrize("shards", [1, 3])
def test_document_lifecycle(pair, shards):
    rng = np.random.default_rng(shards)
    pair.same("PUT", "/d", _mapping(shards))
    for i in range(8):
        pair.same("PUT", f"/d/_doc/{i}", {"v": _vec(rng), "k": f"k{i % 3}",
                                          "n": i, "t": f"word{i} shared"})
    pair.same("PUT", "/d/_create/c1", {"v": _vec(rng), "k": "c"})
    pair.same("POST", "/d/_create/c1", {"v": _vec(rng), "k": "c"})
    pair.same("PUT", "/d/_create/c2", {"k": "c"},
              query={"version_type": "external"})
    # auto ids route at random: into a one-shard index, so seq_nos hold
    pair.same("PUT", "/a1", _mapping(1))
    for _ in range(2):
        pair.same("POST", "/a1/_doc", {"v": _vec(rng), "k": "auto"})
    pair.same("POST", "/a1/_doc", {"k": "auto"}, query={"refresh": "true"})
    pair.same("POST", "/a1/_search", {"query": {"term": {"k": "auto"}}})
    pair.same("PUT", "/d/_doc/r", {"k": "r"}, query={"refresh": "true"})
    # realtime GET, the URL's source filters, HEAD and _source
    pair.same("GET", "/d/_doc/3")
    pair.same("GET", "/d/_doc/3", query={"_source": "k,n"})
    pair.same("GET", "/d/_doc/3", query={"_source": "false"})
    pair.same("GET", "/d/_doc/3", query={"_source_includes": "t",
                                         "_source_excludes": "v"})
    pair.same("GET", "/d/_doc/3", query={"version": "1"})
    pair.same("GET", "/d/_doc/3", query={"version": "2"})
    pair.same("GET", "/d/_source/3", query={"_source_excludes": "v"})
    pair.same("GET", "/d/_source/nope")
    pair.same("HEAD", "/d/_doc/3")
    pair.same("HEAD", "/d/_doc/nope")
    pair.same("GET", "/d/_doc/3", query={"realtime": "false"})
    # delete, a missing delete, and a re-index of the deleted id
    pair.same("DELETE", "/d/_doc/4")
    pair.same("DELETE", "/d/_doc/4")
    pair.same("DELETE", "/nope/_doc/4")
    pair.same("GET", "/d/_doc/4")
    pair.same("PUT", "/d/_doc/4", {"v": _vec(rng), "k": "again"})
    pair.same("DELETE", "/d/_doc/5", query={"if_seq_no": "0",
                                            "if_primary_term": "1"})
    # updates: doc, noop, the new source as `get`, upsert, doc_as_upsert
    pair.same("POST", "/d/_update/6", {"doc": {"k": "new", "n": 60}})
    pair.same("POST", "/d/_update/6", {"doc": {"k": "new"}})
    pair.same("POST", "/d/_update/6", {"doc": {"k": "new"},
                                       "detect_noop": False})
    pair.same("POST", "/d/_update/6", {"doc": {"n": 61}, "_source": ["n"]})
    pair.same("POST", "/d/_update/6", {"doc": {"n": 62}},
              query={"_source_includes": "k"})
    pair.same("POST", "/d/_update/u1", {"doc": {"k": "x"}})
    pair.same("POST", "/d/_update/u1", {"doc": {"k": "x"},
                                        "upsert": {"k": "up", "n": 1}})
    pair.same("POST", "/d/_update/u2", {"doc": {"k": "dau", "v": _vec(rng)},
                                        "doc_as_upsert": True})
    pair.same("POST", "/d/_update/6", {"dock": {"k": "typo"}})
    pair.same("POST", "/d/_update/6", {"doc": {"k": "c"}},
              query={"if_seq_no": "0", "if_primary_term": "1"})
    pair.same("POST", "/d/_update/6",
              {"script": {"source": "ctx._source.n += 1"}})
    # _mget
    pair.same("POST", "/d/_mget", {"ids": ["1", "4", "5", "nope", "u1"]})
    pair.same("GET", "/_mget", {"docs": [
        {"_index": "d", "_id": "2", "_source": ["k"]},
        {"_index": "d", "_id": "3", "_source": False},
        {"_index": "nope", "_id": "1"}]})
    pair.same("POST", "/_mget", {"docs": [{"_id": "1"}, {"_index": "d"}]})
    pair.same("POST", "/_mget", {})
    pair.same("POST", "/d/_mget", {"ids": ["2", "6"]},
              query={"_source": "n"})
    # refresh=wait_for makes the write searchable, without forced_refresh
    pair.same("PUT", "/d/_doc/w", {"v": _vec(rng), "k": "wait"},
              query={"refresh": "wait_for"})
    pair.same("POST", "/d/_search", {"query": {"term": {"k": "wait"}}})
    pair.same("POST", "/d/_refresh")
    for _ in range(3):
        pair.same("POST", "/d/_search", {"knn": {
            "field": "v", "query_vector": _vec(rng), "k": 20,
            "num_candidates": 50}, "size": 20})
    pair.same("POST", "/d/_search", {"query": {"match": {"t": "shared"}}})
    pair.same("POST", "/d/_count")
    pair.same("POST", "/d/_count", {"query": {"term": {"k": "k1"}}})


@pytest.mark.parametrize("shards", [1, 3])
def test_bulk_all_actions(pair, shards):
    rng = np.random.default_rng(10 + shards)
    pair.same("PUT", "/b", _mapping(shards))
    ops = []
    for i in range(12):
        ops += [{"index": {"_id": str(i)}}, {"v": _vec(rng), "k": "a", "n": i}]
    pair.same("POST", "/b/_bulk", ops, ndjson=True)
    ops = [
        {"index": {"_id": "0"}}, {"v": _vec(rng), "k": "re"},
        {"create": {"_id": "1"}}, {"v": _vec(rng)},          # exists: 409
        {"create": {"_id": "c"}}, {"v": _vec(rng), "k": "new"},
        # key `index`; into one-shard `b2`, so its seq_no is fixed
        {"index": {"_index": "b2"}}, {"k": "auto"},
        {"index": {"_id": "bad"}}, {"v": [1.0, 2.0]},        # parse: 400
        {"delete": {"_id": "2"}},
        {"delete": {"_id": "2"}},                            # missing: 404
        {"update": {"_id": "3"}}, {"doc": {"k": "upd", "n": 30}},
        {"update": {"_id": "3"}}, {"doc": {"k": "upd"}},     # noop
        {"update": {"_id": "nope"}}, {"doc": {"k": "x"}},    # missing
        {"update": {"_id": "u", "_source": True}},
        {"doc": {"k": "u"}, "doc_as_upsert": True},
        {"index": {"_id": "4", "if_seq_no": 0, "if_primary_term": 1}},
        {"v": _vec(rng)},
        {"index": {"_id": "5", "version": 7, "version_type": "external"}},
        {"v": _vec(rng), "k": "ext"},
        {"index": {"_index": "b2", "_id": "z"}}, {"k": "other index"},
        {"delete": {"_index": "nope", "_id": "1"}},
        {"index": {"_id": "6"}}, {"v": _vec(rng), "k": "tail"},
        {"create": {"_id": "6"}}, {"v": _vec(rng)},          # same run: 409
        # last: an auto id routes at random, and its failed parse takes a
        # seq_no on its shard
        {"index": {}}, {"v": [3.0]},                         # `_id` null
    ]
    pair.same("POST", "/b/_bulk", ops, ndjson=True,
              query={"refresh": "true"})
    pair.same("POST", "/b/_search", {"query": {"bool": {"filter": [
        {"terms": {"k": ["re", "new", "auto", "upd", "u", "ext", "tail"]}}]}},
        "size": 20})
    pair.same("POST", "/b/_count")
    pair.same("POST", "/b/_search", {"knn": {
        "field": "v", "query_vector": _vec(rng), "k": 10}})
    # a malformed action line fails the whole request before any item runs
    for bad in ([{"index": {"_id": "m"}}, {"k": "m"}, {"bogus": {}}],
                [{"index": {"_id": "m"}, "x": 1}, {"k": "m"}],
                [{"delete": {"_id": "m", "_version": 2}}]):
        pair.same("POST", "/b/_bulk", bad, ndjson=True)
    pair.same("GET", "/b/_doc/m")


@pytest.mark.parametrize("shards", [1, 3])
def test_knn_after_deletes_and_updates(pair, shards):
    rng = np.random.default_rng(20 + shards)
    vecs = rng.standard_normal((300, D)).astype(np.float32)
    pair.same("PUT", "/k", _mapping(shards))
    ops = []
    for i, v in enumerate(vecs):
        ops += [{"index": {"_id": str(i)}}, {"v": v.tolist(), "k": "a"}]
    pair.same("POST", "/k/_bulk", ops, ndjson=True)
    pair.same("POST", "/k/_refresh")
    queries = rng.standard_normal((6, D)).astype(np.float32)
    near = {int(h["_id"]) for q in queries for h in pair.port(
        "POST", "/k/_search", {"knn": {"field": "v", "query_vector":
                                       q.tolist(), "k": 5}})[1]
        ["hits"]["hits"]}
    deleted = sorted(near)[::2] + list(range(0, 300, 17))
    ops = [{"delete": {"_id": str(i)}} for i in dict.fromkeys(deleted)]
    moved = [i for i in range(1, 300, 23) if i not in deleted]
    for j, i in enumerate(moved):
        ops += [{"update": {"_id": str(i)}},
                {"doc": {"v": queries[j % len(queries)].tolist()}}]
    pair.same("POST", "/k/_bulk", ops, ndjson=True)
    pair.same("POST", "/k/_refresh")
    gone = {str(i) for i in deleted}
    for q in queries:
        body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                        "num_candidates": 50}, "size": 10}
        _, got = pair.same("POST", "/k/_search", body)
        assert not gone & set(hit_ids(got))
    pair.same("POST", "/k/_count")


def test_fault_url_parameters(pair):
    """`from` on `_search`, `_source` on GET, the conditional writes,
    `refresh=wait_for` and `filter_path` are served; `q` (with `df`
    and `lenient`) as the reference answers it."""
    pair.same("PUT", "/u", _mapping(1))
    for i in range(6):
        pair.same("PUT", f"/u/_doc/{i}", {"k": "a", "n": i})
    pair.same("POST", "/u/_refresh")
    pair.same("POST", "/u/_search", {"query": {"term": {"k": "a"}}},
              query={"from": "2", "size": "2"})
    pair.same("GET", "/u/_doc/1", query={"_source": "n"})
    pair.same("PUT", "/u/_doc/1", {"k": "b"},
              query={"if_seq_no": "0", "if_primary_term": "1"})
    pair.same("PUT", "/u/_doc/2", {"k": "b"},
              query={"version": "5", "version_type": "external"})
    pair.same("PUT", "/u/_doc/9", {"k": "late"},
              query={"refresh": "wait_for"})
    pair.same("POST", "/u/_search", {"query": {"term": {"k": "late"}}})
    pair.same("POST", "/u/_search", {},
              query={"filter_path": "hits.total,hits.hits._id"})
    pair.same("POST", "/nope/_search", {},
              query={"filter_path": "error.type,status"})
    for query in ({"q": "k:a"}, {"df": "k"}, {"q": "a", "lenient": "true"}):
        pair.same("GET", "/u/_search", query=query)
        pair.same("GET", "/u/_count", query=query)


def test_fault_track_total_hits(pair):
    pair.same("PUT", "/t", _mapping(3))
    for i in range(12):
        pair.same("PUT", f"/t/_doc/{i}", {"k": "a", "n": i})
    pair.same("POST", "/t/_refresh")
    for tth in (False, -1, True, 5, 100, -5):
        pair.same("POST", "/t/_search", {"query": {"term": {"k": "a"}},
                                         "track_total_hits": tth})
    for tth in ("false", "-1", "3", "-2"):
        pair.same("POST", "/t/_search", {"query": {"term": {"k": "a"}}},
                  query={"track_total_hits": tth})


def test_fault_max_result_window(pair):
    create = _mapping(1)
    create["settings"]["index.max_result_window"] = 20
    pair.same("PUT", "/w", create)
    rng = np.random.default_rng(3)
    for i in range(30):
        pair.same("PUT", f"/w/_doc/{i}", {"v": _vec(rng), "k": "a",
                                          "t": "hello there"})
    pair.same("POST", "/w/_refresh")
    pair.same("POST", "/w/_search", {"from": 15, "size": 5})
    pair.same("POST", "/w/_search", {"from": 15, "size": 10})
    pair.same("POST", "/w/_search", {"size": 21})
    knn = {"field": "v", "query_vector": _vec(rng), "k": 5}
    # a fusion window counts where the reference runs a query phase of it
    for window in (None, 20):
        rrf = {} if window is None else {"rank_window_size": window}
        s1, _ = pair.ref("POST", "/w/_search", {
            "query": {"term": {"k": "a"}}, "knn": knn,
            "rank": {"rrf": rrf}})
        s2, got = pair.port("POST", "/w/_search", {
            "query": {"term": {"k": "a"}}, "knn": knn,
            "rank": {"rrf": rrf}})
        assert s1 == s2 == (400 if window is None else 200)
        if s2 == 400:
            assert "[index.max_result_window]" in got["error"]["reason"]


def test_fault_bulk_item_key(pair):
    pair.same("PUT", "/k", _mapping(1))
    ops = [{"index": {}}, {"k": "a"}, {"index": {"_id": "x"}}, {"k": "b"},
           {"create": {}}, {"k": "c"}]
    want, got = pair.same("POST", "/k/_bulk", ops, ndjson=True)
    assert [next(iter(i)) for i in got["items"]] == \
        ["index", "index", "create"]
    # the auto-id item wrote with create semantics
    assert got["items"][0]["index"]["result"] == "created"


def test_fault_already_exists_reason(pair):
    pair.same("PUT", "/i1", _mapping(1))
    _, got = pair.same("PUT", "/i1", _mapping(1))
    assert got["error"]["reason"] == "index [i1] already exists"
    for name in ("I1", "_x", "-x", "a,b", "a*b", "..", "x" * 256):
        _, got = pair.same("PUT", f"/{name}", _mapping(1))
        assert got["error"]["type"] == "invalid_index_name_exception"


@pytest.mark.parametrize("shards", [1, 3])
def test_fault_terms_lookup(pair, shards):
    """A `terms` lookup (the values at `path` of one stored document) was
    the port's 400 ("requires an array of values"); the reference inlines
    the document's values on the coordinator. In `query`, beside a
    `knn`, in a `filter` aggregation, on `_count` and `_msearch`, with
    `routing`; a missing document or path matches nothing, an unknown
    index is the reference's 404."""
    rng = np.random.default_rng(20 + shards)
    pair.same("PUT", "/a", {"settings": {"number_of_shards": shards},
                            "mappings": {"properties": {
                                "user": {"type": "keyword"},
                                "followers": {"type": "keyword"},
                                "n": {"type": "long"},
                                "v": {"type": "dense_vector", "dims": D,
                                      "similarity": "cosine"}}}})
    pair.same("PUT", "/b", {"settings": {"number_of_shards": shards}})
    users = [f"u{i}" for i in range(40)]
    ops = []
    for i, u in enumerate(users):
        ops += [{"index": {"_id": u}},
                {"user": u, "n": i, "v": _vec(rng),
                 "followers": list(rng.choice(users, 3, replace=False))}]
    pair.same("POST", "/a/_bulk", ops, ndjson=True)
    pair.same("PUT", "/b/_doc/b1", {"followers": users[::3],
                                    "deep": {"list": ["u1", "u2"]},
                                    "one": "u7"})
    pair.same("PUT", "/b/_doc/b2", {"followers": users[5:9]},
              query={"routing": "r1"})
    pair.same("POST", "/a,b/_refresh")
    lookup = {"index": "b", "id": "b1", "path": "followers"}
    want, got = pair.same("POST", "/a/_search", {
        "query": {"terms": {"user": lookup}}, "size": 50})
    assert len(hit_ids(got)) == len(users[::3])
    for terms in ({"user": dict(lookup, path="deep.list")},
                  {"user": dict(lookup, path="one"), "boost": 2.0},
                  {"user": dict(lookup, path="missing")},
                  {"user": dict(lookup, id="nope")},
                  {"user": {"index": "b", "id": "b2", "path": "followers",
                            "routing": "r1"}},
                  {"followers": lookup}):
        pair.same("POST", "/a/_search", {"query": {"terms": terms},
                                         "size": 50})
    pair.same("POST", "/a/_search", {"query": {"bool": {"filter": [
        {"terms": {"user": lookup}}], "must_not": [
        {"terms": {"followers": dict(lookup, path="deep.list")}}]}},
        "size": 50})
    pair.same("POST", "/a/_search", {
        "knn": {"field": "v", "query_vector": _vec(rng), "k": 5,
                "num_candidates": 20},
        "query": {"terms": {"user": lookup}}, "size": 8})
    pair.same("POST", "/a/_search", {"size": 0, "aggs": {"f": {
        "filter": {"terms": {"user": lookup}},
        "aggs": {"s": {"sum": {"field": "n"}}}}}})
    pair.same("POST", "/a/_count", {"query": {"terms": {"user": lookup}}})
    pair.same("POST", "/_msearch", [
        {"index": "a"}, {"query": {"terms": {"user": lookup}}},
        {"index": "a"}, {"query": {"terms": {"user": dict(
            lookup, index="nope")}}}], ndjson=True)
    pair.same("POST", "/a/_search", {"query": {"terms": {"user": dict(
        lookup, index="nope")}}})
    pair.same("POST", "/a/_count", {"query": {"terms": {"user": dict(
        lookup, index="nope")}}})


def test_engine_get_reads_the_sealed_row(pair, monkeypatch):
    """A realtime GET of a sealed row locates its segment by the segments'
    bases; it builds no reader over the shard."""
    pair.same("PUT", "/g", _mapping(1))
    for i in range(5):
        pair.same("PUT", f"/g/_doc/{i}", {"k": str(i)})
        pair.same("POST", "/g/_refresh")
    pair.same("PUT", "/g/_doc/b", {"k": "buffered"})

    def no_reader(*a, **kw):
        raise AssertionError("Engine.get built a reader")

    monkeypatch.setattr(engine_mod, "ShardReader", no_reader)
    monkeypatch.setattr(engine_mod, "SegmentView", no_reader)
    for i in ("0", "3", "4", "b"):
        pair.same("GET", f"/g/_doc/{i}")
    pair.same("DELETE", "/g/_doc/3")
    pair.same("GET", "/g/_doc/3")


def test_update_keeps_block_ingested_vector(pair):
    """A document ingested as a vector block renders `_source` from the
    block: a `doc` update of another field keeps its vector."""
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((40, D)).astype(np.float32)
    pair.port("PUT", "/blk", _mapping(3))
    svc = pair.port_node.index("blk")
    svc.index_many([str(i) for i in range(40)], vectors={"v": vecs})
    pair.port("POST", "/blk/_refresh")
    status, resp = pair.port("POST", "/blk/_update/7", {"doc": {"k": "t"}})
    assert status == 200 and resp["result"] == "updated"
    pair.port("POST", "/blk/_refresh")
    status, doc = pair.port("GET", "/blk/_doc/7")
    assert doc["_source"]["k"] == "t"
    np.testing.assert_array_equal(np.asarray(doc["_source"]["v"],
                                             dtype=np.float32), vecs[7])
    _, hits = pair.port("POST", "/blk/_search", {"knn": {
        "field": "v", "query_vector": vecs[7].tolist(), "k": 1}})
    assert hit_ids(hits) == ["7"]
    assert hits["hits"]["hits"][0]["_source"]["k"] == "t"


def test_engine_create_batch_equals_one_at_a_time():
    """A `create` batch with vector and token blocks, some ids live, some
    repeated: the conflicting documents take no seq_no and no row, and the
    rest index as the same documents written one at a time do."""
    from elasticsearch_tpu_torch.common.errors import VersionConflictError
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.mapping import MapperService

    mapping = {"properties": {
        "v": {"type": "dense_vector", "dims": 4},
        "tok": {"type": "rank_vectors", "dims": 4},
        "k": {"type": "keyword"}}}
    rng = np.random.default_rng(11)
    ids = ["a", "x", "b", "y", "x", "z"]
    vecs = rng.standard_normal((len(ids), 4)).astype(np.float32)
    counts = np.array([2, 0, 1, 3, 1, 2])
    toks = rng.standard_normal((int(counts.sum()), 4)).astype(np.float32)
    batch, single = (Engine(MapperService(mapping)) for _ in range(2))
    for eng in (batch, single):
        eng.index_many(["a", "b"], [{"k": "old"}, {"k": "old"}])
    got = batch.index_many(ids, [{"k": i} for i in ids],
                           vectors={"v": vecs},
                           token_vectors={"tok": (toks, counts)},
                           op_type="create")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    want = []
    for j, doc_id in enumerate(ids):
        src = {"k": doc_id, "v": vecs[j].tolist()}
        if counts[j]:
            src["tok"] = toks[offsets[j]:offsets[j + 1]].tolist()
        try:
            want.append(single.index(doc_id, src, op_type="create"))
        except VersionConflictError as e:
            want.append(e)
    assert [type(r) for r in got] == [type(r) for r in want]
    assert [str(r) for r in got if isinstance(r, Exception)] == \
        [str(r) for r in want if isinstance(r, Exception)]
    assert [r[:5] for r in got if not isinstance(r, Exception)] == \
        [r[:5] for r in want if not isinstance(r, Exception)]
    for eng in (batch, single):
        eng.refresh()
    for doc_id in ("a", "b", "x", "y", "z"):
        assert batch.get(doc_id) == single.get(doc_id)
