"""One node holding indices of 1 to 1024 shards on one card (port of the
served slices of `elasticsearch_tpu/node.py`): index create (with
`number_of_shards` and the `index.knn.*` engine settings), document writes
and realtime GET routed to a shard by `routing` or `_id`, `_bulk`, refresh,
`_search` with `knn` (one spec or a list, each with an optional filter)
and / or a `query` of the ported kinds (filters and BM25 text queries)
over every shard, and hybrid `rank: {rrf}` searches (one `HybridExecutor`
per index, whose BM25 and late-interaction stores read the index's
combined reader, so BM25 scores with corpus-wide statistics), with the
reference's response shapes.

The node's search caches (`search/caches.py::NodeCaches`) sit in front of
the query phase, in the reference's order: the can_match pre-filter when
the request names `pre_filter_shard_size`, then the device rung of the
shard request cache for a kNN-bearing or hybrid body (on unless the node
setting `search.request_cache.device_paths` is false), else its host rung
for a `size: 0` or opted-in body; the node query cache serves every
search context's `bool` filter clauses. `_cache/clear` and the `query_cache` /
`request_cache` index stats read them."""

from __future__ import annotations

import copy
import difflib
import itertools
import json
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.cluster.routing import shard_ids_for
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, IndexNotFoundError, ResourceAlreadyExistsError,
    SearchEngineError,
)
from elasticsearch_tpu_torch.indices.service import (  # noqa: F401
    SHARD_ROW_SPACE, IndexService, flat_settings, validate_knn_settings,
)
from elasticsearch_tpu_torch.search.caches import (
    NodeCaches, can_match, reader_fingerprint,
)
from elasticsearch_tpu_torch.search.hybrid_plan import HybridExecutor
from elasticsearch_tpu_torch.search.queries import SearchContext
from elasticsearch_tpu_torch.search.service import (
    execute_fetch_phase, execute_query_phase,
)
from elasticsearch_tpu_torch.serving.batcher import CombiningBatcher

_SHARDS_OK = {"total": 1, "successful": 1, "failed": 0}
# the index stats metrics of the reference (`RestIndicesStatsAction`);
# the port serves the two cache sections
_STATS_METRICS = (
    "docs", "store", "indexing", "get", "search", "merge", "refresh",
    "flush", "warmer", "query_cache", "fielddata", "completion",
    "segments", "translog", "request_cache", "recovery", "bulk")
_PORTED_STATS = ("query_cache", "request_cache")
# a `_bulk` item whose document failed to parse: it takes a seq_no only
_PARSE_FAILED = "parse_failed"


class _MultiShardVectorStore:
    """Scatter-gather kNN over an index's shards (the host-coordinated path
    of the reference's `_MultiShardVectorStore`): each shard's store
    searches its own rows, and a stable host merge of the concatenation in
    shard order takes the top k, so ties break by shard. Filter rows and
    hit rows live in the combined reader's space; each shard's store sees
    its own rows only (`filter_rows` split by range, less the offset).

    Concurrent `search` calls coalesce in the index's one combining
    batcher, and a batch launches each of its (field, k, precision,
    num_candidates, reader) groups on every shard (`search_many_async`)
    before any lands: one launch a shard a group, and one runner at a time
    drives the card, where requests walking the shards' batchers on their
    own threads would stall on each other's device waits.

    Left out, as ROADMAP.md lists: the mesh path (one program over a device
    mesh), the cost model's host route, and `_ShardScopedStore` (the retry
    after a shard fails)."""

    def __init__(self, svc: IndexService):
        self.svc = svc
        # looked up at each batch, so a wrapper set on the instance
        # (a probe of the batch sizes) sees every dispatch
        self._batcher = CombiningBatcher(
            lambda requests: self._dispatch_batch(requests),
            lambda handle: self._finalize_batch(handle))
        # per-thread phases of the last search (`last_knn_phases`)
        self._tls = threading.local()

    def field(self, name: str):
        for shard in self.svc.shards:
            fc = shard.vector_store.field(name)
            if fc is not None:
                return fc
        return None

    @staticmethod
    def _shard_rows(rows, offset: int):
        """The rows of a sorted combined-space array that fall in the shard
        at `offset`, as that shard's rows."""
        if rows is None:
            return None
        rows = np.asarray(rows, dtype=np.int64)
        lo, hi = np.searchsorted(rows, [offset, offset + SHARD_ROW_SPACE])
        return rows[lo:hi] - offset

    def _parts(self, reader):
        """(shard, its row offset, its reader) for each shard; the shard
        readers are the ones `reader` (a combined reader) was made from."""
        shard_readers = getattr(reader, "shard_readers", None)
        for shard in self.svc.shards:
            yield (shard, shard.shard_id * SHARD_ROW_SPACE,
                   None if shard_readers is None
                   else shard_readers[shard.shard_id])

    def search(self, field: str, query_vector, k: int, filter_rows=None,
               precision: str = "bf16", num_candidates=None, reader=None):
        """Top-k over every shard: (rows, raw scores) in the combined
        space."""
        result, self._tls.phases = self._batcher.submit((
            (field, k, precision, num_candidates),
            np.asarray(query_vector, dtype=np.float32), filter_rows, reader))
        return result

    def _dispatch_batch(self, requests: list):
        """Dispatch stage of a batch of (key, vector, filter rows, reader)
        requests: each group of one key and one reader launched on every
        shard."""
        groups: Dict[tuple, tuple] = {}
        for i, (key, _, _, reader) in enumerate(requests):
            groups.setdefault((key, id(reader)), (key, reader, []))[2] \
                .append(i)
        return len(requests), [
            (idx, self.search_many_async(
                field, [requests[i][1] for i in idx], k, precision=precision,
                num_candidates=num_candidates,
                filter_rows=[requests[i][2] for i in idx], reader=reader))
            for (field, k, precision, num_candidates), reader, idx
            in groups.values()]

    def _finalize_batch(self, handle) -> list:
        n, groups = handle
        out: List[Optional[tuple]] = [None] * n
        for idx, h in groups:
            results, phases = self._land(h)
            for i, res in zip(idx, results):
                out[i] = (res, dict(phases))
        return out

    def scheduler_stats(self) -> Dict[str, int]:
        """The index batcher's counters."""
        return dict(self._batcher.sched)

    def search_many(self, field: str, queries, k: int,
                    precision: str = "bf16", num_candidates=None,
                    filter_rows=None, reader=None) -> list:
        results, self._tls.phases = self._land(self.search_many_async(
            field, queries, k, precision=precision,
            num_candidates=num_candidates, filter_rows=filter_rows,
            reader=reader))
        return results

    def search_many_async(self, field: str, queries, k: int,
                          precision: str = "bf16", num_candidates=None,
                          filter_rows=None, reader=None):
        """Launch the batch on every shard before landing any: an exhaustive
        shard's boards stay in flight while the next shard launches (an IVF
        shard completes at its launch)."""
        handles = []
        for shard, offset, shard_reader in self._parts(reader):
            frows = None if filter_rows is None else [
                self._shard_rows(fr, offset) for fr in filter_rows]
            handles.append((shard, offset, shard.vector_store
                            .search_many_async(
                                field, queries, k, precision=precision,
                                num_candidates=num_candidates,
                                filter_rows=frows, reader=shard_reader)))
        return len(queries), k, handles

    def finalize_many(self, handle) -> list:
        return self._land(handle)[0]

    def _land(self, handle):
        """Land every shard's part of a batch and merge each query's hits;
        returns (results, the first shard's phases)."""
        n, k, handles = handle
        per_shard, phases = [], None
        for shard, offset, h in handles:
            per_shard.append([(rows + offset, scores) for rows, scores in
                              shard.vector_store.finalize_many(h)])
            if phases is None:
                phases = shard.vector_store.last_knn_phases
        return [self._merge([ps[qi] for ps in per_shard], k)
                for qi in range(n)], phases or {}

    @staticmethod
    def _merge(results, k: int):
        if len(results) == 1:       # one shard: its store's answer as is
            return results[0]
        rows = np.concatenate([r for r, _ in results])
        scores = np.concatenate([s for _, s in results])
        # global top-k with shard-order tie-break (stable sort over concat)
        order = np.argsort(-scores, kind="stable")[:k]
        return rows[order], scores[order]

    @property
    def last_knn_phases(self) -> dict:
        """The first shard's phases of the last search made on the calling
        thread."""
        return getattr(self._tls, "phases", {})


class Node:
    def __init__(self, device="cuda", node_name: str = "node-0",
                 settings: Optional[dict] = None):
        self.device = resolve_device(device)
        self.node_name = node_name
        self.node_id = uuid.uuid4().hex[:22]
        # node settings (flat keys); read at each use, as the reference
        # reads its node settings
        self.settings: Dict[str, object] = dict(settings or {})
        self.caches = NodeCaches()
        self.indices: Dict[str, IndexService] = {}
        # index name -> its hybrid executor (plan cache + late-interaction
        # store), made at the index's first hybrid search
        self._hybrid: Dict[str, HybridExecutor] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------------- indices
    def create_index(self, name: str, body: Optional[dict]) -> dict:
        body = body or {}
        if name != name.lower() or name.startswith(("_", "-", "+")):
            raise IllegalArgumentError(f"invalid index name [{name}]")
        settings = flat_settings(body.get("settings"))
        with self._lock:
            if name in self.indices:
                svc = self.indices[name]
                raise ResourceAlreadyExistsError(
                    f"index [{name}/{svc.uuid}] already exists", index=name)
            svc = IndexService(name, body.get("mappings"), self.device,
                               settings=settings)
            svc.vector_store = _MultiShardVectorStore(svc)
            self.indices[name] = svc
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundError(name)
        return svc

    def _index_or_autocreate(self, name: str) -> IndexService:
        if name not in self.indices:
            try:
                self.create_index(name, None)
            except ResourceAlreadyExistsError:
                pass  # raced: another writer created it
        return self.indices[name]

    # ------------------------------------------------------------ documents
    @staticmethod
    def _write_response(svc, res) -> dict:
        return {"_index": svc.name, "_id": res.doc_id,
                "_version": res.version, "result": res.result,
                "_shards": dict(_SHARDS_OK), "_seq_no": res.seq_no,
                "_primary_term": res.primary_term}

    def index_doc(self, index: str, doc_id: Optional[str], body: dict,
                  op_type: str = "index", refresh: Optional[str] = None,
                  routing: Optional[str] = None) -> dict:
        svc = self._index_or_autocreate(index)
        if doc_id is None:
            doc_id, op_type = uuid.uuid4().hex[:20], "create"
        shard = svc.route(str(doc_id), routing)
        res = shard.engine.index(str(doc_id), body, op_type=op_type,
                                 routing=routing)
        out = self._write_response(svc, res)
        if refresh in ("true", ""):
            # a doc-level refresh refreshes only the target shard: the
            # other shards' unrefreshed writes stay invisible
            shard.engine.refresh()
            out["forced_refresh"] = True
        return out

    def get_doc(self, index: str, doc_id: str,
                routing: Optional[str] = None) -> dict:
        svc = self.index(index)
        doc = svc.route(doc_id, routing).engine.get(doc_id)
        if doc is None:
            return {"_index": svc.name, "_id": doc_id, "found": False}
        out = {"_index": svc.name, "_id": doc_id,
               "_version": doc["_version"], "_seq_no": doc["_seq_no"],
               "_primary_term": doc["_primary_term"], "found": True}
        if svc.mapper_service.source_enabled:
            out["_source"] = doc["_source"]
        if doc.get("_routing") is not None:
            out["_routing"] = doc["_routing"]
        return out

    def bulk(self, ops: List[dict], default_index: Optional[str] = None,
             refresh: Optional[str] = None) -> dict:
        """`index` and `create` actions, each with an optional `routing`.
        Each document is validated on its own (a bad one fails its item
        only, and takes a seq_no on its shard in the request's order, as
        in the reference); the valid documents of one index are routed in one
        `shard_ids_for` call, and each run of one action among a shard's
        documents goes to that shard's engine in one `index_many`."""
        start = time.perf_counter()
        items: List[Optional[dict]] = []
        valid: Dict[str, list] = {}
        i = 0
        while i < len(ops):
            action = ops[i]
            if not isinstance(action, dict) or len(action) != 1:
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{i + 1}], expected "
                    f"a simple value for field [_index] but found "
                    f"[{action!r}]")
            (op, meta), = action.items()
            meta = meta or {}
            if op not in ("index", "create"):
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{i + 1}], expected "
                    f"one of [create, index] but found [{op}]")
            for dep in ("_version", "_routing", "_parent", "fields",
                        "_version_type", "_retry_on_conflict"):
                if dep in meta:
                    raise IllegalArgumentError(
                        f"Action/metadata line [{i + 1}] contains an "
                        f"unknown parameter [{dep}]")
            source = ops[i + 1] if i + 1 < len(ops) else None
            i += 2
            name = meta.get("_index", default_index)
            slot = len(items)
            items.append(None)
            try:
                if name is None:
                    raise IllegalArgumentError("index is missing")
                if not isinstance(source, dict):
                    raise IllegalArgumentError(
                        "the bulk request must be terminated by a newline")
                svc = self._index_or_autocreate(name)
                doc_id = meta.get("_id")
                doc_id = uuid.uuid4().hex[:20] if doc_id is None \
                    else str(doc_id)
                routing = meta.get("routing")
                routing = None if routing is None else str(routing)
                try:
                    svc.mapper_service.parse_document(source)
                except SearchEngineError:
                    # the primary gives a document its seq_no before it
                    # parses it: a failed parse still takes one
                    valid.setdefault(name, []).append(
                        (_PARSE_FAILED, slot, doc_id, None, routing))
                    raise
                if meta.get("_id") is None:
                    op = "create"
                valid.setdefault(name, []).append(
                    (op, slot, doc_id, source, routing))
            except SearchEngineError as e:
                items[slot] = {op: {"_index": name, "_id": meta.get("_id"),
                                    "status": e.status, "error": e.to_dict()}}
        runs: List[tuple] = []
        for name, docs in valid.items():
            shards = shard_ids_for(
                [d[2] if d[4] is None else d[4] for d in docs],
                self.indices[name].num_shards)
            by_shard: Dict[int, list] = {}
            for doc, shard in zip(docs, shards.tolist()):
                by_shard.setdefault(shard, []).append(doc)
            # a shard applies its documents in the request's order (its
            # seq_nos follow it), one `index_many` a run of one action
            for shard, mine in by_shard.items():
                for op, run in itertools.groupby(mine, key=lambda d: d[0]):
                    runs.append((name, op, shard,
                                 [tuple(d[1:]) for d in run]))
        for name, op, shard, docs in runs:
            svc = self.indices[name]
            if op == _PARSE_FAILED:
                for _ in docs:
                    svc.shards[shard].engine.fail_seq_no()
                continue
            status = 201
            try:
                results = svc.shards[shard].engine.index_many(
                    [d[1] for d in docs], [d[2] for d in docs],
                    op_type=op, routings=[d[3] for d in docs])
            except SearchEngineError as e:
                for slot, doc_id, _, _ in docs:
                    items[slot] = {op: {"_index": name, "_id": doc_id,
                                        "status": e.status,
                                        "error": e.to_dict()}}
                continue
            for (slot, _, _, _), res in zip(docs, results):
                resp = self._write_response(svc, res)
                resp["status"] = status if res.result == "created" else 200
                items[slot] = {op: resp}
        if refresh in ("true", ""):
            for name in {run[0] for run in runs}:
                self.indices[name].refresh()
        return {"took": int((time.perf_counter() - start) * 1000),
                "errors": any("error" in next(iter(it.values()))
                              for it in items),
                "items": items}

    def refresh(self, index: str) -> dict:
        svc = self.index(index)
        svc.refresh()
        n = svc.num_shards
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    # --------------------------------------------------------------- search
    def _hybrid_executor(self, svc: IndexService) -> HybridExecutor:
        with self._lock:
            ex = self._hybrid.get(svc.name)
            if ex is None:
                ex = self._hybrid[svc.name] = HybridExecutor(
                    svc, self.device, query_cache=self.caches.query)
            return ex

    def _device_request_cache_enabled(self) -> bool:
        """`search.request_cache.device_paths` (default on): the device
        rung of the shard request cache, for kNN query phases and hybrid
        responses. The reference's dynamic cluster setting of the same
        name waits for `_cluster/settings`."""
        v = self.settings.get("search.request_cache.device_paths")
        return v is None or str(v).lower() != "false"

    def _request_cache_for(self, body: dict, hybrid: bool = False):
        """The rung of the shard request cache a body goes through, or
        None. The device rung claims every body whose query phase runs on
        the card (kNN-bearing or hybrid), so the host rung keeps `size: 0`
        and opted-in bodies; a hybrid body never takes the host rung."""
        if self._device_request_cache_enabled() \
                and self.caches.device_request.device_cacheable(body):
            return self.caches.device_request
        if not hybrid and self.caches.request.cacheable_tracked(body):
            return self.caches.request
        return None

    @staticmethod
    def _request_cache_key(cache, svc: IndexService, reader,
                           body: dict) -> tuple:
        """The index's name, its uuid (a recreated index of the same name
        reuses segment ids) and its settings, the reader's content
        fingerprint (a refresh that changed a shard misses), and the
        body."""
        settings = json.dumps(svc.settings, sort_keys=True, default=str)
        return cache.key((svc.name, svc.uuid, settings),
                         reader_fingerprint(reader), body)

    def _search_rrf(self, svc: IndexService, body: dict) -> dict:
        """Reciprocal-rank fusion of the body's sub-searches through the
        index's hybrid executor (one dispatch per leg group, RRF, fetch of
        the final window), behind the device rung of the request cache: a
        body the rung holds is answered with a copy of its stored
        response, `took` 0, with no batch slot and no launch; a miss
        stores a copy of its response without `took`. The reference
        serves a `profile` body uncached; the port answers `profile` with
        a 400, so that bypass has no caller yet."""
        ex = self._hybrid_executor(svc)
        cache = self._request_cache_for(body, hybrid=True)
        if cache is None:
            return ex.submit(body)
        key = self._request_cache_key(cache, svc, svc.combined_reader(), body)
        cached = cache.get(key)
        if cached is not None:
            resp = copy.deepcopy(cached)
            resp["took"] = 0
            return resp
        resp = ex.submit(body)
        cache.put(key, copy.deepcopy(
            {k: v for k, v in resp.items() if k != "took"}))
        return resp

    def search(self, index: str, body: Optional[dict],
               pre_filter_shard_size: Optional[int] = None) -> dict:
        """`_search` on one index. With `pre_filter_shard_size` (the URL
        parameter) a body with a query first runs can_match, and an index
        it proves empty is skipped whole: its shards count as `skipped`
        and no query phase runs. The query phase's result comes from the
        shard request cache when it holds the body; the fetch runs every
        time."""
        start = time.perf_counter()
        svc = self.index(index)
        body = body or {}
        rank = body.get("rank")
        if isinstance(rank, dict) and "rrf" in rank:
            return self._search_rrf(svc, body)
        reader = svc.combined_reader()
        n = svc.num_shards
        skipped = 0
        if pre_filter_shard_size is not None \
                and body.get("query") is not None \
                and not can_match(reader, body):
            skipped = n
            hits = {"total": {"value": 0, "relation": "eq"},
                    "max_score": None, "hits": []}
        else:
            hits = self._query_then_fetch(svc, reader, body)
        return {"took": int((time.perf_counter() - start) * 1000),
                "timed_out": False,
                "_shards": {"total": n, "successful": n, "skipped": skipped,
                            "failed": 0},
                "hits": hits}

    def _query_then_fetch(self, svc: IndexService, reader, body: dict) -> dict:
        """The query phase through the request cache's rung for the body
        (`_request_cache_for`), then the fetch."""
        cache = self._request_cache_for(body)
        key = result = None
        if cache is not None:
            key = self._request_cache_key(cache, svc, reader, body)
            result = cache.get(key)
        if result is None:
            ctx = SearchContext(reader, svc.mapper_service, svc.vector_store,
                                svc.settings, query_cache=self.caches.query)
            result = execute_query_phase(ctx, body)
            if key is not None:
                cache.put(key, result)
        return execute_fetch_phase(reader, svc.mapper_service, svc.name, body,
                                   result)

    # ---------------------------------------------------------------- caches
    def _resolve(self, name: Optional[str]) -> List[IndexService]:
        """The indices a stats or cache request names: every index for
        None or `_all`, else each of a comma-separated list."""
        if name is None or name in ("_all", "*"):
            return list(self.indices.values())
        return [self.index(part.strip()) for part in name.split(",")
                if part.strip()]

    def clear_cache(self, name: Optional[str] = None) -> dict:
        """`POST [/{index}]/_cache/clear`: drop the host rung of the
        request cache and the query cache, node-wide, as the reference
        does; the device rung stays (its entries are keyed on the reader's
        content, so none can be stale)."""
        services = self._resolve(name)
        self.caches.request.clear()
        self.caches.query.clear()
        n = sum(len(svc.shards) for svc in services)
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    def index_stats(self, name: Optional[str], metrics: List[str]) -> dict:
        """`GET [/{index}]/_stats/{metric}` for the `query_cache` and
        `request_cache` metrics, in the reference's shape: each index's
        sections read 0, and `_all` carries the node's caches (the request
        cache summing both rungs). `_shards.total` counts each shard's
        configured copies, `index.number_of_replicas` (default 1) beside
        the primary, as the reference counts them. Any other metric is a
        400 until the rest of the stats are ported."""
        keep = set()
        for m in metrics:
            if m in _PORTED_STATS:
                keep.add(m)
            elif m in _STATS_METRICS or m in ("_all", "*"):
                raise IllegalArgumentError(
                    f"[_stats/{m}] is not supported by this build: only "
                    f"[{', '.join(_PORTED_STATS)}] are ported")
            else:
                close = difflib.get_close_matches(m, _STATS_METRICS, n=1)
                hint = f" -> did you mean [{close[0]}]?" if close else ""
                raise IllegalArgumentError(
                    f"request [/_stats/{m}] contains unrecognized "
                    f"metric: [{m}]{hint}")
        services = self._resolve(name)
        sections = {m: {"memory_size_in_bytes": 0, "hit_count": 0,
                        "miss_count": 0, "evictions": 0}
                    for m in _PORTED_STATS if m in keep}
        node = self.caches.stats()
        agg = {m: node[m] for m in sections} if services else {}
        indices = {}
        total = successful = 0
        for svc in services:
            replicas = int(svc.settings.get("index.number_of_replicas", 1))
            total += svc.num_shards * (1 + replicas)
            successful += svc.num_shards
            indices[svc.name] = {"uuid": svc.uuid,
                                 "primaries": copy.deepcopy(sections),
                                 "total": copy.deepcopy(sections)}
        return {"_shards": {"total": total, "successful": successful,
                            "failed": 0},
                "_all": {"primaries": agg, "total": copy.deepcopy(agg)},
                "indices": indices}
