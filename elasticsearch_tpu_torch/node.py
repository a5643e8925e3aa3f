"""One node holding indices of 1 to 1024 shards on one card (port of the
served slices of `elasticsearch_tpu/node.py`).

Indices: create (with `number_of_shards` and the `index.knn.*` engine
settings, the reference's name rules and defaults), delete (its stores'
device memory and its hybrid executor let go), exists, mapping updates,
and index expressions (`resolve`: none, `_all`, lists, `*` patterns).
Documents, routed to a shard by `routing` or `_id`: index (auto ids, the
conditional `if_seq_no` / `if_primary_term` / `version` writes, `refresh`
with `wait_for`), realtime GET, delete, update (`doc` deep merge,
`detect_noop`, `upsert`, `doc_as_upsert`, `script`), `_mget` and `_bulk` with its
four actions. Search over an expression: each index's query phase
(filters, BM25 text queries, `knn` specs with their filters) through its
own store, the hits merged by score as the reference merges them;
`_count` and `_msearch`; hybrid `rank: {rrf}` searches over one index
(one `HybridExecutor` per index, whose BM25 and late-interaction stores
read the index's combined reader, so BM25 scores with corpus-wide
statistics). Responses take the reference's shapes.

The node's search caches (`search/caches.py::NodeCaches`) sit in front of
the query phase, in the reference's order: the can_match pre-filter when
the request names `pre_filter_shard_size`, then the device rung of the
shard request cache for a kNN-bearing or hybrid body (on unless the node
setting `search.request_cache.device_paths` is false), else its host rung
for a `size: 0` or opted-in body; the node query cache serves every
search context's `bool` filter clauses. `_cache/clear` and the `query_cache` /
`request_cache` index stats read them.

Aggregations: the body's `aggs` are checked before any index runs
(`validate_aggs`), each index computes them in its query phase (final
JSON for one index, partial states over several, merged and finalized
here, where the top-level pipelines then run), and a `global` or
`min_doc_count: 0` aggregation turns the can_match skip off. An
aggregator that fails a one-shard index (`ArrayIndexOutOfBoundsError`:
HDR percentiles over a negative value) fails that shard: it is listed
under `_shards.failures`, or, when every shard failed, the search is a
503 "all shards failed"; on an index of several shards the reference's
retry without the failing shards is not ported, a 400 that names its
ROADMAP.md item. An index's
`AggEngine` (`search/agg_plan.py`) runs the device-eligible nodes on the
card unless the node setting `search.aggs.device_enabled` is false; the
node setting `search.aggs.cost_router` (default on) lets the node's one
`CostRouter` send a node to the host path when its timings say the host
is cheaper. An engine's columns resync lazily: the first aggregation
after a refresh rebuilds them, extracting only new segments. A deleted
index's engine goes with it. `search.max_buckets` (no limit by default,
as in the reference) bounds every bucket list.

Telemetry (`telemetry/`): the node wires `telemetry.*` settings into the
process-wide tracer, keeps the live tasks of its requests
(`node_admin.TaskManager`: `tasks_list_api`, `task_get_api`,
`task_cancel_api`), its completed traces (`traces_api`) and the metrics
registry's section (`telemetry_stats_api`), and records every search's
end-to-end time in the `search.took` histogram. A `profile` body runs each
index's query phase with the thread's launch event trace on and answers
`profile.shards` (`search/profile.py`), or `profile.hybrid` on the fused
hybrid path; it never reads or fills either rung of the request cache (a
profile describes a real execution) and notes the rung it bypassed.

Scripts (`script/`): `update_doc` runs a `script` (inline or a stored
id) through the Painless interpreter on the document's source, whose
`ctx.op` may make the update a noop (`none`) or a delete (`delete`); a
search's `suggest` section runs on each index (`search/extras.py`) and
the indices' options merge by score; `search_template` renders a
template (`script/mustache.py`) and searches with it. The node's
`scripts` is the port's stored-script registry (`script/service.py`),
and `search.allow_expensive_queries` (a node setting, on unless "false")
reaches every search context.

Scroll, slices, boosts and lookups: `search_scroll_start` runs each
index's query phase over every matching row on a reader its context
pins (`node_admin.ScrollService`) and pages the merged order from there;
`indices_boost` multiplies each index's scores before the merge (its
hits' `_score`, the merge key and `max_score`); a `terms` lookup in a
body's `query` or `aggs` is inlined from the stored document before any
index runs (`_rewrite_terms_lookup`: `search`, both hybrid paths,
`count`, `_msearch` and the scroll start); `open_point_in_time` keeps
readers under an id (`node_admin.PointInTimeService`), which no search
reads, as in the reference.

Aliases, closed indices and dynamic settings: every route that takes an
index expression resolves aliases (a pattern matches alias names too) and
skips closed indices under patterns (`resolve`; a concretely named closed
index is the reference's `index_closed_exception` on a data operation;
the index-info routes resolve as the reference's REST layer does,
`resolve_info`); a document operation takes a single-index alias
(`index`). `close_index` refreshes the index and flips the flag,
`open_index` flips it back; the device state stays, so a reopened index
serves the same hits without a rebuild. Dynamic index settings
(`IndexService.settings_update`) are read live by the searches.

Node features (`node_admin.py`): `_analyze` (`analyze`), single-node
`cluster_health` (replicas that can never assign make it yellow),
`termvectors_api`, `nodes_info_api`, async search, the reindex family,
field caps, query validation and explain.

Left out, as ROADMAP.md lists: hidden indices and date math in
expressions (queue 1 item 16), and hybrid bodies over several indices
(each a 400)."""

from __future__ import annotations

import copy
import difflib
import fnmatch
import itertools
import json
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch import telemetry
from elasticsearch_tpu_torch.cluster.routing import shard_ids_for
from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationError, ArrayIndexOutOfBoundsError,
    DocumentMissingError, IllegalArgumentError, IndexNotFoundError,
    ParsingError, ResourceAlreadyExistsError, SearchEngineError,
    SearchPhaseExecutionError, VersionConflictError,
)
from elasticsearch_tpu_torch.indices.service import (  # noqa: F401
    SHARD_ROW_SPACE, IndexService, check_open, flat_settings, get_index,
    index_or_alias_exists, resolve_expression, resolve_info,
    update_aliases, validate_index_name, validate_knn_settings,
)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.node_admin import (
    AsyncSearchService, PointInTimeService, ScrollService, TaskManager,
)
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.search.agg_partials import (
    finalize_aggs, merge_partial_aggs,
)
from elasticsearch_tpu_torch.search.agg_plan import AggEngine, CostRouter
from elasticsearch_tpu_torch.search.extras import (
    execute_suggest, merge_suggest,
)
from elasticsearch_tpu_torch.search.aggregations import (
    has_global_agg, hdr_multi_shard_error, validate_aggs,
)
from elasticsearch_tpu_torch.script.service import GLOBAL_SCRIPTS
from elasticsearch_tpu_torch.search.caches import (
    NodeCaches, can_match, has_range_clauses, reader_fingerprint,
)
from elasticsearch_tpu_torch.search.hybrid_plan import (
    HybridExecutor, sub_queries_of,
)
from elasticsearch_tpu_torch.search.profile import shard_profile
from elasticsearch_tpu_torch.search.queries import SearchContext
from elasticsearch_tpu_torch.search.service import (
    MAX_RESULT_WINDOW, check_track_total_hits, count_body,
    execute_query_phase, fetch_hits, filter_source, get_path, group_value,
    inner_hits_body, inner_hits_specs, source_patterns, tracks_total, window,
)
from elasticsearch_tpu_torch.serving.batcher import CombiningBatcher
from elasticsearch_tpu_torch.telemetry import metrics as _telemetrics
from elasticsearch_tpu_torch.telemetry import trace as _teletrace

VERSION = "8.0.0-torch"
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
_BULK_ACTIONS = ("index", "create", "update", "delete")
# a bulk item's conditional parameters (the engine's conflict checks)
_CONDITIONAL = ("if_seq_no", "if_primary_term", "version")
# `refresh` values that refresh after a write, and those of them that mark
# the response `forced_refresh`
_REFRESHING = ("true", "", "wait_for", True)
_FORCED = ("true", "", True)
_UPDATE_FIELDS = ["doc", "script", "upsert", "doc_as_upsert",
                  "scripted_upsert", "detect_noop", "_source", "if_seq_no",
                  "if_primary_term", "lang"]


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
               precision: str = "bf16", num_candidates=None, reader=None,
               deadline_at: Optional[float] = None):
        """Top-k over every shard: (rows, raw scores) in the combined
        space. `deadline_at` (time.monotonic seconds) sheds the request in
        the batcher's queue when no runner claims it in time."""
        result, self._tls.phases = self._batcher.submit((
            (field, k, precision, num_candidates),
            np.asarray(query_vector, dtype=np.float32), filter_rows, reader),
            deadline_at=deadline_at)
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
        """Land a `search_many_async` handle; its phases become the calling
        thread's `last_knn_phases`."""
        results, self._tls.phases = self._land(handle)
        return results

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

    @property
    def columnar_refresh(self) -> dict:
        """Each field's last refresh composition, from the first shard
        that synced it (`profile.knn.columnar`)."""
        out: dict = {}
        for shard in self.svc.shards:
            for f, info in shard.vector_store.columnar_refresh.items():
                out.setdefault(f, info)
        return out


class Node:
    def __init__(self, device="cuda", node_name: str = "node-0",
                 settings: Optional[dict] = None,
                 cluster_name: str = "tpu-search"):
        self.device = resolve_device(device)
        self.node_name = node_name
        self.cluster_name = cluster_name
        self.node_id = uuid.uuid4().hex[:22]
        # node settings (flat keys); read at each use, as the reference
        # reads its node settings
        self.settings: Dict[str, object] = dict(settings or {})
        # the live tasks of this node's instrumented requests
        self.tasks = TaskManager(self.node_id)
        # tracer sampling and ring size are process-wide: only an explicit
        # setting reconfigures them
        telemetry.configure_from_settings(self.settings)
        self.caches = NodeCaches()
        # the port's stored scripts (`_scripts/{id}`), shared by its nodes
        self.scripts = GLOBAL_SCRIPTS
        self.indices: Dict[str, IndexService] = {}
        # index name -> its hybrid executor (plan cache + late-interaction
        # store), made at the index's first hybrid search
        self._hybrid: Dict[str, HybridExecutor] = {}
        # index name -> (its service, its aggregation engine)
        self._aggs: Dict[str, tuple] = {}
        self._agg_router = CostRouter()
        self.scrolls = ScrollService()
        self.pits = PointInTimeService()
        self.async_search = AsyncSearchService()
        self._lock = threading.Lock()

    # -------------------------------------------------------------- indices
    def create_index(self, name: str, body: Optional[dict]) -> dict:
        body = body or {}
        validate_index_name(name)
        # the reference's defaults, under the body's own settings
        settings = {"index.number_of_shards": 1,
                    "index.number_of_replicas": 1,
                    **flat_settings(body.get("settings"))}
        with self._lock:
            if name in self.indices:
                raise ResourceAlreadyExistsError(
                    f"index [{name}] already exists", index=name)
            svc = IndexService(name, body.get("mappings"), self.device,
                               settings=settings)
            svc.vector_store = _MultiShardVectorStore(svc)
            svc.aliases = {a: dict(spec or {})
                           for a, spec in (body.get("aliases") or {}).items()}
            self.indices[name] = svc
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def index(self, name: str) -> IndexService:
        """The index a document operation addresses: a name or a
        single-index alias (`get_index`)."""
        with self._lock:
            indices = dict(self.indices)
        return get_index(indices, name)

    def resolve(self, expression: Optional[str],
                ignore_unavailable: bool = False,
                allow_no_indices: bool = True, expand_open: bool = True,
                expand_closed: bool = False,
                forbid_closed: bool = True) -> List[IndexService]:
        """The indices an expression names (`resolve_expression`): by
        default for a data operation, which refuses a closed index it
        names (`forbid_closed`)."""
        with self._lock:
            indices = dict(self.indices)
        return resolve_expression(indices, expression,
                                  ignore_unavailable=ignore_unavailable,
                                  allow_no_indices=allow_no_indices,
                                  expand_open=expand_open,
                                  expand_closed=expand_closed,
                                  forbid_closed=forbid_closed)

    def resolve_info(self, expression: Optional[str],
                     ignore_unavailable: bool = False,
                     allow_no_indices: bool = True,
                     expand_open: bool = True,
                     expand_closed: bool = False) -> List[IndexService]:
        """The indices an index-info API names (`resolve_info`)."""
        with self._lock:
            indices = dict(self.indices)
        return resolve_info(indices, expression, ignore_unavailable,
                            allow_no_indices, expand_open, expand_closed)

    # ------------------------------------------ aliases, open / close state
    def update_aliases(self, actions: List[dict]) -> dict:
        """`POST /_aliases`: the actions in order (`update_aliases`); a
        `remove_index` deletes its index as `DELETE /{index}` does."""
        with self._lock:
            indices = dict(self.indices)
        update_aliases(indices, actions, self.delete_index)
        return {"acknowledged": True}

    def close_index(self, name: str) -> None:
        """`POST /{index}/_close`: the index refreshed (the reference's
        close flushes, which refreshes; the port has no translog to
        commit), then data operations on it are refused until it is
        opened; its shards, stores and device corpora stay as they
        are."""
        svc = self.index(name)
        svc.refresh()
        svc.closed = True

    def open_index(self, name: str) -> None:
        self.index(name).closed = False

    # --------------------------------------------------------- node features
    def analyze(self, body: dict, index: Optional[str] = None) -> dict:
        """`_analyze`: the tokens of `text` (a string or a list, a position
        gap of one between texts) under a named analyzer (the builtins,
        or the index's own with an index in the path), or a custom chain
        of `tokenizer`, `filter` and `char_filter`; `explain` answers the
        detail form. More tokens than `index.analyze.max_token_count`
        (10,000 by default) is the reference's 400."""
        from elasticsearch_tpu_torch.index import analysis
        text = body.get("text", "")
        texts = text if isinstance(text, list) else [text]
        registry = analysis.DEFAULT_REGISTRY
        max_tokens = 10_000
        if index and self.index_exists(index):
            svc = self.index(index)
            registry = svc.mapper_service.registry
            max_tokens = int(svc.settings.get(
                "index.analyze.max_token_count", 10_000))
        custom = "tokenizer" in body or "filter" in body \
            or "char_filter" in body
        filters, filter_names = [], []
        if custom:
            tok_spec = body.get("tokenizer", "keyword")
            if isinstance(tok_spec, dict):
                tokenizer = analysis._build_tokenizer(tok_spec)
                tok_name = tok_spec.get("type", "custom")
            else:
                tokenizer = analysis._builtin_tokenizer(str(tok_spec))
                tok_name = str(tok_spec)
            specs = [body["filter"]] if isinstance(body.get("filter"), dict) \
                else analysis._as_list(body.get("filter", []))
            for f in specs:
                if isinstance(f, dict):
                    filters.append(analysis._build_filter(f))
                    filter_names.append(f.get("type", "custom"))
                else:
                    filters.append(analysis._builtin_filter(str(f)))
                    filter_names.append(str(f))
            analyzer = analysis.Analyzer("__custom__", tokenizer, filters)
            analyzer_name = None
        else:
            analyzer_name = body.get("analyzer", "standard")
            analyzer = registry.get(analyzer_name)

        def render(toks, base):
            return [{"token": t.term, "start_offset": t.start_offset,
                     "end_offset": t.end_offset, "type": "<ALPHANUM>",
                     "position": base + t.position} for t in toks]

        tokens, tokenizer_tokens, pos = [], [], 0
        for t in texts:
            text_tokens = analyzer.analyze(str(t))
            if len(tokens) + len(text_tokens) > max_tokens:
                raise IllegalArgumentError(
                    f"The number of tokens produced by calling _analyze "
                    f"has exceeded the allowed maximum of [{max_tokens}]. "
                    f"This limit can be set by changing the "
                    f"[index.analyze.max_token_count] index level setting.")
            tokens.extend(render(text_tokens, pos))
            if custom:
                tokenizer_tokens.extend(render(analyzer.tokenizer(str(t)),
                                               pos))
            pos += len(text_tokens) + 1
        if body.get("explain"):
            if custom:
                detail = {"custom_analyzer": True,
                          "tokenizer": {"name": tok_name,
                                        "tokens": tokenizer_tokens}}
                if filter_names:
                    detail["tokenfilters"] = [{"name": n, "tokens": tokens}
                                              for n in filter_names]
                return {"detail": detail}
            return {"detail": {"custom_analyzer": False,
                               "analyzer": {"name": analyzer_name,
                                            "tokens": tokens}}}
        return {"tokens": tokens}

    def cluster_health(self, index: Optional[str] = None,
                       level: str = "cluster",
                       expand_wildcards: str = "all") -> dict:
        """Single-node health: replicas can never assign, so an index with
        replicas makes the cluster yellow; closed indices count too, and
        patterns take both open and closed ones unless
        `expand_wildcards` says otherwise. Parts match index names only,
        as the reference's do: a concrete index that does not exist (an
        alias too) makes it red and timed out (the REST layer's 408)."""
        tokens = {t for t in str(expand_wildcards).split(",") if t}
        want_open = bool(tokens & {"open", "all"})
        want_closed = bool(tokens & {"closed", "all"})
        with self._lock:
            indices = dict(self.indices)
        missing_concrete = False
        if index:
            services = []
            for part in index.split(","):
                part = part.strip()
                matched = False
                for name, svc in indices.items():
                    if not (fnmatch.fnmatch(name, part) if "*" in part
                            else name == part):
                        continue
                    if "*" in part and not (want_closed if svc.closed
                                            else want_open):
                        continue
                    services.append(svc)
                    matched = True
                if not matched and "*" not in part:
                    missing_concrete = True
        else:
            services = [s for s in indices.values()
                        if (want_closed if s.closed else want_open)]
        services = list({s.name: s for s in services}.values())
        shards = sum(s.num_shards for s in services)
        unassigned = sum(s.num_shards * s.num_replicas for s in services)
        total = shards + unassigned
        out = {
            "cluster_name": self.cluster_name,
            "status": "yellow" if unassigned else "green",
            "timed_out": False, "number_of_nodes": 1,
            "number_of_data_nodes": 1, "active_primary_shards": shards,
            "active_shards": shards, "relocating_shards": 0,
            "initializing_shards": 0, "unassigned_shards": unassigned,
            "delayed_unassigned_shards": 0, "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number":
                (shards / total * 100.0) if total else 100.0,
        }
        if missing_concrete:
            out["status"] = "red"
            out["timed_out"] = True
        if level in ("indices", "shards"):
            indices_out = {}
            for svc in services:
                un = svc.num_shards * svc.num_replicas
                entry = {"status": "yellow" if un else "green",
                         "number_of_shards": svc.num_shards,
                         "number_of_replicas": svc.num_replicas,
                         "active_primary_shards": svc.num_shards,
                         "active_shards": svc.num_shards,
                         "relocating_shards": 0, "initializing_shards": 0,
                         "unassigned_shards": un}
                if level == "shards":
                    entry["shards"] = {
                        str(s.shard_id): {
                            "status": "yellow" if svc.num_replicas
                            else "green",
                            "primary_active": True, "active_shards": 1,
                            "relocating_shards": 0,
                            "initializing_shards": 0,
                            "unassigned_shards": svc.num_replicas}
                        for s in svc.shards}
                indices_out[svc.name] = entry
            out["indices"] = indices_out
        return out

    def termvectors_api(self, index: str, doc_id, spec: dict) -> dict:
        """`_termvectors`: each text field's terms of a stored document (or
        of an artificial `doc`) with their frequencies, positions and
        offsets, `term_statistics` adding each term's doc_freq and ttf;
        the field statistics describe the index's reader.
        `realtime=false` reads only refreshed documents."""
        spec = spec or {}
        svc = self.index(index)
        reader = svc.combined_reader()
        realtime = spec.get("realtime", True)
        if isinstance(realtime, str):
            realtime = realtime not in ("false", "0")
        if doc_id is not None:
            if not realtime and not any(
                    reader.get_id(int(r)) == str(doc_id)
                    for r in reader.live_global_rows()):
                return {"_index": index, "_id": doc_id, "_version": 1,
                        "found": False, "took": 0}
            got = self.get_doc(index, str(doc_id))
            if not got.get("found"):
                return {"_index": index, "_id": doc_id, "found": False,
                        "took": 0}
            source = got["_source"]
        else:
            source = spec.get("doc") or {}
        fields = spec.get("fields")
        want_stats = spec.get("term_statistics") in (True, "true", "")
        out_fields = {}
        for fname, value in (source or {}).items():
            if fields and fname not in fields:
                continue
            mapper = svc.mapper_service.get(fname)
            if mapper is None or getattr(mapper, "type_name", "") != "text" \
                    or not hasattr(mapper, "analyze"):
                continue
            text_lower = str(value).lower()
            terms: Dict[str, dict] = {}
            cursor = 0
            for pos, t in enumerate(mapper.analyze(str(value))):
                start = text_lower.find(str(t).lower(), cursor)
                entry = terms.setdefault(t, {"term_freq": 0, "tokens": []})
                entry["term_freq"] += 1
                tok = {"position": pos}
                if start >= 0:
                    cursor = start + len(str(t))
                    tok["start_offset"] = start
                    tok["end_offset"] = cursor
                entry["tokens"].append(tok)
            if want_stats:
                for t, entry in terms.items():
                    entry["doc_freq"] = reader.doc_freq(fname, t)
                    entry["ttf"] = sum(
                        int(p.freqs.sum()) for p in (
                            v.segment.get_postings(fname, t)
                            for v in reader.views) if p is not None)
            # the live postings of every term: Σ doc_freq over the terms
            sum_doc_freq = 0
            for view in reader.views:
                fp = view.segment.postings.get(fname)
                if fp is not None:
                    sum_doc_freq += int(view.live[fp.doc_ids].sum())
            out_fields[fname] = {
                "field_statistics": {
                    "sum_doc_freq": sum_doc_freq,
                    "doc_count": reader.docs_with_field_count(fname),
                    "sum_ttf": reader.total_term_count(fname)},
                "terms": terms}
        return {"_index": index, "_id": doc_id, "_version": 1, "found": True,
                "took": 0, "term_vectors": out_fields}

    def local_node_info(self) -> dict:
        """This node's `GET /_nodes` section: name, version, roles, its
        settings nested, the process flags and its plugins (none)."""
        nested: dict = {"client": {"type": "node"},
                        "node": {"name": self.node_name},
                        "cluster": {"name": self.cluster_name}}
        for key, value in self.settings.items():
            cur = nested
            parts = str(key).split(".")
            for part in parts[:-1]:
                nxt = cur.setdefault(part, {})
                if not isinstance(nxt, dict):
                    break
                cur = nxt
            else:
                cur[parts[-1]] = value
        return {"name": self.node_name, "version": VERSION,
                "roles": ["master", "data", "ingest"], "settings": nested,
                "process": {"mlockall": False, "seccomp": False},
                "plugins": []}

    def nodes_info_api(self) -> dict:
        return self._nodes_envelope({self.node_id: self.local_node_info()})

    def delete_index(self, expression: str, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True) -> dict:
        """`DELETE /{index}` of every index the expression names: patterns
        match index names, closed indices too; a concrete name must be an
        index (an alias is the reference's 400, a missing name a 404,
        both skipped under `ignore_unavailable`). A deleted index lets go
        of its device memory: its shard stores' corpora, snapshots and
        batchers and its hybrid executor (token tiles, lexical and sparse
        boards)."""
        with self._lock:
            indices = dict(self.indices)
        names: List[str] = []
        for part in expression.split(","):
            part = part.strip()
            if not part:
                continue
            if part.startswith("<") and part.endswith(">"):
                resolve_expression(indices, part)   # date math: the 400
            if "*" in part or part == "_all":
                pat = "*" if part == "_all" else part
                matched = [n for n in indices if fnmatch.fnmatchcase(n, pat)]
                if not matched and not allow_no_indices:
                    raise IndexNotFoundError(part)
                names.extend(matched)
                continue
            if part not in indices:
                if ignore_unavailable:
                    continue
                if any(part in s.aliases for s in indices.values()):
                    raise IllegalArgumentError(
                        f"The provided expression [{part}] matches an "
                        f"alias, specify the corresponding concrete "
                        f"indices instead.")
                raise IndexNotFoundError(part)
            names.append(part)
        for name in dict.fromkeys(names):
            with self._lock:
                gone = self.indices.pop(name, None)
                self._hybrid.pop(name, None)
                self._aggs.pop(name, None)
            if gone is None:
                raise IndexNotFoundError(name)
            gone.close()
        return {"acknowledged": True}

    def index_exists(self, expression: str) -> bool:
        """`HEAD /{index}`: every part names an index or is a `*` pattern.
        `_all` is taken as a name here, as the reference takes it, so it
        is a 404."""
        with self._lock:
            indices = dict(self.indices)
        return all(index_or_alias_exists(indices, p) or "*" in p
                   for p in expression.split(","))

    def put_mapping(self, expression: str, body: dict) -> dict:
        """`PUT /{index}/_mapping`: merge the body into every index the
        expression names; matching none is a 404."""
        if "_doc" in body and isinstance(body["_doc"], dict) \
                and "properties" in body["_doc"]:
            raise IllegalArgumentError(
                "Types cannot be provided in put mapping requests")
        services = self.resolve(expression, forbid_closed=False)
        if not services:
            raise IndexNotFoundError(expression)
        for svc in services:
            svc.mapper_service.merge(body)
        return {"acknowledged": True}

    def _index_or_autocreate(self, name: str) -> IndexService:
        """The open index a write addresses (a name or a single-index
        alias), created when neither exists."""
        with self._lock:
            exists = index_or_alias_exists(self.indices, name)
        if not exists:
            try:
                self.create_index(name, None)
            except ResourceAlreadyExistsError:
                pass  # raced: another writer created it
        return check_open(self.index(name))

    # ------------------------------------------------------------ documents
    @staticmethod
    def _write_response(svc, res) -> dict:
        return {"_index": svc.name, "_id": res.doc_id,
                "_version": res.version, "result": res.result,
                "_shards": dict(_SHARDS_OK), "_seq_no": res.seq_no,
                "_primary_term": res.primary_term}

    @staticmethod
    def _check_id(doc_id: str) -> None:
        size = len(doc_id.encode("utf-8"))
        if size > 512:
            raise IllegalArgumentError(
                f"id [{doc_id}] is too long, must be no longer than 512 "
                f"bytes but was: {size}")

    @staticmethod
    def _maybe_refresh(svc: IndexService, refresh, shard=None) -> None:
        """`refresh=true` (or empty) and `wait_for` on a write: refresh its
        shard only, so the other shards' unrefreshed writes stay
        invisible, or every shard without one."""
        if refresh in _REFRESHING:
            if shard is not None:
                shard.engine.refresh()
            else:
                svc.refresh()

    def _refresh_indices(self, names) -> None:
        for name in names:
            self.index(name).refresh()

    def index_doc(self, index: str, doc_id: Optional[str], body: dict,
                  op_type: str = "index", refresh: Optional[str] = None,
                  routing: Optional[str] = None,
                  if_seq_no: Optional[int] = None,
                  if_primary_term: Optional[int] = None,
                  version: Optional[int] = None,
                  version_type: str = "internal") -> dict:
        """Index one document: an auto id (no `doc_id`) writes with create
        semantics; the conditional parameters are the engine's
        (`Engine._check_conflicts`)."""
        svc = self._index_or_autocreate(index)
        if doc_id is None:
            doc_id, op_type = uuid.uuid4().hex[:20], "create"
        doc_id = str(doc_id)
        self._check_id(doc_id)
        shard = svc.route(doc_id, routing)
        res = shard.engine.index(
            doc_id, body, op_type=op_type, routing=routing,
            if_seq_no=if_seq_no, if_primary_term=if_primary_term,
            version=version, version_type=version_type)
        self._maybe_refresh(svc, refresh, shard=shard)
        out = self._write_response(svc, res)
        if refresh in _FORCED:
            # the write itself made its change visible (`wait_for` is not
            # "forced")
            out["forced_refresh"] = True
        return out

    def get_doc(self, index: str, doc_id: str,
                routing: Optional[str] = None, realtime: bool = True) -> dict:
        svc = check_open(self.index(index))
        doc = svc.route(doc_id, routing).engine.get(doc_id, realtime=realtime)
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

    def delete_doc(self, index: str, doc_id: str,
                   refresh: Optional[str] = None,
                   routing: Optional[str] = None,
                   if_seq_no: Optional[int] = None,
                   if_primary_term: Optional[int] = None,
                   version: Optional[int] = None,
                   version_type: str = "internal") -> dict:
        """Delete one document; a missing one raises
        `DocumentMissingError` (the REST layer's 404 `not_found`)."""
        svc = check_open(self.index(index))
        shard = svc.route(doc_id, routing)
        res = shard.engine.delete(doc_id, if_seq_no=if_seq_no,
                                  if_primary_term=if_primary_term,
                                  version=version, version_type=version_type)
        self._maybe_refresh(svc, refresh, shard=shard)
        out = self._write_response(svc, res)
        if refresh in _FORCED:
            out["forced_refresh"] = True
        return out

    @staticmethod
    def _validate_update_body(body: Optional[dict]) -> None:
        for k in body or {}:
            if k not in _UPDATE_FIELDS:
                close = difflib.get_close_matches(k, _UPDATE_FIELDS, n=1)
                hint = f" did you mean [{close[0]}]?" if close else ""
                raise ParsingError(
                    f"[UpdateRequest] unknown field [{k}]{hint}")

    def update_doc(self, index: str, doc_id: str, body: dict,
                   refresh: Optional[str] = None,
                   routing: Optional[str] = None,
                   if_seq_no: Optional[int] = None,
                   if_primary_term: Optional[int] = None,
                   source_filter=None) -> dict:
        """`_update`: a partial `doc` deep-merged into the live source
        (`detect_noop` on by default), or a `script` run on it
        (`_apply_update_script`: `ctx.op = 'none'` answers a noop,
        `'delete'` deletes the document), or `upsert` / `doc_as_upsert`
        for a missing document (the `upsert` indexed as given, also with
        `scripted_upsert`, as in the reference), re-indexed under the
        document's seq_no and primary term; `_source` (the body's or the
        URL's) adds the new source as `get`."""
        self._validate_update_body(body)
        if source_filter is None and "_source" in body:
            source_filter = body["_source"]
        svc = self._index_or_autocreate(index)
        shard = svc.route(doc_id, routing)
        existing = shard.engine.get(doc_id)

        def with_get(out, src):
            if source_filter is not None and source_filter is not False:
                doc = {"_source": copy.deepcopy(src)}
                _apply_mget_projection(svc, doc, {}, None, source_filter)
                out["get"] = {"_source": doc.get("_source", {}),
                              "found": True}
            return out

        if existing is None:
            if "upsert" in body:
                out = self.index_doc(svc.name, doc_id, body["upsert"],
                                     refresh=refresh, routing=routing)
                return with_get(out, body["upsert"])
            if body.get("doc_as_upsert") and "doc" in body:
                out = self.index_doc(svc.name, doc_id, body["doc"],
                                     refresh=refresh, routing=routing)
                return with_get(out, body["doc"])
            raise DocumentMissingError(f"[{doc_id}]: document missing")
        if if_seq_no is not None and existing["_seq_no"] != if_seq_no or \
                if_primary_term is not None \
                and existing["_primary_term"] != if_primary_term:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, required seqNo "
                f"[{if_seq_no}], primary term [{if_primary_term}], "
                f"current document has seqNo [{existing['_seq_no']}] and "
                f"primary term [{existing['_primary_term']}]")
        source = copy.deepcopy(existing["_source"])
        if "doc" in body:
            _deep_merge(source, body["doc"])
            if body.get("detect_noop", True) \
                    and source == existing["_source"]:
                return with_get({
                    "_index": svc.name, "_id": doc_id,
                    "_version": existing["_version"], "result": "noop",
                    "_seq_no": existing["_seq_no"],
                    "_primary_term": existing["_primary_term"],
                    "_shards": {"total": 0, "successful": 0, "failed": 0}},
                    source)
        elif "script" in body:
            verdict: dict = {}
            source = _apply_update_script(source, body["script"],
                                          ctx_extra=verdict)
            op = verdict.get("op", "index")
            if op == "none":
                # the script vetoed the update; the reference answers
                # with the index as addressed
                return {"_index": index, "_id": doc_id,
                        "_version": existing["_version"],
                        "result": "noop",
                        "_seq_no": existing["_seq_no"],
                        "_primary_term": existing["_primary_term"],
                        "_shards": {"total": 0, "successful": 0,
                                    "failed": 0}}
            if op == "delete":
                out = self.delete_doc(index, doc_id, refresh=refresh,
                                      routing=routing)
                out["result"] = "deleted"
                return out
        else:
            raise IllegalArgumentError("update requires [doc] or [script]")
        out = self.index_doc(svc.name, doc_id, source, refresh=refresh,
                             routing=routing,
                             if_seq_no=existing["_seq_no"],
                             if_primary_term=existing["_primary_term"])
        out["result"] = "updated"
        return with_get(out, source)

    def mget(self, body: Optional[dict], default_index: Optional[str] = None,
             stored_fields=None, realtime: bool = True,
             refresh: bool = False, source_filter=None) -> dict:
        """`_mget`: `docs` (each with its `_index`, `_id`, `routing`,
        `_source`, `stored_fields`) and / or `ids` of the URL's index.
        Missing `_index` or `_id` fail the request as one validation error;
        a missing index or document is `found: false`."""
        body = body or {}
        items: List[dict] = []
        failures: List[str] = []
        for spec in body.get("docs") or []:
            index = spec.get("_index", default_index)
            if not index:
                failures.append("index is missing")
            if "_id" not in spec:
                failures.append("id is missing")
            if index and "_id" in spec:
                items.append({**spec, "_index": index})
        for doc_id in body.get("ids") or []:
            if not default_index:
                failures.append("index is missing")
            else:
                items.append({"_index": default_index, "_id": doc_id})
        if not items and not failures:
            failures.append("no documents to get")
        if failures:
            raise ActionRequestValidationError.of(failures)
        docs = []
        refreshed = set()
        for spec in items:
            index, doc_id = spec["_index"], str(spec["_id"])
            routing = spec.get("routing")
            routing = None if routing is None else str(routing)
            try:
                if refresh and index not in refreshed:
                    check_open(self.index(index)).refresh()
                    refreshed.add(index)
                doc = self.get_doc(index, doc_id, routing=routing,
                                   realtime=realtime)
            except IndexNotFoundError:
                docs.append({"_index": index, "_id": doc_id, "found": False})
                continue
            except IllegalArgumentError as e:
                docs.append({"_index": index, "_id": doc_id,
                             "error": e.to_wrapped_dict()})
                continue
            except SearchEngineError as e:
                docs.append({"_index": index, "_id": doc_id,
                             "error": e.to_dict()})
                continue
            _apply_mget_projection(self.indices.get(doc["_index"]), doc,
                                   spec, stored_fields, source_filter)
            docs.append(doc)
        return {"docs": docs}

    @staticmethod
    def _validate_bulk(ops: List[dict]) -> None:
        """Every action line of a `_bulk`, before any item runs: a
        malformed one fails the whole request."""
        line = 0
        for j, action in enumerate(ops):
            if j != line:
                continue
            if not isinstance(action, dict) or len(action) != 1:
                # the reference names the parser state it hit
                if isinstance(action, dict) and len(action) > 1:
                    expected, found = "END_OBJECT", "FIELD_NAME"
                elif isinstance(action, dict):
                    expected, found = "FIELD_NAME", "END_OBJECT"
                else:
                    expected, found = "START_OBJECT", "VALUE_STRING"
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{j + 1}], expected "
                    f"{expected} but found [{found}]")
            (op, meta), = action.items()
            if op not in _BULK_ACTIONS or not isinstance(meta, dict):
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{j + 1}], found "
                    f"[{op}]")
            for dep in ("_version", "_routing", "_parent", "fields",
                        "_version_type", "_retry_on_conflict"):
                if dep in meta:
                    raise IllegalArgumentError(
                        f"Action/metadata line [{j + 1}] contains an "
                        f"unknown parameter [{dep}]")
            line += 1 if op == "delete" else 2

    def bulk(self, ops: List[dict], default_index: Optional[str] = None,
             refresh: Optional[str] = None, source_filter=None) -> dict:
        """`_bulk` with the four actions. Every action line is validated
        first. Items run in the request's order; each run of consecutive
        unconditional `index` / `create` items goes in one batch, whose
        valid documents of one index are routed in one `shard_ids_for`
        call, and each run of one action among a shard's documents goes
        to that shard's engine in one `index_many` (a document that fails
        to parse fails its item only, and takes a seq_no on its shard in
        the request's order, as in the reference). An `update`, a
        `delete` and a conditional write (`if_seq_no`, `if_primary_term`,
        `version`) run one at a time through the single-document paths.
        An `index` item with no `_id` writes with create semantics and
        keeps `index` as its key."""
        start = time.perf_counter()
        self._validate_bulk(ops)
        items: List[Optional[dict]] = []
        touched: set = set()
        group: List[tuple] = []
        i = 0
        while i < len(ops):
            (action, meta), = ops[i].items()
            i += 1
            name = meta.get("_index", default_index)
            doc_id = meta.get("_id")
            doc_id = None if doc_id is None else str(doc_id)
            routing = meta.get("routing")
            routing = None if routing is None else str(routing)
            slot = len(items)
            items.append(None)
            body = None
            if action != "delete":
                body = ops[i] if i < len(ops) else None
                i += 1
            key = action
            if action in ("index", "create"):
                op_type = ("create" if action == "create"
                           else meta.get("op_type", "index"))
                key = "create" if op_type == "create" else action
                if not any(meta.get(k) is not None for k in _CONDITIONAL) \
                        and meta.get("version_type", "internal") \
                        == "internal":
                    group.append((slot, key, op_type, name, doc_id, body,
                                  routing))
                    continue
            self._bulk_group(group, items, touched)
            group = []
            try:
                if doc_id == "" and action != "delete":
                    raise IllegalArgumentError(
                        "if _id is specified it must not be empty")
                if name is None:
                    raise IllegalArgumentError("index is missing")
                if doc_id is None and action != "index":
                    raise ActionRequestValidationError.of(["id is missing"])
                conditional = {k: meta.get(k) for k in _CONDITIONAL}
                if action == "delete":
                    resp = self.delete_doc(
                        name, doc_id, routing=routing,
                        version_type=meta.get("version_type", "internal"),
                        **conditional)
                    status = 200
                elif action == "update":
                    spec = (body.pop("_source", None)
                            if isinstance(body, dict) else None)
                    if spec is None:
                        spec = meta.get("_source", source_filter)
                    resp = self.update_doc(
                        name, doc_id, body, routing=routing,
                        if_seq_no=conditional["if_seq_no"],
                        if_primary_term=conditional["if_primary_term"],
                        source_filter=spec)
                    status = 200
                else:
                    self._check_bulk_source(body)
                    resp = self.index_doc(
                        name, doc_id, body, op_type=op_type,
                        routing=routing,
                        version_type=meta.get("version_type", "internal"),
                        **conditional)
                    status = 201 if resp["result"] == "created" else 200
                touched.add(resp["_index"])
                items[slot] = {key: {**resp, "status": status}}
            except SearchEngineError as e:
                items[slot] = {key: {"_index": name, "_id": doc_id,
                                     "status": e.status,
                                     "error": e.to_dict()}}
        self._bulk_group(group, items, touched)
        if refresh in _REFRESHING:
            self._refresh_indices(touched)
        if refresh in _FORCED:
            for item in items:
                for inner in item.values():
                    if "error" not in inner:
                        inner["forced_refresh"] = True
        return {"took": int((time.perf_counter() - start) * 1000),
                "errors": any("error" in next(iter(it.values()))
                              for it in items),
                "items": items}

    @staticmethod
    def _check_bulk_source(source) -> None:
        if not isinstance(source, dict):
            raise IllegalArgumentError(
                "the bulk request must be terminated by a newline")

    def _bulk_group(self, group: List[tuple], items: list,
                    touched: set) -> None:
        """One run of consecutive unconditional `index` / `create` items
        (slot, item key, op type, index, _id, source, routing): each
        document is validated on its own, then each shard applies its
        documents in the request's order, one `index_many` a run of one
        op type."""
        valid: Dict[str, list] = {}
        for slot, key, op, name, doc_id, source, routing in group:
            try:
                if doc_id == "":
                    raise IllegalArgumentError(
                        "if _id is specified it must not be empty")
                if name is None:
                    raise IllegalArgumentError("index is missing")
                self._check_bulk_source(source)
                svc = self._index_or_autocreate(name)
                name = svc.name
                row_id, row_op = doc_id, op
                if doc_id is None:
                    row_id, row_op = uuid.uuid4().hex[:20], "create"
                self._check_id(row_id)
                try:
                    svc.mapper_service.parse_document(source)
                except SearchEngineError:
                    # the primary gives a document its seq_no before it
                    # parses it: a failed parse still takes one
                    valid.setdefault(name, []).append(
                        (_PARSE_FAILED, slot, key, row_id, None, routing))
                    raise
                valid.setdefault(name, []).append(
                    (row_op, slot, key, row_id, source, routing))
            except SearchEngineError as e:
                items[slot] = {key: {"_index": name, "_id": doc_id,
                                     "status": e.status,
                                     "error": e.to_dict()}}
        runs: List[tuple] = []
        for name, docs in valid.items():
            shards = shard_ids_for(
                [d[3] if d[5] is None else d[5] for d in docs],
                self.indices[name].num_shards)
            by_shard: Dict[int, list] = {}
            for doc, shard in zip(docs, shards.tolist()):
                by_shard.setdefault(shard, []).append(doc)
            # a shard applies its documents in the request's order (its
            # seq_nos follow it), one `index_many` a run of one op type
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
            try:
                results = svc.shards[shard].engine.index_many(
                    [d[2] for d in docs], [d[3] for d in docs],
                    op_type=op, routings=[d[4] for d in docs])
            except SearchEngineError as e:
                results = [e] * len(docs)
            for (slot, key, doc_id, _, _), res in zip(docs, results):
                if isinstance(res, SearchEngineError):
                    items[slot] = {key: {"_index": name, "_id": doc_id,
                                         "status": res.status,
                                         "error": res.to_dict()}}
                    continue
                resp = self._write_response(svc, res)
                resp["status"] = 201 if res.result == "created" else 200
                items[slot] = {key: resp}
                touched.add(name)

    def refresh(self, expression: Optional[str] = None) -> dict:
        """`POST [/{index}]/_refresh`: every index the expression names."""
        services = self.resolve(expression)
        for svc in services:
            svc.refresh()
        n = sum(svc.num_shards for svc in services)
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    def force_merge(self, expression: Optional[str] = None) -> dict:
        """`POST [/{index}]/_forcemerge`: every shard of every index the
        expression names compacts its segments into one."""
        services = self.resolve(expression)
        for svc in services:
            svc.force_merge()
        n = sum(svc.num_shards for svc in services)
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    # --------------------------------------------------------------- search
    def _hybrid_executor(self, svc: IndexService) -> HybridExecutor:
        with self._lock:
            ex = self._hybrid.get(svc.name)
            # a deleted and recreated index of the same name gets its own
            if ex is None or ex.svc is not svc:
                ex = self._hybrid[svc.name] = HybridExecutor(
                    svc, self.device, query_cache=self.caches.query)
                ex.allow_expensive = self._allow_expensive
            return ex

    def _setting_on(self, key: str) -> bool:
        """A boolean node setting, on unless it reads "false"."""
        v = self.settings.get(key)
        return v is None or str(v).lower() != "false"

    def _agg_engine(self, svc: IndexService) -> Optional[AggEngine]:
        """The index's aggregation engine, made at its first aggregation;
        None when `search.aggs.device_enabled` is false. Both settings are
        read at each search."""
        if not self._setting_on("search.aggs.device_enabled"):
            return None
        with self._lock:
            ent = self._aggs.get(svc.name)
            if ent is None or ent[0] is not svc:
                ent = self._aggs[svc.name] = (
                    svc, AggEngine(svc.mapper_service, self.device))
        engine = ent[1]
        engine.cost_router = (self._agg_router
                              if self._setting_on("search.aggs.cost_router")
                              else None)
        return engine

    def aggs_stats(self) -> dict:
        """The aggregation engines' counters summed over the indices:
        searches, device and host nodes (with each host node's reason),
        the device, assembly and host nanos, and the router's decisions."""
        out = {"searches": 0, "device_nodes": 0, "host_nodes": 0,
               "device_nanos": 0, "assemble_nanos": 0, "host_nanos": 0,
               "router_host_routed": 0, "router_probes": 0,
               "fallback_reasons": {}}
        with self._lock:
            engines = [eng for _svc, eng in self._aggs.values()]
        for eng in engines:
            for key, val in eng.stats.items():
                if key != "fallback_reasons":
                    out[key] += val
            for reason, ent in eng.stats["fallback_reasons"].items():
                agg = out["fallback_reasons"].setdefault(
                    reason, {"count": 0, "docs": 0})
                agg["count"] += ent["count"]
                agg["docs"] += ent["docs"]
        out["router"] = self._agg_router.snapshot()
        return out

    def device_segments_stats(self) -> dict:
        """The generational device-corpus counters summed over every
        shard's store (`VectorStoreShard.segment_stats`): rebuilds by
        reason and the rebuilds avoided, seals, merges (by reason) and
        their nanos, tombstoned rows, and generations, rows and bytes by
        tier. The `_nodes/stats indices.segments` section is not ported;
        this is its content."""
        out: dict = {"full_rebuilds": 0, "rebuilds_avoided": 0,
                     "rebuild_reasons": {}, "merge_reasons": {},
                     "tiers": {}}
        with self._lock:
            services = list(self.indices.values())
        for svc in services:
            for shard in svc.shards:
                for key, val in shard.vector_store.segment_stats().items():
                    if key == "tiers":
                        for t, tv in val.items():
                            slot = out["tiers"].setdefault(
                                t, {k: 0 for k in tv})
                            for k, v in tv.items():
                                slot[k] += v
                    elif isinstance(val, dict):
                        slot = out[key]
                        for k, v in val.items():
                            slot[k] = slot.get(k, 0) + v
                    elif isinstance(val, bool):
                        out[key] = out.get(key, False) or val
                    else:
                        out[key] = out.get(key, 0) + val
        return out

    def _allow_expensive(self) -> bool:
        """`search.allow_expensive_queries`: on unless it reads "false".
        The reference reads its dynamic cluster setting of the name; the
        port, which has no `_cluster/settings` yet, its node setting."""
        return self._setting_on("search.allow_expensive_queries")

    def _max_buckets(self) -> Optional[int]:
        v = self.settings.get("search.max_buckets")
        return int(v) if v is not None else None

    def _device_request_cache_enabled(self) -> bool:
        """`search.request_cache.device_paths` (default on): the device
        rung of the shard request cache, for kNN query phases and hybrid
        responses. The reference's dynamic cluster setting of the same
        name waits for `_cluster/settings`."""
        return self._setting_on("search.request_cache.device_paths")

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

    def _request_cache_key(self, cache, svc: IndexService, reader,
                           body: dict, partial_aggs: bool = False) -> tuple:
        """The index's name, its uuid (a recreated index of the same name
        reuses segment ids) and its settings, whether the aggregations are
        partial states or final, `search.max_buckets`, the reader's content
        fingerprint (a refresh that changed a shard misses), and the
        body; `search.allow_expensive_queries` too, so a body it refuses
        is never served from a cached answer."""
        settings = json.dumps(svc.settings, sort_keys=True, default=str)
        return cache.key((svc.name, svc.uuid, settings, partial_aggs,
                          self._max_buckets(), self._allow_expensive()),
                         reader_fingerprint(reader), body)

    def _search_rrf(self, svc: IndexService, body: dict) -> dict:
        """Reciprocal-rank fusion of the body's sub-searches through the
        index's hybrid executor (one dispatch per leg group, RRF, fetch of
        the final window), behind the device rung of the request cache: a
        body the rung holds is answered with a copy of its stored
        response, `took` 0, with no batch slot and no launch; a miss
        stores a copy of its response without `took`. A `profile` body is
        never served from the rung nor stored (the profile must describe a
        real execution): its `profile.hybrid.cache` says so."""
        ex = self._hybrid_executor(svc)
        cache = self._request_cache_for(body, hybrid=True)
        if cache is None:
            return ex.submit(body)
        if body.get("profile"):
            resp = ex.submit(body)
            prof = resp.get("profile")
            if prof is not None and "hybrid" in prof:
                prof["hybrid"]["cache"] = {
                    "rung": "device_request", "served": False,
                    "policy": "profile_bypass"}
            return resp
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

    def search(self, index_expr: Optional[str], body: Optional[dict],
               pre_filter_shard_size: Optional[int] = None,
               ignore_unavailable: bool = False,
               allow_no_indices: bool = True,
               expand_closed: bool = False) -> dict:
        """`_search` over an index expression (`resolve`: none, `_all`, a
        list, `*` patterns). Each index runs its query phase through its
        own store and the shard request cache (keyed on that index); the
        windows merge (`_merge_windows`) and the merged window is fetched.
        With `pre_filter_shard_size` (the URL parameter) a body with a
        query first runs can_match, and an index it proves empty is
        skipped whole: its shards count as `skipped` and no query phase
        runs. A `rank: {rrf}` body over one named index with no
        `highlight` runs the fused hybrid path; any other runs the
        general one (`_search_rrf_general`), as in the reference. A
        `profile` body answers `profile.shards`, one entry an index
        (`search/profile.py::shard_profile`), from that index's query phase
        with the thread's launch event trace on. `expand_closed`
        (`expand_wildcards` naming closed indices) lets patterns match
        closed indices, which the search then refuses, as the reference
        does."""
        start = time.perf_counter()
        body = self._rewrite_terms_lookup(body or {})
        check_track_total_hits(body)
        rank = body.get("rank")
        if isinstance(rank, dict) and "rrf" in rank:
            services = []
            if index_expr:
                try:
                    services = self.resolve(index_expr, ignore_unavailable,
                                            allow_no_indices)
                except SearchEngineError:
                    services = []   # the general path raises it
            if len(services) == 1 and "highlight" not in body:
                resp = self._search_rrf(services[0], body)
                _telemetrics.record("search.took", int(
                    (time.perf_counter() - start) * 1e9))
                return resp
            return self._search_rrf_general(index_expr, body,
                                            rank["rrf"] or {})
        services = self.resolve(index_expr, ignore_unavailable,
                                allow_no_indices,
                                expand_closed=expand_closed)
        boosts = self._index_boosts(body.get("indices_boost"),
                                    ignore_unavailable)
        aggs_spec = body.get("aggs") or body.get("aggregations")
        if aggs_spec:
            def field_type(f):
                for svc in services:
                    m = svc.mapper_service.get(f)
                    if m is not None:
                        return m.type_name
                return None
            validate_aggs(aggs_spec, field_type)
        partial = bool(aggs_spec) and len(services) > 1
        frm, size = window(body)
        profiled = bool(body.get("profile"))
        phases, profiles = [], []
        total, relation, max_score, skipped = 0, "eq", None, 0
        failures: List[dict] = []
        merged_aggs = None
        try:
            for svc in services:
                reader = svc.combined_reader()
                if pre_filter_shard_size is not None \
                        and has_range_clauses(body.get("query")) \
                        and not has_global_agg(aggs_spec) \
                        and not can_match(reader, body, svc.mapper_service):
                    skipped += svc.num_shards
                    continue
                q_start = time.perf_counter_ns()
                if profiled:
                    dispatch.record_events(True)
                try:
                    result, cache_note = self._query_phase(svc, reader,
                                                           body, partial)
                except ArrayIndexOutOfBoundsError as e:
                    # an aggregator failed the index's one shard
                    if svc.num_shards > 1:
                        raise hdr_multi_shard_error()
                    failures.append({"shard": 0, "index": svc.name,
                                     "node": self.node_id,
                                     "reason": e.to_dict()})
                    continue
                q_nanos = time.perf_counter_ns() - q_start
                _teletrace.record_span(f"query[{svc.name}]", q_nanos,
                                       index=svc.name)
                if profiled:
                    profiles.append((svc, result, q_nanos,
                                     dispatch.drain_events(), cache_note))
                    dispatch.record_events(False)
                phases.append((svc, reader, result))
        finally:
            if profiled:
                # a failed query phase must not leave the thread's launch
                # event trace recording into later requests
                dispatch.record_events(False)
        n = sum(svc.num_shards for svc in services)
        if failures and len(failures) >= n - skipped:
            raise SearchPhaseExecutionError("query", "all shards failed",
                                            failures)
        for svc, reader, result in phases:
            if result.aggregations is not None:
                # shared with the cache: merges and typed_keys copy
                merged_aggs = (result.aggregations if merged_aggs is None
                               else merge_partial_aggs(merged_aggs,
                                                       result.aggregations,
                                                       aggs_spec))
            total += result.total
            if result.relation == "gte":
                relation = "gte"
            if result.max_score is not None:
                boosted = result.max_score * boosts.get(svc.name, 1.0)
                max_score = (boosted if max_score is None
                             else max(max_score, boosted))
        m_start = time.perf_counter_ns()
        merged = self._merge_windows(phases, body,
                                     several=len(services) > 1,
                                     boosts=boosts)
        _teletrace.record_span("merge", time.perf_counter_ns() - m_start,
                               hits=len(merged))
        fetch_nanos: Dict[str, int] = {}
        hits = self._fetch_window(merged[frm:frm + size], body,
                                  expand=len(services) <= 1,
                                  nanos=fetch_nanos, boosts=boosts)
        for svc, _, _ in phases:
            _teletrace.record_span(f"fetch[{svc.name}]",
                                   fetch_nanos.get(svc.name, 0),
                                   index=svc.name)
        collapse = body.get("collapse")
        if collapse and inner_hits_specs(collapse) and len(services) > 1:
            self._expand_collapse_inner_hits(services, body, collapse, hits)
        resp = {"took": 0, "timed_out": False,
                "_shards": {"total": n, "successful": n - len(failures),
                            "skipped": skipped, "failed": len(failures),
                            **({"failures": failures} if failures else {})},
                "hits": {"total": {"value": total, "relation": relation},
                         "max_score": max_score, "hits": hits}}
        brs = body.get("batched_reduce_size")
        if brs and int(brs) < n:
            # a partial reduce a filled buffer, and the final one
            resp["num_reduce_phases"] = -(-n // int(brs)) + 1
        track = body.get("track_total_hits")
        if not tracks_total(body):
            del resp["hits"]["total"]
        elif isinstance(track, int) and not isinstance(track, bool) \
                and total > track:
            # the summed total crosses a cap each index stayed under
            resp["hits"]["total"] = {"value": track, "relation": "gte"}
        if merged_aggs is not None:
            resp["aggregations"] = (finalize_aggs(merged_aggs, aggs_spec)
                                    if partial else merged_aggs)
        suggest_spec = body.get("suggest")
        if suggest_spec:
            merged_suggest: Dict[str, list] = {}
            for svc, reader, _ in phases:
                ctx = SearchContext(reader, svc.mapper_service)
                merge_suggest(merged_suggest, execute_suggest(
                    ctx, suggest_spec, index_name=svc.name))
            resp["suggest"] = merged_suggest
        if profiled:
            resp["profile"] = {"shards": [
                shard_profile(svc.name, body, q_nanos,
                              fetch_nanos.get(svc.name, 0), result.total,
                              knn_phases=result.knn_phases,
                              dispatch_events=events,
                              aggs_profile=result.aggs_profile,
                              cache=cache_note)
                for svc, result, q_nanos, events, cache_note in profiles]}
        took = time.perf_counter() - start
        _telemetrics.record("search.took", int(took * 1e9))
        resp["took"] = int(took * 1000)
        return resp

    def _search_rrf_general(self, index_expr: Optional[str], body: dict,
                            rrf: dict) -> dict:
        """Reciprocal-rank fusion at the coordinator (the reference's
        general path): each ranked list (`sub_searches`, or `query` and
        each `knn` spec as a `{"knn": spec}` query clause) is a `_search`
        over the expression of `rank_window_size` hits, with the body's
        `_source`, `docvalue_fields` and `highlight`; hits fuse by
        (`_index`, `_id`) as sum(1 / (rank_constant + rank)), ties by that
        key, and keep their first list's rendering."""
        rank_constant = int(rrf.get("rank_constant", 60))
        rank_window = int(rrf.get("rank_window_size",
                                  rrf.get("window_size", 100)))
        size = int(body.get("size", 10))
        frm = int(body.get("from", 0) or 0)
        sub_queries = sub_queries_of(body)
        if len(sub_queries) < 2:
            raise IllegalArgumentError(
                "[rrf] requires at least 2 ranked lists (sub_searches, or "
                "query + knn)")
        passthrough = {k: v for k, v in body.items()
                       if k in ("_source", "docvalue_fields", "highlight")}
        start = time.perf_counter()
        fused: Dict[tuple, float] = {}
        hit_by_key: Dict[tuple, dict] = {}
        for q in sub_queries:
            resp = self.search(index_expr, {"query": q, "size": rank_window,
                                            **passthrough})
            for rank_pos, hit in enumerate(resp["hits"]["hits"]):
                key = (hit["_index"], hit["_id"])
                fused[key] = fused.get(key, 0.0) + 1.0 / (
                    rank_constant + rank_pos + 1)
                hit_by_key.setdefault(key, hit)
        ordered = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
        hits = []
        for key, score in ordered[frm:frm + size]:
            hit = dict(hit_by_key[key])
            hit["_score"] = score
            hit.pop("sort", None)
            hits.append(hit)
        return {"took": int((time.perf_counter() - start) * 1000),
                "timed_out": False,
                "hits": {"total": {"value": len(fused), "relation": "eq"},
                         "max_score": hits[0]["_score"] if hits else None,
                         "hits": hits}}

    def _query_phase(self, svc: IndexService, reader, body: dict,
                     partial_aggs: bool = False):
        """One index's query phase through the request cache's rung for the
        body (`_request_cache_for`), its aggregations through the index's
        engine (`_agg_engine`), as partial states when `partial_aggs`.
        A `profile` body bypasses the rung. Returns (result, the profile's
        cache note: the rung and whether it served the result, or None
        when no rung applies)."""
        cache = self._request_cache_for(body)
        key = result = None
        if cache is not None and not body.get("profile"):
            key = self._request_cache_key(cache, svc, reader, body,
                                          partial_aggs)
            result = cache.get(key)
        note = None if cache is None else {
            "rung": ("shard_request" if cache is self.caches.request
                     else "device_request"),
            "hit": result is not None}
        if result is None:
            ctx = SearchContext(reader, svc.mapper_service, svc.vector_store,
                                svc.settings, query_cache=self.caches.query)
            ctx.max_buckets = self._max_buckets()
            ctx.allow_expensive = self._allow_expensive()
            ctx.index_name = svc.name
            engine = (self._agg_engine(svc)
                      if body.get("aggs") or body.get("aggregations")
                      else None)
            result = execute_query_phase(ctx, body, engine, partial_aggs)
            if key is not None:
                cache.put(key, result)
        return result, note

    @staticmethod
    def _merge_windows(phases: list, body: dict, several: bool,
                       boosts: Optional[Dict[str, float]] = None) -> list:
        """The indices' windows as one ranked list of (phase, position):
        stably by score, each index's times its `indices_boost` (ties in
        the order the expression resolved, then each index's own order),
        or, when the body sorts, stably by each hit's sort tuple
        (`_sort_key_tuple`). Over several indices a collapse keeps the
        first hit of each group across them."""
        entries = [(pi, j) for pi, (_, _, r) in enumerate(phases)
                   for j in range(len(r.rows))]
        if body.get("sort"):
            entries.sort(key=lambda e: _sort_key_tuple(
                phases[e[0]][2].sort_values[e[1]]
                if phases[e[0]][2].sort_values is not None else None, body))
        elif len(phases) > 1:
            scores = np.concatenate([
                r.scores.astype(np.float64) * (boosts or {}).get(svc.name,
                                                                 1.0)
                for svc, _, r in phases])
            entries = [entries[i] for i in
                       np.argsort(-scores, kind="stable").tolist()]
        collapse = body.get("collapse")
        if collapse and several:
            seen, deduped = set(), []
            for pi, j in entries:
                _, reader, r = phases[pi]
                g = group_value(reader, collapse["field"], r.rows[j])
                if g not in seen:
                    seen.add(g)
                    deduped.append((pi, j))
            entries = deduped
        return [(phases[pi], j) for pi, j in entries]

    def _fetch_window(self, window_entries: list, body: dict,
                      expand: bool,
                      nanos: Optional[Dict[str, int]] = None,
                      boosts: Optional[Dict[str, float]] = None
                      ) -> List[dict]:
        """The fetch phase of the merged window: each run of hits of one
        index fetched together, from that index's reader, each `_score`
        times the index's `indices_boost`; each index's fetch time adds
        into `nanos`."""
        hits: List[dict] = []
        for _, group in itertools.groupby(window_entries,
                                          key=lambda e: id(e[0])):
            t0 = time.perf_counter_ns()
            group = list(group)
            svc, reader, r = group[0][0]
            run = [j for _, j in group]
            idx = np.asarray(run, dtype=np.int64)
            ctx = SearchContext(reader, svc.mapper_service, svc.vector_store,
                                svc.settings, query_cache=self.caches.query)
            fetched = fetch_hits(
                ctx, svc.name, body, r.rows[idx], r.scores[idx],
                None if r.sort_values is None
                else [r.sort_values[j] for j in run],
                expand_inner_hits=expand)
            factor = (boosts or {}).get(svc.name, 1.0)
            if factor != 1.0:
                for h in fetched:
                    if h.get("_score") is not None:
                        h["_score"] = float(h["_score"]) * factor
            hits.extend(fetched)
            if nanos is not None:
                nanos[svc.name] = (nanos.get(svc.name, 0)
                                   + time.perf_counter_ns() - t0)
        return hits

    def _expand_collapse_inner_hits(self, services: list, body: dict,
                                    collapse: dict, hits: List[dict]) -> None:
        """Each collapsed hit's `inner_hits` over every index (the
        reference's expand phase, one sub-search a group and index): the
        indices' hits merged by score, or by their `sort` tuples, cut to
        `size`, with the summed total."""
        field = collapse["field"]
        for hit in hits:
            vals = (hit.get("fields") or {}).get(field)
            gv = vals[0] if vals else None
            for spec in inner_hits_specs(collapse):
                want = int(spec.get("size", 3))
                sub_body = inner_hits_body(body, field, gv, spec, want)
                merged, total = [], 0
                for svc in services:
                    reader = svc.combined_reader()
                    ctx = SearchContext(reader, svc.mapper_service,
                                        svc.vector_store)
                    res = execute_query_phase(ctx, sub_body)
                    total += res.total
                    merged.extend(fetch_hits(ctx, svc.name, sub_body,
                                             res.rows, res.scores,
                                             res.sort_values))
                if spec.get("sort") is None:
                    merged.sort(key=lambda h: -(h.get("_score") or 0.0))
                else:
                    merged.sort(key=lambda h: tuple(h.get("sort") or []))
                hit.setdefault("inner_hits", {})[spec.get("name", field)] = {
                    "hits": {"total": {"value": total, "relation": "eq"},
                             "max_score": (merged[0].get("_score")
                                           if merged else None),
                             "hits": merged[:want]}}

    def _index_boosts(self, spec, ignore_unavailable: bool
                      ) -> Dict[str, float]:
        """`indices_boost` (a list of {index: boost} objects, or one
        object) as index name -> factor, the first entry naming an index
        winning; a name or pattern that names no index is the
        reference's 404 unless `ignore_unavailable`."""
        boosts: Dict[str, float] = {}
        if not spec:
            return boosts
        entries = spec.items() if isinstance(spec, dict) else \
            [e for d in spec for e in d.items()]
        for expr, boost in entries:
            matched = (self.resolve(expr)
                       if "*" in expr or expr in self.indices else [])
            if not matched:
                if ignore_unavailable:
                    continue
                raise IndexNotFoundError(expr)
            for svc in matched:
                boosts.setdefault(svc.name, float(boost))
        return boosts

    def _rewrite_terms_lookup(self, body: dict) -> dict:
        """A `terms` lookup (`{"terms": {field: {index, id, path,
        routing}}}`) in the body's `query` or `aggs` with the looked-up
        document's values inlined, as the reference's coordinator does: a
        missing document or path gives no values, an unknown index its
        404. The key scan never stringifies the body (a dense query
        vector would cost more than the rewrite)."""
        def has_terms(node):
            if isinstance(node, dict):
                return "terms" in node or any(has_terms(v)
                                              for v in node.values())
            if isinstance(node, list) and node \
                    and isinstance(node[0], (dict, list)):
                return any(has_terms(i) for i in node)
            return False

        scope = {k: body.get(k) for k in ("query", "aggs", "aggregations")
                 if body.get(k) is not None}
        if not scope or not has_terms(scope):
            return body
        body = dict(body)
        for k in scope:
            body[k] = copy.deepcopy(body[k])

        def walk(node):
            if isinstance(node, dict):
                t = node.get("terms")
                if isinstance(t, dict):
                    for f, v in list(t.items()):
                        if f in ("boost", "_name") or not isinstance(v, dict) \
                                or "index" not in v:
                            continue
                        doc = self.get_doc(v["index"], str(v.get("id")),
                                           routing=v.get("routing"))
                        vals = get_path(doc.get("_source") or {},
                                        str(v.get("path", "")))
                        t[f] = (vals if isinstance(vals, list)
                                else [vals] if vals is not None else [])
                for val in node.values():
                    walk(val)
            elif isinstance(node, list):
                for item in node:
                    walk(item)
        for k in scope:
            walk(body[k])
        return body

    # ---------------------------------------------------------------- scroll
    def search_scroll_start(self, index_expr: Optional[str],
                            body: Optional[dict],
                            keep_alive: str = "1m") -> dict:
        """`_search?scroll=`: each index's query phase over every matching
        row (its window unbounded, every hit counted) on a reader the
        context pins; the hits merged as `_merge_windows` merges them, by
        score or by sort tuple, into one order kept as arrays; the first
        page, and the scroll id."""
        body = self._rewrite_terms_lookup(dict(body or {}))
        if body.get("collapse") is not None:
            raise IllegalArgumentError(
                "cannot use `collapse` in a scroll context")
        size = int(body["size"]) if body.get("size") is not None else 10
        services = self.resolve(index_expr)
        for svc in services:
            mrw = int(svc.settings.get("index.max_result_window",
                                       MAX_RESULT_WINDOW))
            if size > mrw:
                raise IllegalArgumentError(
                    f"Batch size is too large, size must be less than or "
                    f"equal to: [{mrw}] but was [{size}]. Scroll batch "
                    f"sizes cost as much memory as result windows so they "
                    f"are controlled by the [index.max_result_window] "
                    f"index level setting.")
        parts, total = [], 0
        for svc in services:
            reader = svc.combined_reader()
            big = dict(body)
            big["size"] = max(reader.num_docs, 1)
            big["__unbounded_window__"] = True
            big["track_total_hits"] = True
            big.pop("from", None)
            ctx = SearchContext(reader, svc.mapper_service, svc.vector_store,
                                svc.settings, query_cache=self.caches.query)
            result = execute_query_phase(ctx, big)
            total += result.total
            parts.append((svc, reader, result.rows, result.scores,
                          result.sort_values))
        part = np.concatenate([np.full(len(p[2]), i, dtype=np.int32)
                               for i, p in enumerate(parts)]
                              or [np.zeros(0, dtype=np.int32)])
        pos = np.concatenate([np.arange(len(p[2]), dtype=np.int64)
                              for p in parts]
                             or [np.zeros(0, dtype=np.int64)])
        if body.get("sort"):
            order = sorted(range(len(part)), key=lambda i: _sort_key_tuple(
                parts[part[i]][4][pos[i]]
                if parts[part[i]][4] is not None else None, body))
            order = np.asarray(order, dtype=np.int64)
        else:
            scores = np.concatenate([p[3] for p in parts]
                                    or [np.zeros(0, dtype=np.float32)])
            order = np.argsort(-scores.astype(np.float64), kind="stable")
        scroll_id = self.scrolls.create(
            parts, part[order], pos[order], body,
            parse_time_value(keep_alive, "scroll"), total)
        resp = self._scroll_page(self.scrolls.get(scroll_id), size)
        resp["_scroll_id"] = scroll_id
        return resp

    def search_scroll_next(self, scroll_id: str,
                           keep_alive: Optional[str] = None) -> dict:
        sc = self.scrolls.get(scroll_id)
        if keep_alive:
            sc.keep_alive = parse_time_value(keep_alive, "scroll")
        size = int(sc.body["size"]) if sc.body.get("size") is not None \
            else 10
        resp = self._scroll_page(sc, size)
        resp["_scroll_id"] = scroll_id
        return resp

    @staticmethod
    def _scroll_page(sc, size: int) -> dict:
        """The next `size` hits of a scroll, read from its pinned readers:
        `_index`, `_id`, `_score` (null under a sort), `_source` and the
        sort tuple."""
        part, pos = sc.take(size)
        sorted_ = bool(sc.body.get("sort"))
        hits = []
        for pi, j in zip(part.tolist(), pos.tolist()):
            svc, reader, rows, scores, sort_values = sc.parts[pi]
            row = int(rows[j])
            hit = {"_index": svc.name, "_id": reader.get_id(row),
                   "_score": None if sorted_ else float(scores[j]),
                   "_source": reader.get_source(row)}
            if sort_values is not None:
                hit["sort"] = list(sort_values[j])
            hits.append(hit)
        return {"took": 0, "timed_out": False,
                "_shards": {"total": 1, "successful": 1, "skipped": 0,
                            "failed": 0},
                "hits": {"total": {"value": sc.total, "relation": "eq"},
                         "max_score": None, "hits": hits}}

    def clear_scroll(self, scroll_id: str) -> dict:
        return {"succeeded": True,
                "num_freed": 1 if self.scrolls.delete(scroll_id) else 0}

    def clear_all_scrolls(self) -> dict:
        return {"succeeded": True, "num_freed": self.scrolls.delete_all()}

    def open_point_in_time(self, index_expr: str,
                           keep_alive: str = "5m") -> dict:
        """`POST /{index}/_pit`: the indices' current readers kept under a
        new id."""
        keep = parse_time_value(keep_alive, "keep_alive")
        readers = [(svc, svc.combined_reader())
                   for svc in self.resolve(index_expr, forbid_closed=False)]
        return {"id": self.pits.open(index_expr, readers, keep)}

    def close_point_in_time(self, pit_id) -> dict:
        found = self.pits.close(pit_id)
        return {"succeeded": found, "num_freed": 1 if found else 0}

    def count(self, index_expr: Optional[str], body: Optional[dict]) -> dict:
        """`_count`: the body's query phase on every index the expression
        names, at size 0 with every hit counted (`count_body`)."""
        body = count_body(self._rewrite_terms_lookup(body or {}))
        total = 0
        for svc in self.resolve(index_expr):
            ctx = SearchContext(svc.combined_reader(), svc.mapper_service,
                                svc.vector_store, svc.settings)
            total += execute_query_phase(ctx, body).total
        # the reference reports one shard whatever the expression names
        return {"count": total, "_shards": {"total": 1, "successful": 1,
                                            "skipped": 0, "failed": 0}}

    def msearch(self, lines: List[dict]) -> dict:
        """`_msearch`: (header, body) line pairs, each searched over its
        header's `index`; an error answers its own entry."""
        responses = []
        for i in range(0, len(lines), 2):
            header = lines[i] or {}
            body = lines[i + 1] if i + 1 < len(lines) else {}
            try:
                resp = self.search(header.get("index"), body)
                resp["status"] = 200
                responses.append(resp)
            except SearchEngineError as e:
                responses.append({"error": e.to_wrapped_dict(),
                                  "status": e.status})
        return {"took": 0, "responses": responses}

    # ------------------------------------------------------ search templates
    def search_template(self, index_expr: Optional[str], body: dict) -> dict:
        """`_search/template`: the template rendered with its params, then
        searched (the body's `explain` carried over)."""
        rendered = self.scripts.render_template(body)
        if body.get("explain"):
            rendered["explain"] = True
        return self.search(index_expr, rendered)

    def msearch_template(self, lines: List[dict],
                         default_index: Optional[str] = None) -> dict:
        """`_msearch/template`: (header, template) line pairs, each
        rendered and searched over its header's `index`; an error answers
        its own entry."""
        if len(lines) % 2 != 0:
            raise ParsingError(
                "_msearch/template expects header/body line pairs")
        responses = []
        for i in range(0, len(lines), 2):
            header, tmpl = lines[i], lines[i + 1]
            index = header.get("index") or default_index
            try:
                rendered = self.scripts.render_template(tmpl)
                responses.append({**self.search(index, rendered),
                                  "status": 200})
            except SearchEngineError as e:
                responses.append({"error": e.to_dict(), "status": e.status})
        return {"responses": responses}

    # ---------------------------------------------------------------- caches
    def clear_cache(self, name: Optional[str] = None) -> dict:
        """`POST [/{index}]/_cache/clear`: drop the host rung of the
        request cache and the query cache, node-wide, as the reference
        does; the device rung stays (its entries are keyed on the reader's
        content, so none can be stale)."""
        services = self.resolve(name)
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
        services = [s for s in self.resolve(name, forbid_closed=False)
                    if not s.closed]
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

    # ------------------------------------------------------------ telemetry
    def _nodes_envelope(self, nodes: dict) -> dict:
        return {"_nodes": {"total": len(nodes), "successful": len(nodes),
                           "failed": 0},
                "cluster_name": self.cluster_name, "nodes": nodes}

    @staticmethod
    def telemetry_stats_section() -> dict:
        """`_nodes/stats/telemetry`: the process-wide metrics registry
        (end-to-end search latency, queue wait, device dispatch and sync,
        p50/p90/p99/p999 each; the in-flight gauge) and the tracer's
        sampling and ring counters."""
        return {**telemetry.REGISTRY.snapshot(),
                "tracing": telemetry.TRACER.snapshot()}

    def telemetry_stats_api(self) -> dict:
        """`GET _nodes/stats/telemetry`: this node's name and roles with
        the telemetry section, in the reference's envelope."""
        return self._nodes_envelope({self.node_id: {
            "name": self.node_name, "roles": ["data", "ingest", "master"],
            "telemetry": self.telemetry_stats_section()}})

    def local_traces_section(self, limit: int = 50) -> dict:
        """This node's completed traces, most recent first (the tracer is
        process-wide; each trace names the node it completed on)."""
        return {"name": self.node_name,
                "traces": telemetry.TRACER.traces(node_id=self.node_id,
                                                  limit=limit)}

    def local_tasks_section(self, actions: Optional[str] = None) -> dict:
        return {"name": self.node_name,
                "roles": ["data", "ingest", "master"],
                "tasks": {t.task_id: t.to_dict(self.node_id)
                          for t in self.tasks.list_tasks(actions)}}

    def traces_api(self, limit: int = 50) -> dict:
        return self._nodes_envelope(
            {self.node_id: self.local_traces_section(limit)})

    def tasks_list_api(self, actions: Optional[str] = None) -> dict:
        return {"nodes": {self.node_id: self.local_tasks_section(actions)}}

    def task_get_api(self, task_id: str) -> dict:
        t = self.tasks.get(task_id)
        return {"completed": False, "task": t.to_dict(self.node_id)}

    def task_cancel_api(self, task_id: str) -> dict:
        t = self.tasks.cancel(task_id)
        return {"nodes": {self.node_id: {
            "tasks": {t.task_id: t.to_dict(self.node_id)}}}}

    def tasks_cancel_all_api(self, actions: Optional[str] = None) -> dict:
        """`POST _tasks/_cancel`: cancel every cancellable task whose action
        matches; each is listed whether it was cancellable or not."""
        matched = self.tasks.list_tasks(actions)
        if not matched:
            return {"nodes": {}, "node_failures": []}
        for t in matched:
            if t.cancellable:
                t.cancelled = True
        return {"nodes": {self.node_id: {
            "name": self.node_name,
            "tasks": {t.task_id: t.to_dict(self.node_id)
                      for t in matched}}}}


def _sort_key_tuple(sort_values, body: dict) -> tuple:
    """A hit's merge key under the body's sort, as the reference's
    coordinator builds it: each clause's order from the body (a clause
    given as a bare string sorts ascending here), a string inverted for a
    descending one, and a missing value last whatever the order."""
    sort = body.get("sort")
    if isinstance(sort, (str, dict)):
        sort = [sort]
    keys: list = []
    for spec, v in zip(sort or [], sort_values or []):
        direction = "asc"
        if isinstance(spec, dict):
            ((_, o),) = spec.items()
            direction = o if isinstance(o, str) else o.get("order", "asc")
        if isinstance(v, str):
            keys.append(v if direction == "asc" else _InvStr(v))
        elif v is None:
            keys.append(_MISSING)
        else:
            keys.append(float(v) if direction == "asc" else -float(v))
    return tuple(keys)


class _InvStr:
    """A string in reversed order, for a descending clause's key."""

    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def __lt__(self, other):
        if isinstance(other, _MissingLast):
            return True
        return self.s > other.s

    def __eq__(self, other):
        return isinstance(other, _InvStr) and self.s == other.s


class _MissingLast:
    """Greater than every other key: a missing value sorts last."""

    __slots__ = ()

    def __lt__(self, other):
        return False

    def __gt__(self, other):
        return not isinstance(other, _MissingLast)

    def __eq__(self, other):
        return isinstance(other, _MissingLast)


_MISSING = _MissingLast()


def _apply_update_script(source: dict, script_spec, ctx_extra=None) -> dict:
    """An update script through the sandboxed Painless interpreter
    (`script/painless.py`): it may change `ctx._source` (loops,
    conditionals, list and map methods, functions); returns the changed
    source, and its verdict (`ctx.op`: index, none or delete) lands in
    `ctx_extra["op"]`. A stored script is resolved by id; a compile
    error, a sandbox violation or a runtime error is the reference's
    400."""
    from elasticsearch_tpu_torch.script.painless import (
        FrozenParams, compile_painless, execute,
    )
    from elasticsearch_tpu_torch.script.service import resolve_stored
    if isinstance(script_spec, str):
        script_spec = {"source": script_spec}
    script_spec = resolve_stored(script_spec, "usable as an update script")
    src = script_spec.get("source", "")
    params = script_spec.get("params", {})
    ctx_obj = {"_source": source, "op": "index"}
    if ctx_extra:
        ctx_obj.update(ctx_extra)
    try:
        program = compile_painless(src)
    except Exception as e:
        raise IllegalArgumentError(f"compile error in update script: {e}")
    execute(program, {"ctx": ctx_obj, "params": FrozenParams(params)})
    if ctx_extra is not None:
        ctx_extra["op"] = ctx_obj.get("op", "index")
    return source


def _deep_merge(dst: dict, src: dict) -> None:
    """The `doc` of an update into a source: objects merge key by key,
    anything else replaces."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def _apply_mget_projection(svc: Optional[IndexService], doc: dict, spec: dict,
                           req_stored_fields, req_source=None) -> None:
    """`stored_fields` and `_source` filtering of a fetched document (a GET,
    an `_mget` entry, an update's `get`): the entry's own spec, else the
    request's."""
    if "_source" not in spec and req_source is not None:
        spec = {**spec, "_source": req_source}
    sf = spec.get("stored_fields", req_stored_fields)
    if sf:
        sf = [sf] if isinstance(sf, str) else list(sf)
        fields = {}
        for fname in sf:
            if fname.startswith("_") or svc is None:
                continue  # metadata fields ride at the top level
            mapper = svc.mapper_service.get(fname)
            if mapper is None or not mapper.params.get("store"):
                continue
            val = get_path(doc.get("_source") or {}, fname)
            if val is not None:
                fields[fname] = val if isinstance(val, list) else [val]
        if fields:
            doc["fields"] = fields
        # stored_fields suppress _source unless it is asked for
        if "_source" not in sf and spec.get("_source") in (None, False):
            doc.pop("_source", None)
    src_spec = spec.get("_source")
    if src_spec is False:
        doc.pop("_source", None)
    elif isinstance(src_spec, (list, str, dict)) \
            and doc.get("_source") is not None:
        includes, excludes = source_patterns(src_spec)
        doc["_source"] = filter_source(doc["_source"], includes, excludes)
