"""A node's feature services (port of `elasticsearch_tpu/node_admin.py` and
of the `_pit` routes of `elasticsearch_tpu/rest/actions_admin.py`).

Every instrumented REST request registers a task (`telemetry.rest_request`);
`GET _tasks` lists them, `GET _tasks/{id}` reads one, and
`POST _tasks/{id}/_cancel` or `POST _tasks/_cancel` cancels them. The
errors for an unknown task, a task of another node and a task that is not
cancellable are the reference's, word for word.

A scroll context (`ScrollService`) holds a search's whole ranked result:
for each index its pinned reader and the rows, scores and sort tuples of
its query phase, and the merged order of them all as two int arrays; a
page fetches its hits from the pinned readers, so writes, deletes,
refreshes and merges after the start do not show. A context lives
`keep_alive` seconds past its last use. `PointInTimeService` keeps the
readers of `POST /{index}/_pit` until `DELETE /_pit` or their keep-alive
ends (each open and close reaps the expired).

`AsyncSearchService` runs a search on a worker thread and keeps its
response, or its error (any exception, a device error too), under an id.
The reindex family (`reindex`, `update_by_query`, `delete_by_query`)
scans the matching documents of a refreshed reader (`_scan_all`, one
batch of documents at a time), writes them through the node's document
paths (a reindex through its `_bulk` path, which answers for each
document as a write of its own would) and ends with one refresh, so a
card-resident corpus takes its generational O(delta) path.
`field_caps`, `validate_query` and `explain_doc` answer as the
reference's do; a `knn` clause under `_explain` scores on the store's
exact route. Index templates are not ported.
"""

from __future__ import annotations

import copy
import fnmatch
import threading
import time
import uuid
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationError, IllegalArgumentError, ParsingError,
    ResourceNotFoundError, SearchEngineError,
)


class Task:
    """One live in-flight request (the reference's Task with the
    CancellableTask headers): carries the caller's `X-Opaque-ID` and the
    request's trace, so `GET _tasks` answers action, node, running time,
    opaque id, trace id and current span for anything in flight. The Task
    itself is the cancellation token: the combining batcher's queue entry
    holds it, and the batcher sheds a queued entry whose `cancelled` has
    flipped when it next claims a batch (`serving/batcher.py`
    `_claim_locked`)."""

    __slots__ = ("task_id", "action", "description", "start_ms",
                 "start_mono_ns", "cancellable", "cancelled", "status",
                 "opaque_id", "trace")

    def __init__(self, task_id, action, description, cancellable=True,
                 opaque_id=None, trace=None):
        self.task_id = task_id
        self.action = action
        self.description = description
        self.start_ms = int(time.time() * 1000)   # epoch for display only
        # running time is a duration: the monotonic clock (time.time can
        # step backwards)
        self.start_mono_ns = time.monotonic_ns()
        self.cancellable = cancellable
        self.cancelled = False
        self.status: dict = {}
        self.opaque_id = opaque_id
        self.trace = trace   # telemetry.trace.Trace | None

    def to_dict(self, node_id: str) -> dict:
        out = {"node": node_id, "id": int(self.task_id.split(":")[1]),
               "type": "transport", "action": self.action,
               "description": self.description,
               "start_time_in_millis": self.start_ms,
               "running_time_in_nanos":
                   time.monotonic_ns() - self.start_mono_ns,
               "cancellable": self.cancellable,
               "cancelled": self.cancelled,
               "headers": ({"X-Opaque-Id": self.opaque_id}
                           if self.opaque_id else {}),
               "status": self.status or None}
        if self.trace is not None:
            out["trace_id"] = self.trace.trace_id
            current = self.trace.current_span_name()
            if current is not None:
                out["current_span"] = current
        return out


class TaskManager:
    """Per-node task registry with cancellation (the reference's
    TaskManager)."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        self._counter = 0
        self._tasks: Dict[str, Task] = {}
        self._lock = threading.Lock()

    def register(self, action: str, description: str = "",
                 cancellable: bool = True, opaque_id=None,
                 trace=None) -> Task:
        with self._lock:
            self._counter += 1
            task = Task(f"{self.node_id}:{self._counter}", action, description,
                        cancellable, opaque_id=opaque_id, trace=trace)
            self._tasks[task.task_id] = task
            return task

    def unregister(self, task: Task) -> None:
        with self._lock:
            self._tasks.pop(task.task_id, None)

    def list_tasks(self, actions: Optional[str] = None) -> List[Task]:
        with self._lock:
            tasks = list(self._tasks.values())
        if actions:
            patterns = actions.split(",")
            tasks = [t for t in tasks
                     if any(fnmatch.fnmatch(t.action, p) for p in patterns)]
        return tasks

    def get(self, task_id: str) -> Task:
        with self._lock:
            t = self._tasks.get(task_id)
        if t is None:
            node = str(task_id).rsplit(":", 1)[0]
            if node != self.node_id:
                raise ResourceNotFoundError(
                    f"task [{task_id}] belongs to the node [{node}] which "
                    f"isn't part of the cluster and there is no record of "
                    f"the task")
            raise ResourceNotFoundError(
                f"task [{task_id}] isn't running and hasn't stored its "
                f"results")
        return t

    def cancel(self, task_id: str) -> Task:
        t = self.get(task_id)
        if not t.cancellable:
            raise IllegalArgumentError(f"task [{task_id}] is not cancellable")
        t.cancelled = True
        return t


class ScrollContext:
    """One scroll: `parts` holds (service, pinned reader, rows, scores,
    sort tuples or None) an index, `part` and `pos` the merged order (the
    part and the position within it of each hit), `cursor` the hits
    served."""

    __slots__ = ("scroll_id", "parts", "part", "pos", "cursor", "body",
                 "expiry", "keep_alive", "total", "_lock")

    def __init__(self, scroll_id: str, parts: list, part: np.ndarray,
                 pos: np.ndarray, body: dict, keep_alive_s: float,
                 total: int):
        self.scroll_id = scroll_id
        self.parts = parts
        self.part = part
        self.pos = pos
        self.cursor = 0
        self.body = body
        self.keep_alive = keep_alive_s
        self.expiry = time.time() + keep_alive_s
        self.total = total
        self._lock = threading.Lock()

    def take(self, size: int):
        """The next `size` entries of the merged order, (parts, positions),
        each served once though two requests page at the same time."""
        with self._lock:
            lo = self.cursor
            self.cursor = min(lo + size, len(self.part))
        return self.part[lo:lo + size], self.pos[lo:lo + size]


class ScrollService:
    """The node's scroll contexts by id; an expired one is dropped at the
    next lookup."""

    def __init__(self):
        self._contexts: Dict[str, ScrollContext] = {}
        self._lock = threading.Lock()

    def create(self, parts: list, part: np.ndarray, pos: np.ndarray,
               body: dict, keep_alive_s: float, total: int) -> str:
        scroll_id = uuid.uuid4().hex
        with self._lock:
            self._contexts[scroll_id] = ScrollContext(
                scroll_id, parts, part, pos, body, keep_alive_s, total)
        return scroll_id

    def get(self, scroll_id: str) -> ScrollContext:
        self.evict_expired()
        with self._lock:
            sc = self._contexts.get(scroll_id)
        if sc is None:
            raise ResourceNotFoundError(
                f"No search context found for id [{scroll_id}]",
                scroll_id=scroll_id)
        sc.expiry = time.time() + sc.keep_alive
        return sc

    def delete(self, scroll_id: str) -> bool:
        with self._lock:
            return self._contexts.pop(scroll_id, None) is not None

    def delete_all(self) -> int:
        with self._lock:
            n = len(self._contexts)
            self._contexts.clear()
        return n

    def evict_expired(self) -> None:
        now = time.time()
        with self._lock:
            for sid in [s for s, c in self._contexts.items()
                        if c.expiry < now]:
                del self._contexts[sid]

    def nbytes(self) -> int:
        """The bytes of the contexts' arrays: each index's rows and scores
        and the merged order."""
        with self._lock:
            contexts = list(self._contexts.values())
        return sum(sc.part.nbytes + sc.pos.nbytes
                   + sum(p[2].nbytes + p[3].nbytes for p in sc.parts)
                   for sc in contexts)


class PointInTimeService:
    """Point-in-time readers by id: (service, reader) for each index
    opened, kept until closed or `keep_alive` seconds after opening."""

    def __init__(self):
        self._pits: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def _reap(self) -> None:
        now = time.time()
        for pid in [p for p, e in self._pits.items() if e["expires"] <= now]:
            del self._pits[pid]

    def open(self, index: str, readers: list, keep_alive_s: float) -> str:
        pit_id = uuid.uuid4().hex
        with self._lock:
            self._reap()
            self._pits[pit_id] = {"index": index, "readers": readers,
                                  "keep_alive": keep_alive_s,
                                  "expires": time.time() + keep_alive_s}
        return pit_id

    def close(self, pit_id) -> bool:
        with self._lock:
            self._reap()
            return self._pits.pop(pit_id, None) is not None


class AsyncSearchService:
    """`_async_search`: submit returns at once (or after
    `wait_for_completion_timeout`) with an id; the search runs on a worker
    thread and its response or error stays readable until deleted or
    expired."""

    def __init__(self):
        self._results: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def submit(self, run: Callable[[], dict],
               wait_for_completion_s: float = 1.0,
               keep_alive_s: float = 300.0) -> dict:
        search_id = uuid.uuid4().hex
        now = time.time()
        entry = {"id": search_id, "is_running": True, "is_partial": True,
                 "start_time_in_millis": int(now * 1000),
                 "expiration_time_in_millis":
                     int((now + keep_alive_s) * 1000),
                 "response": None, "error": None}
        with self._lock:
            self._results[search_id] = entry
        done = threading.Event()

        def work():
            try:
                resp = run()
                with self._lock:
                    entry["response"] = resp
            except SearchEngineError as e:
                with self._lock:
                    entry["error"] = e.to_dict()
            except Exception as e:  # a device error too: never lost
                with self._lock:
                    entry["error"] = {"type": "exception", "reason": str(e)}
            finally:
                with self._lock:
                    entry["is_running"] = False
                    entry["is_partial"] = False
                done.set()

        threading.Thread(target=work, daemon=True,
                         name=f"async-search-{search_id[:8]}").start()
        done.wait(timeout=wait_for_completion_s)
        return self.status(search_id)

    def _evict_expired(self) -> None:
        now_ms = time.time() * 1000
        for sid in [s for s, e in self._results.items()
                    if not e["is_running"]
                    and e["expiration_time_in_millis"] < now_ms]:
            del self._results[sid]

    def status(self, search_id: str) -> dict:
        with self._lock:
            self._evict_expired()
            entry = self._results.get(search_id)
            if entry is None:
                raise ResourceNotFoundError(
                    f"async search [{search_id}] not found")
            out = {k: entry[k] for k in (
                "id", "is_running", "is_partial", "start_time_in_millis",
                "expiration_time_in_millis")}
            if entry["response"] is not None:
                out["response"] = entry["response"]
            if entry["error"] is not None:
                out["error"] = entry["error"]
            return out

    def delete(self, search_id: str) -> bool:
        with self._lock:
            return self._results.pop(search_id, None) is not None


# ---------------------------------------------------------------------------
# the reindex family, run against the node
# ---------------------------------------------------------------------------

SCAN_BATCH = 4096     # documents a `_scan_all` batch


def _scan_all(node, index_expr: str, query: dict) -> Iterator[List[dict]]:
    """Every live document the query matches, as batches of {_index, _id,
    _source, _seq_no, _primary_term}. Each index of the expression is
    refreshed and its matching rows found before the first batch, so the
    caller's writes do not change what is scanned; the rows come in
    ascending order. A `_source` shares nested values with the stored
    document: a caller that changes it copies it first."""
    from elasticsearch_tpu_torch.index.engine import PRIMARY_TERM
    from elasticsearch_tpu_torch.search.queries import (
        SearchContext, parse_query,
    )
    plans = []
    for svc in node.resolve(index_expr, forbid_closed=False):
        svc.refresh()
        reader = svc.combined_reader()
        ctx = SearchContext(reader, svc.mapper_service, svc.vector_store,
                            svc.settings)
        plans.append((svc.name, reader, parse_query(query).execute(ctx).rows))
    for name, reader, rows in plans:
        for lo in range(0, len(rows), SCAN_BATCH):
            yield [{"_index": name, "_id": reader.get_id(row),
                    "_source": reader.get_source(row),
                    "_seq_no": reader.get_seq_no(row),
                    "_primary_term": PRIMARY_TERM}
                   for row in rows[lo:lo + SCAN_BATCH].tolist()]


def _write_part(node, dest: str, part: List[dict], script) -> list:
    """Scanned documents written to `dest` in order through the node's
    `_bulk` path (`Node.bulk`), each through the `script` first when there
    is one: the bulk items, which write, fail and take seq_nos as
    `index_doc` one document at a time would. A script that raises ends
    the reindex after the documents before it are written, as in the
    reference."""
    from elasticsearch_tpu_torch.node import _apply_update_script
    ops: List[dict] = []
    try:
        for doc in part:
            ops += [{"index": {"_index": dest, "_id": doc["_id"]}},
                    doc["_source"] if script is None else
                    _apply_update_script(copy.deepcopy(doc["_source"]),
                                         script)]
    finally:
        items = node.bulk(ops)["items"] if ops else []
    return [item["index"] for item in items]


def reindex(node, body: dict) -> dict:
    """`POST /_reindex`: the source's matching documents (`query`, default
    all) written into `dest`, at most `max_docs` of them, each through the
    `script` when there is one; failures listed, one refresh of `dest` at
    the end. Its task is listed under `_tasks` and stops at a cancel."""
    src = body.get("source", {})
    dest = body.get("dest", {})
    if "index" not in src or "index" not in dest:
        raise IllegalArgumentError(
            "reindex requires source.index and dest.index")
    if dest.get("pipeline") is not None:
        raise IllegalArgumentError(
            "[dest.pipeline] is not supported by this build: ingest "
            "pipelines are not ported (ROADMAP.md queue 1 item 16)")
    query = src.get("query", {"match_all": {}})
    script = body.get("script")
    max_docs = body.get("max_docs")
    task = node.tasks.register(
        "indices:data/write/reindex",
        f"reindex from [{src['index']}] to [{dest['index']}]")
    created = updated = 0
    failures = []
    try:
        for batch in _scan_all(node, src["index"], query):
            # at most the documents left under `max_docs`; a failure does
            # not count, so the batch goes on after one
            while batch and not task.cancelled:
                room = len(batch) if max_docs is None \
                    else int(max_docs) - created - updated
                if room <= 0:
                    break
                part, batch = batch[:room], batch[room:]
                for item in _write_part(node, dest["index"], part, script):
                    if "error" in item:
                        failures.append({"id": item["_id"],
                                         "cause": item["error"]})
                    elif item["result"] == "created":
                        created += 1
                    else:
                        updated += 1
            if task.cancelled or (max_docs is not None
                                  and created + updated >= int(max_docs)):
                break
        node.index(dest["index"]).refresh()
    finally:
        node.tasks.unregister(task)
    return {"took": 0, "timed_out": False, "total": created + updated,
            "created": created, "updated": updated, "deleted": 0,
            "batches": 1, "version_conflicts": 0, "noops": 0,
            "retries": {"bulk": 0, "search": 0}, "failures": failures}


def update_by_query(node, index: str, body: Optional[dict]) -> dict:
    """`POST /{index}/_update_by_query`: each matching document re-indexed
    under its seq_no and primary term (a conflict is a failure), after
    the `script` when there is one (`ctx.op` `none` counts a noop,
    `delete` deletes it); one refresh at the end."""
    from elasticsearch_tpu_torch.node import _apply_update_script
    query = (body or {}).get("query", {"match_all": {}})
    script = (body or {}).get("script")
    task = node.tasks.register("indices:data/write/update/byquery",
                               f"update-by-query [{index}]")
    updated = deleted = noops = 0
    failures = []
    try:
        for batch in _scan_all(node, index, query):
            if task.cancelled:
                break
            for doc in batch:
                source, op = doc["_source"], "index"
                if script is not None:
                    verdict: dict = {}
                    try:
                        source = _apply_update_script(
                            copy.deepcopy(source), script,
                            ctx_extra=verdict)
                    except SearchEngineError as e:
                        failures.append({"id": doc["_id"],
                                         "cause": e.to_dict()})
                        continue
                    op = verdict.get("op", "index")
                try:
                    if op == "none":
                        noops += 1
                    elif op == "delete":
                        node.delete_doc(doc["_index"], doc["_id"])
                        deleted += 1
                    else:
                        node.index_doc(
                            doc["_index"], doc["_id"], source,
                            if_seq_no=doc["_seq_no"],
                            if_primary_term=doc["_primary_term"])
                        updated += 1
                except SearchEngineError as e:
                    failures.append({"id": doc["_id"], "cause": e.to_dict()})
        node.index(index).refresh()
    finally:
        node.tasks.unregister(task)
    # total counts every document processed, failures included
    return {"took": 0, "total": updated + deleted + noops + len(failures),
            "updated": updated, "deleted": deleted,
            "version_conflicts": len(failures), "noops": noops,
            "failures": failures}


def delete_by_query(node, index: str, body: dict) -> dict:
    """`POST /{index}/_delete_by_query`: each matching document deleted
    (a `query` is required); one refresh at the end."""
    query = (body or {}).get("query")
    if query is None:
        raise IllegalArgumentError("delete_by_query requires a query")
    task = node.tasks.register("indices:data/write/delete/byquery",
                               f"delete-by-query [{index}]")
    deleted = 0
    failures = []
    try:
        for batch in _scan_all(node, index, query):
            if task.cancelled:
                break
            for doc in batch:
                try:
                    node.delete_doc(doc["_index"], doc["_id"])
                    deleted += 1
                except SearchEngineError as e:
                    failures.append({"id": doc["_id"], "cause": e.to_dict()})
        node.index(index).refresh()
    finally:
        node.tasks.unregister(task)
    return {"took": 0, "total": deleted, "deleted": deleted,
            "version_conflicts": len(failures), "failures": failures}


# ---------------------------------------------------------------------------
# field caps, validate, explain
# ---------------------------------------------------------------------------

_AGGREGATABLE = {
    "keyword", "long", "integer", "short", "byte", "double", "float",
    "half_float", "scaled_float", "date", "date_nanos", "boolean", "ip",
    "geo_point", "unsigned_long", "version", "murmur3", "token_count",
    "constant_keyword", "wildcard", "flattened", "integer_range",
    "long_range", "float_range", "double_range", "date_range", "ip_range",
    "histogram", "aggregate_metric_double"}


def _index_field_caps(ms) -> Dict[str, tuple]:
    """path -> (type, searchable, aggregatable, meta) of one index's
    mapping, with an `object` entry for each parent path not mapped
    itself."""
    caps: Dict[str, tuple] = {}
    for path, mapper in ms.all_mappers():
        t = mapper.type_name
        p = mapper.params
        if t == "nested":
            caps[path] = ("nested", False, False, None)
            continue
        searchable = p.get("index", True) not in (False, "false")
        aggregatable = (t in _AGGREGATABLE
                        and p.get("doc_values", True) not in (False, "false"))
        caps[path] = (t, searchable, aggregatable, p.get("meta"))
    for path in list(caps):
        parts = path.split(".")
        for i in range(1, len(parts)):
            caps.setdefault(".".join(parts[:i]),
                            ("object", False, False, None))
    return caps


def field_caps(node, index_expr: Optional[str], fields: str,
               include_unmapped: bool = False) -> dict:
    """`_field_caps`: for each field matching `fields`, one entry a type
    across the indices, `searchable` / `aggregatable` true only when true
    in every index of that type; `indices` listed when the field has
    several types, the non-searchable and non-aggregatable indices when
    they are some of them, `meta` values merged into sorted lists."""
    patterns = [f.strip() for f in (fields or "*").split(",")]
    indices = node.resolve(index_expr, forbid_closed=False)
    index_names = [s.name for s in indices]
    percap: Dict[str, Dict[str, list]] = {}
    for svc in indices:
        for path, (t, se, ag, meta) in _index_field_caps(
                svc.mapper_service).items():
            if any(fnmatch.fnmatch(path, p) for p in patterns):
                percap.setdefault(path, {}).setdefault(t, []).append(
                    (svc.name, se, ag, meta))
    out: Dict[str, dict] = {}
    for field, types in sorted(percap.items()):
        mapped_in = {i for rows in types.values() for (i, _, _, _) in rows}
        buckets = dict(types)
        if include_unmapped and len(mapped_in) < len(index_names):
            buckets["unmapped"] = [(i, False, False, None)
                                   for i in index_names if i not in mapped_in]
        rendered = {}
        for t, rows in buckets.items():
            entry = {"type": t, "metadata_field": False,
                     "searchable": all(se for (_, se, _, _) in rows),
                     "aggregatable": all(ag for (_, _, ag, _) in rows)}
            if len(buckets) > 1:
                entry["indices"] = sorted(i for (i, _, _, _) in rows)
            non_se = sorted(i for (i, se, _, _) in rows if not se)
            if non_se and len(non_se) < len(rows):
                entry["non_searchable_indices"] = non_se
            non_ag = sorted(i for (i, _, ag, _) in rows if not ag)
            if non_ag and len(non_ag) < len(rows):
                entry["non_aggregatable_indices"] = non_ag
            merged: Dict[str, set] = {}
            for (_, _, _, meta) in rows:
                for k, v in (meta or {}).items():
                    vals = v if isinstance(v, list) else [v]
                    merged.setdefault(k, set()).update(map(str, vals))
            if merged:
                entry["meta"] = {k: sorted(v) for k, v in merged.items()}
            rendered[t] = entry
        out[field] = rendered
    return {"indices": index_names, "fields": out}


def validate_query(node, index_expr: Optional[str], body: Optional[dict],
                   explain: bool = False) -> dict:
    """`_validate/query`: whether the body's query parses; with `explain`,
    each index's explanation (`*:*` for none or `match_all`, else the
    parsed query's `to_dict` as a string) or the parse error as the
    reference renders it."""
    from elasticsearch_tpu_torch.search.queries import parse_query
    shards = {"total": 1, "successful": 1, "failed": 0}
    try:
        body = body or {}
        bad = [k for k in body if k not in ("query", "rewrite",
                                            "all_shards", "explain")]
        if bad:
            raise ParsingError(f"request does not support [{bad[0]}]")
        q = parse_query(body.get("query"))
        explanation = "*:*" if (body.get("query") is None
                                or "match_all" in (body.get("query") or {})) \
            else str(q.to_dict())
        out = {"valid": True, "_shards": shards}
        if explain:
            out["explanations"] = [
                {"index": s.name, "valid": True, "explanation": explanation}
                for s in node.resolve(index_expr, forbid_closed=False)]
        return out
    except (ParsingError, IllegalArgumentError) as e:
        out = {"valid": False, "_shards": shards}
        if explain:
            msg = f"org.elasticsearch.common.ParsingException: {e}"
            if "request does not support" not in str(e):
                msg += f"; nested: ParsingException[{e}];"
            out["error"] = msg
        return out


def explain_doc(node, index: str, doc_id: str, body: Optional[dict],
                source_spec=None) -> dict:
    """`_explain/{id}`: whether the document matches the body's query and
    its score there. A `knn` clause scores on the store's exact route
    (`SearchContext.knn_exact`), as the reference's host scoring does;
    `source_spec` (includes, excludes) adds the document's `_source`."""
    from elasticsearch_tpu_torch.search.queries import (
        SearchContext, parse_query,
    )
    from elasticsearch_tpu_torch.search.service import filter_source
    if not body or "query" not in body:
        raise ActionRequestValidationError(
            "Validation Failed: 1: query is missing;")
    svc = node.index(index)
    svc.refresh()
    reader = svc.combined_reader()
    ctx = SearchContext(reader, svc.mapper_service, svc.vector_store,
                        svc.settings)
    ctx.knn_exact = True
    q = parse_query(body.get("query"))
    ds = q.execute(ctx)
    ids = [reader.get_id(int(r)) for r in ds.rows]
    if doc_id not in ids:
        exists = any(reader.get_id(int(r)) == doc_id
                     for r in reader.live_global_rows())
        return {"_index": svc.name, "_id": doc_id, "matched": False,
                "explanation": {
                    "value": 0.0,
                    "description": "no matching term" if exists
                    else "document not found", "details": []}}
    at = ids.index(doc_id)
    score = float(ds.scores[at]) if ds.scores is not None else 1.0
    out = {"_index": svc.name, "_id": doc_id, "matched": True,
           "explanation": {"value": score,
                           "description": f"score from query {q.to_dict()}",
                           "details": []}}
    if source_spec is not None and source_spec is not False:
        includes, excludes = source_spec
        out["get"] = {"found": True, "_source": filter_source(
            reader.get_source(int(ds.rows[at])) or {}, includes, excludes)}
    return out
