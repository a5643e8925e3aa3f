"""A node's live tasks, scroll contexts and point-in-time readers (port of
the task and scroll half of `elasticsearch_tpu/node_admin.py` and of the
`_pit` routes of `elasticsearch_tpu/rest/actions_admin.py`).

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
ends (each open and close reaps the expired). The reference's other node
services of that module (async search, templates, reindex, field caps)
are not ported.
"""

from __future__ import annotations

import fnmatch
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ResourceNotFoundError,
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
