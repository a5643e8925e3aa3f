"""Live tasks of a node: `Task` and `TaskManager` (port of the task half
of `elasticsearch_tpu/node_admin.py`).

Every instrumented REST request registers a task (`telemetry.rest_request`);
`GET _tasks` lists them, `GET _tasks/{id}` reads one, and
`POST _tasks/{id}/_cancel` or `POST _tasks/_cancel` cancels them. The
errors for an unknown task, a task of another node and a task that is not
cancellable are the reference's, word for word. The reference's other node
services of that module (scroll, async search, templates, reindex, field
caps) are not ported.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Dict, List, Optional

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
