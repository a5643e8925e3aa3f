"""REST routing and dispatch (port of `elasticsearch_tpu/rest/controller.py`).

A path trie with {param} segments routes (method, path) to handlers: a
literal segment wins over a parameter, with backtracking, so `_all` or any
name without a literal route of its own reaches an `{index}` handler. A
HEAD request on a path with only a GET handler runs the GET handler and
answers its status with no body. Errors render as the reference's
structured error body {"error": {..., "root_cause": [...]}, "status": N}.
The `filter_path` query parameter filters every response, errors too.
Handlers receive a RestRequest and return (status, body), so the same
table serves HTTP and tests.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import unquote

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError, SearchEngineError,
)

logger = logging.getLogger("elasticsearch_tpu_torch.rest")


class RestRequest:
    def __init__(self, method: str, path: str, params: Dict[str, str],
                 query: Dict[str, str], body: bytes,
                 headers: Optional[Dict[str, str]] = None):
        self.method = method
        self.path = path
        self.params = params          # path template params
        self.query = query            # query-string args
        self.raw_body = body
        self.headers = headers or {}  # lower-cased header names

    def json(self) -> Any:
        if not self.raw_body:
            return None
        try:
            return json.loads(self.raw_body)
        except ValueError as e:
            raise ParsingError(f"failed to parse request body: {e}")

    def ndjson(self) -> List[Any]:
        """Newline-delimited JSON bodies (_bulk, _msearch)."""
        out = []
        for line in self.raw_body.split(b"\n"):
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError as e:
                    raise ParsingError(f"failed to parse bulk line: {e}")
        return out

    def param(self, name: str, default: Any = None) -> Any:
        if name in self.params:
            return self.params[name]
        return self.query.get(name, default)

    def bool_param(self, name: str, default: bool = False) -> bool:
        v = self.param(name)
        if v is None:
            return default
        return v in ("", "true", "1", True)

    def int_param(self, name: str,
                  default: Optional[int] = None) -> Optional[int]:
        v = self.param(name)
        if v is None or v == "":
            return default
        try:
            return int(v)
        except ValueError:
            raise IllegalArgumentError(
                f"Failed to parse int parameter [{name}] with value [{v}]")


Handler = Callable[[RestRequest], Tuple[int, Any]]


class _TrieNode:
    __slots__ = ("children", "param_child", "param_name", "handlers")

    def __init__(self):
        self.children: Dict[str, _TrieNode] = {}
        self.param_child: Optional[_TrieNode] = None
        self.param_name: Optional[str] = None
        self.handlers: Dict[str, Handler] = {}


class RestController:
    def __init__(self):
        self._root = _TrieNode()

    def register(self, method: str, template: str, handler: Handler) -> None:
        node = self._root
        for seg in [s for s in template.split("/") if s]:
            if seg.startswith("{") and seg.endswith("}"):
                if node.param_child is None:
                    node.param_child = _TrieNode()
                    node.param_name = seg[1:-1]
                node = node.param_child
            else:
                node = node.children.setdefault(seg, _TrieNode())
        node.handlers[method.upper()] = handler

    def _resolve(self, path: str) -> Tuple[Optional[_TrieNode],
                                            Dict[str, str]]:
        segments = [unquote(s) for s in path.split("/") if s]

        def walk(node: _TrieNode, i: int, params: Dict[str, str]):
            if i == len(segments):
                return (node if node.handlers else None), params
            child = node.children.get(segments[i])
            if child is not None:
                found, p = walk(child, i + 1, params)
                if found:
                    return found, p
            if node.param_child is not None:
                found, p = walk(node.param_child, i + 1,
                                {**params, node.param_name: segments[i]})
                if found:
                    return found, p
            return None, params

        return walk(self._root, 0, {})

    def dispatch(self, method: str, path: str, query: Dict[str, str],
                 body: bytes, headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, Any]:
        """Route one request; `headers` by lower-cased name (the REST
        layer reads `x-opaque-id`)."""
        method = method.upper()
        try:
            node, params = self._resolve(path)
            if node is None:
                raise IllegalArgumentError(
                    f"no handler found for uri [{path}] and method [{method}]")
            handler = node.handlers.get(method)
            if handler is None and method == "HEAD" and "GET" in node.handlers:
                status, _ = node.handlers["GET"](
                    RestRequest(method, path, params, query, body, headers))
                return status, None
            if handler is None:
                return 405, _error_body(
                    "method_not_allowed_exception",
                    f"Incorrect HTTP method for uri [{path}], allowed: "
                    f"[{', '.join(sorted(node.handlers))}]", 405)
            status, resp = handler(
                RestRequest(method, path, params, query, body, headers))
        except SearchEngineError as e:
            status, resp = e.status, {"error": e.to_wrapped_dict(),
                                      "status": e.status}
        except Exception as e:  # a boundary that must keep serving
            logger.exception("unhandled error serving %s %s", method, path)
            status, resp = 500, _error_body(
                "internal_server_error", f"{type(e).__name__}: {e}", 500,
                stack_trace=traceback.format_exc(limit=5))
        fp = query.get("filter_path")
        if fp and isinstance(resp, (dict, list)):
            resp = filter_path_apply(resp, str(fp))
        return status, resp


_SKIP = object()


def filter_path_apply(resp, spec: str):
    """Response filtering: comma-separated dotted patterns with `*` and
    `**` wildcards; a leading `-` excludes instead."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    includes = [p for p in parts if not p.startswith("-")]
    excludes = [p[1:] for p in parts if p.startswith("-")]

    def match_steps(steps, obj):
        """A copy of obj holding only the paths that match steps, or
        _SKIP."""
        if not steps:
            return obj
        step, rest = steps[0], steps[1:]
        if isinstance(obj, list):
            out = [r for r in (match_steps(steps, item) for item in obj)
                   if r is not _SKIP]
            return out if out else _SKIP
        if not isinstance(obj, dict):
            return _SKIP
        out = {}
        for k, v in obj.items():
            if step == "**":
                # `**` spans any number of segments: match the rest here,
                # or keep spanning below
                r = match_steps(rest, {k: v})
                if isinstance(r, dict):
                    out.update(r)
                    continue
                r = match_steps(steps, v)
                if r is not _SKIP:
                    out[k] = r
            elif fnmatch.fnmatchcase(str(k), step):
                r = match_steps(rest, v) if rest else v
                if r is not _SKIP:
                    out[k] = r
        return out if out else _SKIP

    def exclude_steps(steps, obj):
        """A copy of obj with the paths matching steps removed; _SKIP when
        obj itself is excluded."""
        if not steps:
            return _SKIP
        if isinstance(obj, list):
            return [r for r in (exclude_steps(steps, item) for item in obj)
                    if r is not _SKIP]
        if not isinstance(obj, dict):
            return obj
        step, rest = steps[0], steps[1:]
        out = {}
        for k, v in obj.items():
            if step == "**":
                keep = v
                if rest and fnmatch.fnmatchcase(str(k), rest[0]):
                    if len(rest) == 1:
                        continue    # an excluded leaf
                    keep = exclude_steps(rest[1:], keep)
                    if keep is _SKIP:
                        continue
                keep = exclude_steps(steps, keep)
                if keep is _SKIP:
                    continue
                out[k] = keep
            elif fnmatch.fnmatchcase(str(k), step):
                if not rest:
                    continue        # an excluded leaf
                keep = exclude_steps(rest, v)
                if keep is _SKIP:
                    continue
                out[k] = keep
            else:
                out[k] = v
        return out

    out = resp
    if includes:
        merged = _SKIP
        for p in includes:
            r = match_steps(p.split("."), resp)
            if r is _SKIP:
                continue
            merged = r if merged is _SKIP else _merge(merged, r)
        out = merged if merged is not _SKIP else (
            {} if isinstance(resp, dict) else [])
    for p in excludes:
        out = exclude_steps(p.split("."), out)
    return out


def _merge(a, b):
    """Two filtered copies of one response merged (lists element by
    element, so hits stay aligned across patterns)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge(out[k], v) if k in out else v
        return out
    if isinstance(a, list) and isinstance(b, list):
        return [_merge(a[i], b[i]) if i < len(a) and i < len(b)
                else (a[i] if i < len(a) else b[i])
                for i in range(max(len(a), len(b)))]
    return a


def _error_body(err_type: str, reason: str, status: int, **extra) -> dict:
    err = {"type": err_type, "reason": reason, **extra}
    return {"error": {**err, "root_cause": [err]}, "status": status}
