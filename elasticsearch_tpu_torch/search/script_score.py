"""`script_score` and the scripts of a search (port of
`elasticsearch_tpu/search/script_score.py`).

A script is an expression or a Painless program. An expression (anything
Python's `ast` parses in eval mode) runs batched over every candidate of
the inner query with numpy, through a restricted evaluator: arithmetic,
comparisons, `doc['field'].value` / `.empty` / `.size()`, `params.x` /
`params['x']`, `_score`, `Math.*`, and the vector functions
`cosineSimilarity`, `dotProduct`, `l1norm`, `l2norm` (the reference's
`ScoreScriptUtils`) with `saturation` and `sigmoid`. Any other source
compiles to the sandboxed Painless interpreter (`script/painless.py`) and
runs per document, each vector function computed once for the candidate
batch and read per document.

`doc['field'].value` is built vectorised from the doc-values columns: a
multi-valued doc's first value, a boolean as 1.0 or 0.0, a missing value
0, and a field holding strings as an object array of them ("" when
missing), as the reference reads them row by row. The vector functions
compute in f32 over the segments' f32 host rows (`seg.vectors`), and a
script's values run in f64 and are cast to f32, as in the reference.

Security: only allowlisted AST node types and names resolve; no attribute
access outside `doc`, `params`, `Math` and `_score`, no calls outside the
function allowlist.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Dict, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.script.painless import (
    FrozenParams, compile_painless, execute,
)
from elasticsearch_tpu_torch.script.service import resolve_stored
from elasticsearch_tpu_torch.search.queries import (
    DocSet, Query, SearchContext,
)

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Compare, ast.BoolOp,
    ast.IfExp, ast.Call, ast.Name, ast.Attribute, ast.Subscript,
    ast.Constant, ast.Load, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod,
    ast.Pow, ast.FloorDiv, ast.USub, ast.UAdd, ast.Not, ast.Eq, ast.NotEq,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.And, ast.Or,
)

_MATH = {
    "log": np.log, "log10": np.log10, "log1p": np.log1p, "exp": np.exp,
    "sqrt": np.sqrt, "abs": np.abs, "pow": np.power, "min": np.minimum,
    "max": np.maximum, "floor": np.floor, "ceil": np.ceil, "E": math.e,
    "PI": math.pi,
}

_BINOPS = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
           ast.Div: np.divide, ast.Mod: np.mod, ast.Pow: np.power,
           ast.FloorDiv: np.floor_divide}
_COMPARES = {ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less,
             ast.LtE: np.less_equal, ast.Gt: np.greater,
             ast.GtE: np.greater_equal}


class _DocFieldValues:
    """`doc['field']` over the candidate batch: .value, .empty, .size()."""

    def __init__(self, values: np.ndarray, present: np.ndarray):
        self._values = values
        self._present = present

    @property
    def value(self):
        return self._values

    @property
    def empty(self):
        return ~self._present

    def size(self):
        return self._present.astype(np.int64)


def doc_values_batch(ctx: SearchContext, rows: np.ndarray,
                     field: str) -> _DocFieldValues:
    """`doc[field]` over rows, read from the doc-values columns segment by
    segment: a numeric column is gathered directly (its first value of a
    multi-valued doc); another column value by value, a boolean as 1.0 or
    0.0, and any other value kept as its string. When some row holds a
    string, the values are an object array of strings ("" where a row has
    none or holds a number), as the reference gives them."""
    rows = np.asarray(rows, dtype=np.int64)
    vals = np.zeros(len(rows), dtype=np.float64)
    present = np.zeros(len(rows), dtype=bool)
    strs: Optional[np.ndarray] = None
    if len(rows):
        vi, local = ctx.reader.locate_many(rows)
        for v in np.unique(vi):
            col = ctx.reader.views[v].segment.doc_values.get(field)
            if col is None:
                continue
            at = np.nonzero(vi == v)[0]
            loc = local[at]
            if col.numeric is not None:
                ok = col.present[loc]
                vals[at[ok]] = col.numeric[loc[ok]]
                present[at] = ok
                continue
            for i, x in zip(at.tolist(), col.values[loc].tolist()):
                if isinstance(x, list):
                    x = x[0] if x else None
                if x is None:
                    continue
                if isinstance(x, bool):
                    vals[i] = 1.0 if x else 0.0
                elif isinstance(x, (int, float)):
                    vals[i] = float(x)
                else:
                    if strs is None:
                        strs = np.full(len(rows), "", dtype=object)
                    strs[i] = str(x)
                present[i] = True
    return _DocFieldValues(strs if strs is not None else vals, present)


class _DocAccessor:
    def __init__(self, ctx: SearchContext, rows: np.ndarray):
        self._ctx = ctx
        self._rows = rows
        self._cache: Dict[str, _DocFieldValues] = {}

    def __getitem__(self, field: str) -> _DocFieldValues:
        if field not in self._cache:
            self._cache[field] = doc_values_batch(self._ctx, self._rows,
                                                  field)
        return self._cache[field]


def _gather_vectors(ctx: SearchContext, rows: np.ndarray,
                    field: str) -> np.ndarray:
    """The f32 host rows of `field` at the given rows (zeros where a doc
    has no vector), segment by segment; rows that all lie in one segment
    are one `take` of its block."""
    out = None
    for view in ctx.reader.views:
        seg = view.segment
        if field not in seg.vectors:
            continue
        mat, _present = seg.vectors[field]
        in_seg = (rows >= seg.base) & (rows < seg.base + seg.num_docs)
        if out is None and in_seg.all():
            return np.take(mat, rows - seg.base, axis=0)
        if out is None:
            out = np.zeros((len(rows), mat.shape[1]), dtype=np.float32)
        out[in_seg] = mat[rows[in_seg] - seg.base]
    if out is None:
        mapper = ctx.mapper_service.get(field)
        dims = getattr(mapper, "dims", None) or 1
        out = np.zeros((len(rows), dims), dtype=np.float32)
    return out


class _Evaluator:
    def __init__(self, ctx: SearchContext, rows: np.ndarray,
                 params: Dict[str, Any], base_scores: np.ndarray):
        self.ctx = ctx
        self.rows = rows
        self.params = params
        self.doc = _DocAccessor(ctx, rows)
        self.base_scores = base_scores

    # -- the vector functions -------------------------------------------------
    @staticmethod
    def _qvec(v) -> np.ndarray:
        return np.asarray(v, dtype=np.float32)

    def cosine_similarity(self, query_vector, field: str) -> np.ndarray:
        q = self._qvec(query_vector)
        mat = _gather_vectors(self.ctx, self.rows, field)
        qn = np.linalg.norm(q) or 1e-30
        # each row's norm without an [n, d] temporary
        mn = np.maximum(np.sqrt(np.einsum("ij,ij->i", mat, mat)), 1e-30)
        return (mat @ q) / (qn * mn)

    def dot_product(self, query_vector, field: str) -> np.ndarray:
        return _gather_vectors(self.ctx, self.rows, field) \
            @ self._qvec(query_vector)

    def l1norm(self, query_vector, field: str) -> np.ndarray:
        mat = _gather_vectors(self.ctx, self.rows, field)
        return np.abs(mat - self._qvec(query_vector)[None, :]).sum(axis=1)

    def l2norm(self, query_vector, field: str) -> np.ndarray:
        mat = _gather_vectors(self.ctx, self.rows, field)
        return np.sqrt(((mat - self._qvec(query_vector)[None, :]) ** 2)
                       .sum(axis=1))

    FUNCTIONS = {
        "cosineSimilarity": "cosine_similarity",
        "dotProduct": "dot_product",
        "l1norm": "l1norm",
        "l2norm": "l2norm",
    }

    # -- the walk -------------------------------------------------------------
    def eval(self, node) -> Any:
        if not isinstance(node, _ALLOWED_NODES):
            raise IllegalArgumentError(
                f"script construct [{type(node).__name__}] is not allowed")
        if isinstance(node, ast.Expression):
            return self.eval(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, str, bool)):
                return node.value
            raise IllegalArgumentError("unsupported constant in script")
        if isinstance(node, ast.Name):
            if node.id == "doc":
                return self.doc
            if node.id == "params":
                return self.params
            if node.id == "Math":
                return _MATH
            if node.id == "_score":
                return self.base_scores
            raise IllegalArgumentError(f"unknown variable [{node.id}]")
        if isinstance(node, ast.Attribute):
            base = self.eval(node.value)
            if isinstance(base, dict):
                if node.attr in base:
                    return base[node.attr]
                raise IllegalArgumentError(
                    f"unknown attribute [{node.attr}]")
            if isinstance(base, _DocFieldValues) \
                    and node.attr in ("value", "empty"):
                return getattr(base, node.attr)
            raise IllegalArgumentError(
                f"attribute access [{node.attr}] not allowed")
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            key = self.eval(node.slice)
            if isinstance(base, (_DocAccessor, dict)):
                return base[key]
            raise IllegalArgumentError("subscript not allowed here")
        if isinstance(node, ast.BinOp):
            left, right = self.eval(node.left), self.eval(node.right)
            return _BINOPS[type(node.op)](left, right)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            if isinstance(node.op, ast.USub):
                return np.negative(v)
            if isinstance(node.op, ast.Not):
                return np.logical_not(v)
            return v
        if isinstance(node, ast.Compare):
            left = self.eval(node.left)
            result = None
            for op, comp in zip(node.ops, node.comparators):
                right = self.eval(comp)
                r = _COMPARES[type(op)](left, right)
                result = r if result is None else np.logical_and(result, r)
                left = right
            return result
        if isinstance(node, ast.BoolOp):
            vals = [self.eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = (np.logical_and(out, v) if isinstance(node.op, ast.And)
                       else np.logical_or(out, v))
            return out
        if isinstance(node, ast.IfExp):
            cond = self.eval(node.test)
            return np.where(cond, self.eval(node.body),
                            self.eval(node.orelse))
        if isinstance(node, ast.Call):
            return self._call(node)
        raise IllegalArgumentError(
            f"unsupported script node [{type(node).__name__}]")

    def _call(self, node: ast.Call) -> Any:
        args = [self.eval(a) for a in node.args]
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name in self.FUNCTIONS:
                if len(args) != 2:
                    raise IllegalArgumentError(
                        f"[{name}] takes (query_vector, field)")
                return getattr(self, self.FUNCTIONS[name])(args[0], args[1])
            if name == "saturation":
                return args[0] / (args[0] + args[1])
            if name == "sigmoid":
                v, k, a = args
                return v ** a / (k ** a + v ** a)
            raise IllegalArgumentError(f"unknown function [{name}]")
        if isinstance(node.func, ast.Attribute):
            base = node.func.value
            if isinstance(base, ast.Name) and base.id == "Math":
                fn = _MATH.get(node.func.attr)
                if callable(fn):
                    return fn(*args)
                raise IllegalArgumentError(
                    f"unknown Math function [{node.func.attr}]")
            obj = self.eval(base)
            if isinstance(obj, _DocFieldValues) and node.func.attr == "size":
                return obj.size()
            raise IllegalArgumentError("method calls not allowed in scripts")
        raise IllegalArgumentError("unsupported call in script")


class Script:
    """A compiled script: its source and params (a stored script's by id).
    An expression keeps its `ast` tree (`tree`) and runs batched; a
    statement program (`program`) runs per document through Painless."""

    def __init__(self, spec: Any):
        if isinstance(spec, str):
            spec = {"source": spec}
        spec = resolve_stored(spec, "usable in this context")
        if not isinstance(spec, dict) or "source" not in spec:
            raise ParsingError("script must define [source]")
        self.source = spec["source"]
        self.params = spec.get("params", {})
        self.tree = None
        self.program = None
        try:
            self.tree = ast.parse(self.source, mode="eval")
        except SyntaxError:
            try:
                self.program = compile_painless(self.source)
            except ParsingError as e:
                raise ParsingError(
                    f"compile error in script [{self.source}]: {e}")

    def evaluate(self, ctx: SearchContext, rows: np.ndarray,
                 base_scores: np.ndarray) -> np.ndarray:
        if self.tree is not None:
            # one batched evaluation; a script's own errors are 400s
            out = _Evaluator(ctx, rows, self.params, base_scores).eval(
                self.tree)
            return np.broadcast_to(np.asarray(out, dtype=np.float64),
                                   (len(rows),)).astype(np.float32)
        return self._evaluate_painless(ctx, rows, base_scores)

    def _evaluate_painless(self, ctx: SearchContext, rows: np.ndarray,
                           base_scores: np.ndarray) -> np.ndarray:
        out = np.zeros(len(rows), dtype=np.float32)
        batch_ev = _Evaluator(ctx, rows, self.params, base_scores)
        cur = {"i": 0}
        # each vector function once for the whole batch, read per document
        kernel_cache: Dict[tuple, np.ndarray] = {}

        def batched(kernel_name):
            fn = getattr(batch_ev, kernel_name)

            def call(q, field):
                key = (kernel_name, field, tuple(np.ravel(q)))
                if key not in kernel_cache:
                    kernel_cache[key] = fn(q, field)
                return float(kernel_cache[key][cur["i"]])
            return call

        bindings = {
            "doc": None, "params": FrozenParams(self.params), "_score": 0.0,
            "cosineSimilarity": batched("cosine_similarity"),
            "dotProduct": batched("dot_product"),
            "l1norm": batched("l1norm"),
            "l2norm": batched("l2norm"),
            "saturation": lambda v, k: v / (v + k),
            "sigmoid": lambda v, k, a: v ** a / (k ** a + v ** a),
        }
        for i, row in enumerate(rows):
            cur["i"] = i
            bindings["doc"] = _ScalarDoc(ctx, int(row))
            bindings["_score"] = float(base_scores[i])
            value = execute(self.program, bindings)
            try:
                out[i] = float(value) if value is not None else 0.0
            except (TypeError, ValueError):
                raise IllegalArgumentError(
                    f"script_score script returned a non-numeric value "
                    f"[{value!r}]")
        return out


class _ScalarDocField:
    """`doc['field']` of one document in the per-document interpreter."""

    _painless_fields = ("value", "empty", "values", "length")

    def __init__(self, raw):
        if raw is None:
            self._values = []
        elif isinstance(raw, list):
            self._values = raw
        else:
            self._values = [raw]

    @property
    def value(self):
        if not self._values:
            raise IllegalArgumentError(
                "A document doesn't have a value for a field! "
                "Use doc[<field>].size()==0 to check if a document is "
                "missing a field!")
        return self._values[0]

    @property
    def values(self):
        return list(self._values)

    @property
    def empty(self):
        return not self._values

    @property
    def length(self):
        return len(self._values)

    def _painless_methods(self):
        return {"size": lambda: len(self._values),
                "isEmpty": lambda: not self._values,
                "get": lambda i: self._values[int(i)],
                "contains": lambda x: x in self._values}


class _ScalarDoc:
    def __init__(self, ctx: SearchContext, row: int):
        self._ctx = ctx
        self._row = row

    def __getitem__(self, field: str) -> _ScalarDocField:
        return _ScalarDocField(self._ctx.reader.get_doc_value(field,
                                                              self._row))

    def _painless_methods(self):
        return {"containsKey": lambda f:
                self._ctx.reader.get_doc_value(f, self._row) is not None}


class ScriptScoreQuery(Query):
    """`script_score`: the inner query's candidates scored by the script,
    batched."""

    def __init__(self, query: Query, script_spec: Any):
        self.query = query
        self.script = Script(script_spec)

    def execute(self, ctx: SearchContext) -> DocSet:
        base = self.query.execute(ctx).with_scores()
        if len(base.rows) == 0:
            return base
        return DocSet(base.rows, self.script.evaluate(ctx, base.rows,
                                                      base.scores))

    def to_dict(self):
        return {"script_score": {"query": self.query.to_dict(),
                                 "script": {"source": self.script.source,
                                            "params": self.script.params}}}

    def key_is_exact(self) -> bool:
        return self.query.key_is_exact()
