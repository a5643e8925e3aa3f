"""A sandboxed Painless interpreter (port of
`elasticsearch_tpu/script/painless.py`, with the same names): lexer →
recursive-descent parser → tree-walking evaluator.

The reference compiles Painless (Java-like syntax) through an ANTLR grammar
to JVM bytecode with an allowlisted class/method surface
(`modules/lang-painless`, 34.8k LoC: `Compiler.java`, `ir/`, `api/`
whitelists). This re-design keeps the language surface and the sandbox
discipline but interprets the AST directly — scripts here steer control
flow around the engine, they are never the hot loop (the vector functions
run once a candidate batch; `search/script_score.py` keeps a vectorized
fast path for pure expressions).

Supported: statements (decl/assign with compound ops, if/else, for,
for-each, while, do-while, return, break, continue), user-defined
functions, ternary and elvis operators, list/map literals, `new ArrayList/
HashMap`, method calls from a fixed allowlist over str/list/map values,
`Math.*`/`Integer.parseInt`-style statics, and the script contexts' bound
variables (`params`, `doc`, `_score`, `ctx`).

Sandbox: unknown names/methods/constructors raise; loops carry an
iteration budget and calls a depth budget (the reference's loop counter
and stack guards, `LoopNode`/`FunctionNode` limits).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)

MAX_LOOP_ITERATIONS = 1_000_000
MAX_CALL_DEPTH = 64


class PainlessError(ParsingError):
    pass


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?[fFdD]?|\.\d+(?:[eE][+-]?\d+)?[fFdD]?|\d+[lLfFdD]?)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\?\.|\?:|==|!=|<=|>=|&&|\|\||\+\+|--|\+=|-=|\*=|/=|%=|=|[-+*/%<>!?:;,.(){}\[\]])
""", re.VERBOSE | re.DOTALL)

_KEYWORDS = {"if", "else", "for", "while", "do", "return", "break",
             "continue", "def", "in", "new", "null", "true", "false",
             "instanceof", "void", "try", "catch", "throw"}

_TYPE_WORDS = {"def", "int", "long", "float", "double", "boolean", "byte",
               "short", "char", "String", "Map", "HashMap", "List",
               "ArrayList", "Object", "void"}


def tokenize(src: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise PainlessError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        out.append((m.lastgroup, m.group()))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# AST: tuples ("kind", ...)
# ---------------------------------------------------------------------------

class Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> Tuple[str, str]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tuple[str, str]:
        if self.i >= len(self.toks) - 1:
            raise PainlessError("unexpected end of script")
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, value: str) -> bool:
        if self.peek()[1] == value and self.peek()[0] != "str":
            self.i += 1
            return True
        return False

    def expect(self, value: str) -> None:
        if not self.accept(value):
            raise PainlessError(
                f"expected {value!r} but found {self.peek()[1]!r}")

    # ------------------------------------------------------------- program
    def parse_program(self):
        functions = {}
        stmts = []
        while self.peek()[0] != "eof":
            fn = self._try_function()
            if fn is not None:
                functions[fn[0]] = fn
            else:
                stmts.append(self.statement())
        return ("program", functions, stmts)

    def _try_function(self):
        """`type name(type a, type b) { ... }` at top level."""
        save = self.i
        kind, val = self.peek()
        if kind == "id" and (val in _TYPE_WORDS) and self.peek(1)[0] == "id" \
                and self.peek(2)[1] == "(":
            self.next()
            name = self.next()[1]
            self.expect("(")
            params = []
            while not self.accept(")"):
                ptype = self.next()  # type word
                if self.peek()[0] == "id":
                    params.append(self.next()[1])
                else:  # untyped param: the "type" was the name
                    params.append(ptype[1])
                self.accept(",")
            if self.peek()[1] != "{":
                self.i = save
                return None
            body = self.block()
            return (name, params, body)
        return None

    # ----------------------------------------------------------- statements
    def block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.statement())
        return ("block", stmts)

    def statement(self):
        kind, val = self.peek()
        if val == "{":
            return self.block()
        if val == ";":
            self.next()
            return ("block", [])
        if val == "if":
            self.next()
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            then = self.statement()
            otherwise = None
            if self.accept("else"):
                otherwise = self.statement()
            return ("if", cond, then, otherwise)
        if val == "while":
            self.next()
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            return ("while", cond, self.statement())
        if val == "do":
            self.next()
            body = self.statement()
            self.expect("while")
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            self.accept(";")
            return ("dowhile", cond, body)
        if val == "for":
            return self._for()
        if val == "return":
            self.next()
            if self.peek()[1] == ";":
                self.next()
                return ("return", None)
            e = self.expression()
            self.accept(";")
            return ("return", e)
        if val == "break":
            self.next()
            self.accept(";")
            return ("break",)
        if val == "continue":
            self.next()
            self.accept(";")
            return ("continue",)
        if val == "throw":
            self.next()
            e = self.expression()
            self.accept(";")
            return ("throw", e)
        decl = self._try_declaration()
        if decl is not None:
            self.accept(";")
            return decl
        e = self.expression()
        self.accept(";")
        return ("expr", e)

    def _try_declaration(self):
        kind, val = self.peek()
        if kind == "id" and val in _TYPE_WORDS and \
                (self.peek(1)[0] == "id" or self.peek(1)[1] == "<"):
            save = self.i
            self.next()
            # generic parameters of the type are not modelled: skip <...>
            if self.peek()[1] == "<":
                depth = 0
                while True:
                    t = self.next()[1]
                    depth += t.count("<") - t.count(">")
                    if depth <= 0:
                        break
            if self.peek()[0] != "id":
                self.i = save
                return None
            entries = []
            while True:
                name = self.next()[1]
                init = None
                if self.accept("="):
                    init = self.expression()
                entries.append((name, init))
                if not self.accept(","):
                    break
            return ("decl", entries)
        return None

    def _for(self):
        self.next()  # for
        self.expect("(")
        # for-each: `for (def x : expr)` / `for (x in expr)`
        save = self.i
        kind, val = self.peek()
        if kind == "id":
            if val in _TYPE_WORDS and self.peek(1)[0] == "id" \
                    and self.peek(2)[1] in (":", "in"):
                self.next()
                var = self.next()[1]
                self.next()  # ':' or 'in'
                it = self.expression()
                self.expect(")")
                return ("foreach", var, it, self.statement())
            if self.peek(1)[1] in (":", "in"):
                var = self.next()[1]
                self.next()
                it = self.expression()
                self.expect(")")
                return ("foreach", var, it, self.statement())
        self.i = save
        init = None
        if not self.accept(";"):
            init = self._try_declaration()
            if init is None:
                init = ("expr", self.expression())
            self.expect(";")
        cond = None
        if not self.accept(";"):
            cond = self.expression()
            self.expect(";")
        step = None
        if self.peek()[1] != ")":
            step = ("expr", self.expression())
        self.expect(")")
        return ("for", init, cond, step, self.statement())

    # ---------------------------------------------------------- expressions
    def expression(self):
        return self.assignment()

    def assignment(self):
        target = self.ternary()
        for op in ("=", "+=", "-=", "*=", "/=", "%="):
            if self.accept(op):
                value = self.assignment()
                return ("assign", op, target, value)
        return target

    def ternary(self):
        cond = self.elvis()
        if self.accept("?"):
            then = self.expression()
            self.expect(":")
            other = self.expression()
            return ("ternary", cond, then, other)
        return cond

    def elvis(self):
        left = self.logic_or()
        while self.accept("?:"):
            right = self.logic_or()
            left = ("elvis", left, right)
        return left

    def logic_or(self):
        left = self.logic_and()
        while self.accept("||"):
            left = ("or", left, self.logic_and())
        return left

    def logic_and(self):
        left = self.equality()
        while self.accept("&&"):
            left = ("and", left, self.equality())
        return left

    def equality(self):
        left = self.relational()
        while self.peek()[1] in ("==", "!=") and self.peek()[0] == "op":
            op = self.next()[1]
            left = ("binop", op, left, self.relational())
        return left

    def relational(self):
        left = self.additive()
        while True:
            if self.peek()[0] == "op" and self.peek()[1] in ("<", "<=", ">", ">="):
                op = self.next()[1]
                left = ("binop", op, left, self.additive())
            elif self.peek()[1] == "instanceof":
                self.next()
                tname = self.next()[1]
                left = ("instanceof", left, tname)
            else:
                return left

    def additive(self):
        left = self.multiplicative()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            left = ("binop", op, left, self.multiplicative())
        return left

    def multiplicative(self):
        left = self.unary()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            left = ("binop", op, left, self.unary())
        return left

    def unary(self):
        kind, val = self.peek()
        if kind == "op" and val in ("-", "+", "!"):
            self.next()
            return ("unary", val, self.unary())
        if kind == "op" and val in ("++", "--"):
            self.next()
            target = self.unary()
            return ("preincr", val, target)
        # cast: (int) expr — a parenthesized single type word
        if val == "(" and self.peek(1)[0] == "id" \
                and self.peek(1)[1] in _TYPE_WORDS and self.peek(2)[1] == ")":
            self.next(); tname = self.next()[1]; self.next()
            return ("cast", tname, self.unary())
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            if self.accept("."):
                name = self.next()[1]
                if self.accept("("):
                    args = []
                    while not self.accept(")"):
                        args.append(self.expression())
                        self.accept(",")
                    node = ("method", node, name, args)
                else:
                    node = ("field", node, name)
            elif self.accept("["):
                idx = self.expression()
                self.expect("]")
                node = ("index", node, idx)
            elif self.peek()[0] == "op" and self.peek()[1] in ("++", "--"):
                op = self.next()[1]
                node = ("postincr", op, node)
            else:
                return node

    def primary(self):
        kind, val = self.next()
        if kind == "num":
            text = val.rstrip("lLfFdD")
            return ("const", float(text) if ("." in text or "e" in text
                                             or "E" in text) else int(text))
        if kind == "str":
            # single-pass escape decode: chained str.replace would re-consume
            # the backslash an earlier replacement produced
            escapes = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                       "'": "'", '"': '"'}
            return ("const", re.sub(
                r"\\(.)", lambda m: escapes.get(m.group(1), m.group(0)),
                val[1:-1]))
        if val == "null":
            return ("const", None)
        if val == "true":
            return ("const", True)
        if val == "false":
            return ("const", False)
        if val == "new":
            tname = self.next()[1]
            if self.peek()[1] == "<":
                depth = 0
                while True:
                    t = self.next()[1]
                    depth += t.count("<") - t.count(">")
                    if depth <= 0:
                        break
            self.expect("(")
            args = []
            while not self.accept(")"):
                args.append(self.expression())
                self.accept(",")
            return ("new", tname, args)
        if val == "(":
            e = self.expression()
            self.expect(")")
            return e
        if val == "[":
            # list [a, b] / map [k: v, ...] / empty map [:]
            if self.accept(":"):
                self.expect("]")
                return ("maplit", [])
            if self.accept("]"):
                return ("listlit", [])
            first = self.expression()
            if self.accept(":"):
                pairs = [(first, self.expression())]
                while self.accept(","):
                    k = self.expression()
                    self.expect(":")
                    pairs.append((k, self.expression()))
                self.expect("]")
                return ("maplit", pairs)
            items = [first]
            while self.accept(","):
                items.append(self.expression())
            self.expect("]")
            return ("listlit", items)
        if kind == "id":
            if self.peek()[1] == "(" and self.peek()[0] == "op":
                self.next()
                args = []
                while not self.accept(")"):
                    args.append(self.expression())
                    self.accept(",")
                return ("call", val, args)
            return ("name", val)
        raise PainlessError(f"unexpected token {val!r}")


# ---------------------------------------------------------------------------
# interpreter
# ---------------------------------------------------------------------------

class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _UserThrow(IllegalArgumentError):
    pass


_MATH_STATICS: Dict[str, Any] = {
    "abs": abs, "max": max, "min": min, "pow": math.pow, "sqrt": math.sqrt,
    "log": math.log, "log10": math.log10, "exp": math.exp,
    "floor": math.floor, "ceil": math.ceil, "round": round,
    "E": math.e, "PI": math.pi,
}

_STATIC_CALLS: Dict[Tuple[str, str], Callable] = {
    ("Integer", "parseInt"): lambda s: int(str(s)),
    ("Long", "parseLong"): lambda s: int(str(s)),
    ("Double", "parseDouble"): lambda s: float(str(s)),
    ("Float", "parseFloat"): lambda s: float(str(s)),
    ("Boolean", "parseBoolean"): lambda s: str(s).lower() == "true",
    ("String", "valueOf"): lambda v: _to_string(v),
    ("Integer", "toString"): lambda v: _to_string(v),
    ("Math", "abs"): abs, ("Math", "max"): max, ("Math", "min"): min,
    ("Math", "pow"): math.pow, ("Math", "sqrt"): math.sqrt,
    ("Math", "log"): math.log, ("Math", "log10"): math.log10,
    ("Math", "exp"): math.exp, ("Math", "floor"): math.floor,
    ("Math", "ceil"): math.ceil, ("Math", "round"): round,
}


def _to_string(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(v)
    return str(v)


def _str_methods(s: str) -> Dict[str, Callable]:
    return {
        "length": lambda: len(s),
        "substring": lambda a, b=None: s[int(a):] if b is None else s[int(a):int(b)],
        "contains": lambda x: str(x) in s,
        "startsWith": lambda x: s.startswith(str(x)),
        "endsWith": lambda x: s.endswith(str(x)),
        "indexOf": lambda x, frm=0: s.find(str(x), int(frm)),
        "lastIndexOf": lambda x: s.rfind(str(x)),
        "toLowerCase": lambda: s.lower(),
        "toUpperCase": lambda: s.upper(),
        "trim": lambda: s.strip(),
        "replace": lambda a, b: s.replace(str(a), str(b)),
        "split": lambda sep: list(re.split(sep, s)),
        "equals": lambda x: s == x,
        "equalsIgnoreCase": lambda x: s.lower() == str(x).lower(),
        "charAt": lambda i: s[int(i)],
        "isEmpty": lambda: len(s) == 0,
        "compareTo": lambda x: (s > str(x)) - (s < str(x)),
        "hashCode": lambda: hash(s),
        "toString": lambda: s,
    }


def _list_methods(lst: list) -> Dict[str, Callable]:
    return {
        "add": lambda *a: (lst.insert(int(a[0]), a[1]) if len(a) == 2
                           else lst.append(a[0])) or True,
        "get": lambda i: lst[int(i)],
        "set": lambda i, v: lst.__setitem__(int(i), v),
        "size": lambda: len(lst),
        "isEmpty": lambda: len(lst) == 0,
        "contains": lambda x: x in lst,
        "indexOf": lambda x: lst.index(x) if x in lst else -1,
        "remove": lambda i: lst.pop(int(i)),
        "clear": lambda: lst.clear(),
        "addAll": lambda other: lst.extend(other) or True,
        "sort": lambda *a: lst.sort(),
        "toString": lambda: _to_string(lst),
        "hashCode": lambda: 0,
    }


class FrozenParams(dict):
    """Script `params` are read-only in the reference (mutation throws an
    UnsupportedOperationException); a mutable params dict shared across
    per-document executions would leak state between documents."""


def _map_methods(mp: dict) -> Dict[str, Callable]:
    if isinstance(mp, FrozenParams):
        return {
            "get": lambda k: mp.get(k),
            "getOrDefault": lambda k, d: mp.get(k, d),
            "containsKey": lambda k: k in mp,
            "containsValue": lambda v: v in mp.values(),
            "size": lambda: len(mp),
            "isEmpty": lambda: len(mp) == 0,
            "keySet": lambda: list(mp.keys()),
            "values": lambda: list(mp.values()),
            "entrySet": lambda: [{"key": k, "value": v}
                                 for k, v in mp.items()],
            "toString": lambda: _to_string(mp),
        }
    return {
        "put": lambda k, v: mp.__setitem__(k, v),
        "get": lambda k: mp.get(k),
        "getOrDefault": lambda k, d: mp.get(k, d),
        "containsKey": lambda k: k in mp,
        "containsValue": lambda v: v in mp.values(),
        "remove": lambda k: mp.pop(k, None),
        "size": lambda: len(mp),
        "isEmpty": lambda: len(mp) == 0,
        "keySet": lambda: list(mp.keys()),
        "values": lambda: list(mp.values()),
        "entrySet": lambda: [{"key": k, "value": v} for k, v in mp.items()],
        "clear": lambda: mp.clear(),
        "putAll": lambda other: mp.update(other),
        "toString": lambda: _to_string(mp),
    }


class Interpreter:
    """Executes a parsed program with the given bound variables."""

    def __init__(self, program, bindings: Dict[str, Any]):
        _, self.functions, self.stmts = program
        self.globals = dict(bindings)
        self.loop_budget = MAX_LOOP_ITERATIONS
        self.depth = 0

    # ------------------------------------------------------------------ run
    def run(self) -> Any:
        """Execute top-level statements; like the reference compiler, a
        trailing expression statement is the script's implicit return."""
        scope = [self.globals]
        last = None
        try:
            for stmt in self.stmts:
                if stmt[0] == "expr":
                    last = self.eval(stmt[1], scope)
                else:
                    last = None
                    self.exec_stmt(stmt, scope)
        except _Return as r:
            return r.value
        return last

    # ------------------------------------------------------------ statements
    def exec_stmt(self, node, scope) -> None:
        kind = node[0]
        if kind == "block":
            inner = scope + [{}]
            for s in node[1]:
                self.exec_stmt(s, inner)
        elif kind == "decl":
            for name, init in node[1]:
                scope[-1][name] = self.eval(init, scope) if init is not None else None
        elif kind == "expr":
            self.eval(node[1], scope)
        elif kind == "if":
            if self._truthy(self.eval(node[1], scope)):
                self.exec_stmt(node[2], scope)
            elif node[3] is not None:
                self.exec_stmt(node[3], scope)
        elif kind == "while":
            while self._truthy(self.eval(node[1], scope)):
                self._tick()
                try:
                    self.exec_stmt(node[2], scope)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "dowhile":
            while True:
                self._tick()
                try:
                    self.exec_stmt(node[2], scope)
                except _Break:
                    break
                except _Continue:
                    pass
                if not self._truthy(self.eval(node[1], scope)):
                    break
        elif kind == "for":
            _, init, cond, step, body = node
            inner = scope + [{}]
            if init is not None:
                self.exec_stmt(init, inner)
            while cond is None or self._truthy(self.eval(cond, inner)):
                self._tick()
                try:
                    self.exec_stmt(body, inner)
                except _Break:
                    break
                except _Continue:
                    pass
                if step is not None:
                    self.exec_stmt(step, inner)
        elif kind == "foreach":
            _, var, it_expr, body = node
            seq = self.eval(it_expr, scope)
            if isinstance(seq, dict):
                seq = list(seq.keys())
            inner = scope + [{}]
            for item in list(seq or []):
                self._tick()
                inner[-1][var] = item
                try:
                    self.exec_stmt(body, inner)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "return":
            raise _Return(self.eval(node[1], scope) if node[1] is not None else None)
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        elif kind == "throw":
            raise _UserThrow(_to_string(self.eval(node[1], scope)))
        else:
            raise PainlessError(f"unknown statement [{kind}]")

    def _tick(self) -> None:
        self.loop_budget -= 1
        if self.loop_budget <= 0:
            raise IllegalArgumentError(
                "script exceeded the allowed loop iteration budget "
                f"[{MAX_LOOP_ITERATIONS}] (possible infinite loop)")

    # ----------------------------------------------------------- expressions
    def eval(self, node, scope) -> Any:
        kind = node[0]
        if kind == "const":
            return node[1]
        if kind == "name":
            for frame in reversed(scope):
                if node[1] in frame:
                    return frame[node[1]]
            if node[1] == "Math":
                return dict(_MATH_STATICS)  # Math.PI / Math.E field reads
            raise IllegalArgumentError(f"unknown variable [{node[1]}]")
        if kind == "listlit":
            return [self.eval(e, scope) for e in node[1]]
        if kind == "maplit":
            return {self.eval(k, scope): self.eval(v, scope)
                    for k, v in node[1]}
        if kind == "new":
            tname = node[1]
            if tname in ("ArrayList", "List"):
                return list(self.eval(node[2][0], scope)) if node[2] else []
            if tname in ("HashMap", "Map"):
                return dict(self.eval(node[2][0], scope)) if node[2] else {}
            if tname == "StringBuilder":
                return []
            raise IllegalArgumentError(f"constructor [{tname}] is not allowed")
        if kind == "ternary":
            return self.eval(node[2], scope) if self._truthy(self.eval(node[1], scope)) \
                else self.eval(node[3], scope)
        if kind == "elvis":
            left = self.eval(node[1], scope)
            return left if left is not None else self.eval(node[2], scope)
        if kind == "or":
            return self._truthy(self.eval(node[1], scope)) or \
                self._truthy(self.eval(node[2], scope))
        if kind == "and":
            return self._truthy(self.eval(node[1], scope)) and \
                self._truthy(self.eval(node[2], scope))
        if kind == "binop":
            return self._binop(node[1], self.eval(node[2], scope),
                               self.eval(node[3], scope))
        if kind == "instanceof":
            value = self.eval(node[1], scope)
            checks = {"String": str, "List": list, "ArrayList": list,
                      "Map": dict, "HashMap": dict, "Integer": int,
                      "Long": int, "Double": float, "Float": float,
                      "Boolean": bool}
            t = checks.get(node[2])
            return isinstance(value, t) if t else False
        if kind == "unary":
            v = self.eval(node[2], scope)
            if node[1] == "-":
                return -v
            if node[1] == "+":
                return v
            return not self._truthy(v)
        if kind == "cast":
            v = self.eval(node[2], scope)
            if node[1] in ("int", "long", "short", "byte"):
                return int(v)
            if node[1] in ("double", "float"):
                return float(v)
            if node[1] == "String":
                return _to_string(v)
            if node[1] == "boolean":
                return self._truthy(v)
            return v
        if kind in ("preincr", "postincr"):
            old = self.eval(node[2], scope)
            new = (old or 0) + (1 if node[1] == "++" else -1)
            self._store(node[2], new, scope)
            return new if kind == "preincr" else old
        if kind == "assign":
            op, target, value_node = node[1], node[2], node[3]
            value = self.eval(value_node, scope)
            if op != "=":
                value = self._binop(op[0], self.eval(target, scope), value)
            self._store(target, value, scope)
            return value
        if kind == "field":
            return self._field(self.eval(node[1], scope), node[2])
        if kind == "index":
            base = self.eval(node[1], scope)
            key = self.eval(node[2], scope)
            if isinstance(base, list):
                return base[int(key)]
            if isinstance(base, dict):
                return base.get(key)
            if hasattr(base, "__getitem__"):
                return base[key]
            raise IllegalArgumentError("subscript on unsupported value")
        if kind == "method":
            return self._method(node, scope)
        if kind == "call":
            return self._call(node[1], [self.eval(a, scope) for a in node[2]],
                              scope)
        raise PainlessError(f"unknown expression [{kind}]")

    def _truthy(self, v) -> bool:
        return bool(v)

    def _binop(self, op: str, left, right):
        if (left is None or right is None) and op not in ("==", "!="):
            # the reference raises a script NullPointerException here; keep
            # it a SearchEngineError so REST maps it to a client error, not
            # a 500 (e.g. `ctx._source.missing += 1`)
            raise IllegalArgumentError(
                f"cannot apply [{op}] to a null value")
        if op == "+":
            if isinstance(left, str) or isinstance(right, str):
                return _to_string(left) + _to_string(right)
            return left + right
        if op == "-":
            return left - right
        if op == "*":
            return left * right
        if op == "/":
            if isinstance(left, int) and isinstance(right, int) \
                    and not isinstance(left, bool) and not isinstance(right, bool):
                q = left // right  # Java int division truncates toward zero
                if q < 0 and q * right != left:
                    q += 1
                return q
            return left / right
        if op == "%":
            if isinstance(left, int) and isinstance(right, int) \
                    and not isinstance(left, bool) and not isinstance(right, bool):
                # Java long remainder truncates toward zero; keep it in
                # exact integer arithmetic (fmod loses exactness > 2^53)
                r = abs(left) % abs(right)
                return -r if left < 0 else r
            return math.fmod(left, right)
        if op == "==":
            return left == right
        if op == "!=":
            return left != right
        if op == "<":
            return left < right
        if op == "<=":
            return left <= right
        if op == ">":
            return left > right
        if op == ">=":
            return left >= right
        raise PainlessError(f"unknown operator [{op}]")

    def _store(self, target, value, scope) -> None:
        kind = target[0]
        if kind == "name":
            for frame in reversed(scope):
                if target[1] in frame:
                    frame[target[1]] = value
                    return
            scope[-1][target[1]] = value
            return
        if kind == "index":
            base = self.eval(target[1], scope)
            key = self.eval(target[2], scope)
            if isinstance(base, FrozenParams):
                raise IllegalArgumentError("params are read-only")
            if isinstance(base, list):
                base[int(key)] = value
            elif isinstance(base, dict):
                base[key] = value
            else:
                raise IllegalArgumentError("cannot assign into this value")
            return
        if kind == "field":
            base = self.eval(target[1], scope)
            if isinstance(base, FrozenParams):
                raise IllegalArgumentError("params are read-only")
            if isinstance(base, dict):
                base[target[2]] = value
                return
            raise IllegalArgumentError(
                f"cannot assign field [{target[2]}] on this value")
        raise IllegalArgumentError("invalid assignment target")

    def _field(self, base, name: str):
        if isinstance(base, dict):
            return base.get(name)
        if name == "length" and isinstance(base, (str, list)):
            return len(base)
        # script-context objects expose python properties (doc values)
        if base is not None and not isinstance(base, (int, float, str, bool,
                                                      list)):
            if name in getattr(base, "_painless_fields", ()):
                return getattr(base, name)
        raise IllegalArgumentError(f"field [{name}] not accessible")

    def _method(self, node, scope):
        name = node[2]
        # static allowlist FIRST: Math.max(...), Integer.parseInt(...) —
        # the class name is not a variable, so don't evaluate it
        if node[1][0] == "name":
            static = _STATIC_CALLS.get((node[1][1], name))
            if static is not None:
                return static(*(self.eval(a, scope) for a in node[3]))
        base = self.eval(node[1], scope)
        args = [self.eval(a, scope) for a in node[3]]
        if isinstance(base, str):
            table = _str_methods(base)
        elif isinstance(base, list):
            table = _list_methods(base)
        elif isinstance(base, dict):
            table = _map_methods(base)
        elif base is not None and hasattr(base, "_painless_methods"):
            table = base._painless_methods()
        else:
            table = {}
        fn = table.get(name)
        if fn is None:
            raise IllegalArgumentError(
                f"method [{name}] is not allowed on "
                f"[{type(base).__name__}]")
        return fn(*args)

    def _call(self, name: str, args: list, scope):
        fn = self.functions.get(name)
        if fn is None:
            # context-bound callables (e.g. the vector scoring kernels the
            # score context whitelists: cosineSimilarity, dotProduct, ...)
            bound = self.globals.get(name)
            if callable(bound):
                return bound(*args)
            raise IllegalArgumentError(f"unknown function [{name}]")
        _, params, body = fn
        if len(params) != len(args):
            raise IllegalArgumentError(
                f"function [{name}] expects {len(params)} args, got {len(args)}")
        self.depth += 1
        if self.depth > MAX_CALL_DEPTH:
            raise IllegalArgumentError(
                f"script call depth exceeded [{MAX_CALL_DEPTH}]")
        try:
            inner = [self.globals, dict(zip(params, args))]
            try:
                self.exec_stmt(body, inner)
            except _Return as r:
                return r.value
            return None
        finally:
            self.depth -= 1


def compile_painless(source: str):
    """Parse once; reuse across executions (Compiler.compile analog)."""
    return Parser(tokenize(source)).parse_program()


def execute(program, bindings: Dict[str, Any]) -> Any:
    try:
        return Interpreter(program, bindings).run()
    except (IllegalArgumentError, ParsingError):
        raise
    except RecursionError:
        raise IllegalArgumentError("script recursion too deep")
    except Exception as e:
        # interpreter-internal type errors etc. are the script author's
        # bug: a client error, never a 500
        raise IllegalArgumentError(
            f"runtime error in script: {type(e).__name__}: {e}")
