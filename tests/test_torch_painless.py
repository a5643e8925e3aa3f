"""The Painless interpreter of the port (`script/painless.py`) against the
reference's on the programs of `tests/test_painless.py`: each program
runs through both with the same bindings, as one case of one
parametrised test, and both give the same value, or raise the same
exception class with the same message."""

import pytest

from elasticsearch_tpu.script import painless as ref_painless
from elasticsearch_tpu_torch.script import painless as port_painless

GRADE = """
def grade(int n) {
  if (n >= 90) { return 'A'; }
  else if (n >= 80) { return 'B'; }
  else { return 'C'; }
}
return grade(params.n);
"""
BREAK = """
def s = 0;
for (int i = 0; i < 100; i++) {
  if (i % 2 == 0) { continue; }
  if (i > 7) { break; }
  s += i;
}
return s;
"""
FIB = """
int fib(int n) { if (n < 2) { return n; } return fib(n-1) + fib(n-2); }
return fib(10);
"""
UPDATE = """
ctx._source.total = 0;
for (def c : ctx._source.counts) { ctx._source.total += c; }
ctx._source.tag = params.tag;
"""

PROGRAMS = [
    ("1 + 2 * 3", {}), ("(1 + 2) * 3.0", {}), ("7 % 3", {}),
    ("'a' + 'b' + 1", {}),
    ("7 / 2", {}), ("-7 / 2", {}), ("7.0 / 2", {}),
    ("def x = 4; x += 3; x *= 2; return x;", {}),
    ("int a = 1; int b = 2; def c = a + b; c", {}),
    (GRADE, {"params": {"n": 95}}), (GRADE, {"params": {"n": 85}}),
    (GRADE, {"params": {"n": 10}}),
    ("def s = 0; for (int i = 0; i < 10; i++) { s += i; } return s;", {}),
    ("def s = 0; def i = 0; while (i < 5) { s += i; i++; } s", {}),
    ("def i = 0; do { i++; } while (i < 3); i", {}),
    ("def s = 0; for (def x : params.xs) { s += x; } s",
     {"params": {"xs": [1, 2, 3]}}),
    ("def n = 0; for (k in params.m) { n += params.m[k]; } n",
     {"params": {"m": {"a": 1, "b": 2}}}),
    (BREAK, {}), (FIB, {}),
    ("def l = [1, 2, 3]; l.add(4); return l.size();", {}),
    ("def m = ['a': 1]; m.put('b', 2); return m.get('b');", {}),
    ("def m = [:]; m.x = 5; return m.x;", {}),
    ("def l = new ArrayList(); l.add('q'); l.contains('q')", {}),
    ("def m = new HashMap(); m.containsKey('nope')", {}),
    ("'hello'.substring(1, 3)", {}), ("'Hello'.toLowerCase()", {}),
    ("'a,b,c'.split(',').length", {}), ("'abc'.length()", {}),
    ("params.x > 3 ? 'big' : 'small'", {"params": {"x": 5}}),
    ("params.missing ?: 'default'", {"params": {}}),
    ("Math.max(3, Math.abs(-7))", {}), ("Integer.parseInt('42') + 1", {}),
    ("(int) 3.9", {}),
    ("params.x instanceof String", {"params": {"x": "s"}}),
    ("params.x instanceof List", {"params": {"x": [1]}}),
    ("params.x instanceof Map", {"params": {"x": 3}}),
    # the sandbox
    ("__import__('os')", {}), ("'s'.__class__()", {}),
    ("params.getClass()", {"params": {}}), ("new File('/etc/passwd')", {}),
    ("def i = 0; while (true) { i += 1; } i", {}),
    ("int f(int n) { return f(n + 1); } return f(0);", {}),
    ("def x = ;", {}),
    ("params.t = 1", "frozen"),
    # the update context
    (UPDATE, {"ctx": {"_source": {"counts": [1, 2, 3], "total": 0}},
              "params": {"tag": "summed"}}),
    ("if (ctx._source.stale == false) { ctx.op = 'none' } "
     "else { ctx._source.n += 1 }",
     {"ctx": {"_source": {"stale": False, "n": 1}, "op": "index"}}),
    ("if (ctx._source.stale) { ctx.op = 'delete' }",
     {"ctx": {"_source": {"stale": True, "n": 2}, "op": "index"}}),
    ("ctx._source.missing += 1", {"ctx": {"_source": {"a": 1}}}),
    ("ctx._source.tags.add(params.t); ctx._source.tags.size()",
     {"ctx": {"_source": {"tags": ["a"]}}, "params": {"t": "b"}}),
]


def _bindings(module, spec):
    import copy
    if spec == "frozen":
        return {"params": module.FrozenParams({"t": 0})}
    out = copy.deepcopy(spec)
    if "params" in out:
        out["params"] = module.FrozenParams(out["params"])
    return out


def _run(module, src, spec):
    bindings = _bindings(module, spec)
    try:
        value = module.execute(module.compile_painless(src), bindings)
    except Exception as e:   # the outcome compared is the error
        return ("error", type(e).__name__, str(e))
    return ("value", value, bindings.get("ctx"))


@pytest.mark.parametrize("i", range(len(PROGRAMS)))
def test_program_matches_reference(i):
    src, spec = PROGRAMS[i]
    want = _run(ref_painless, src, spec)
    got = _run(port_painless, src, spec)
    assert got == want, (src, want, got)
    if want[0] == "value":
        assert type(got[1]) is type(want[1])
