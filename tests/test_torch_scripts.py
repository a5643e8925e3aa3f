"""Scripts through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`), on the seeded mixed index
(`tests/torch_mixed.py`) at 1 and 2 shards: `script_score` as an
expression (doc values, `_score`, `params`, `Math`) and as a Painless
statement, each vector function (scores within 1e-5 relative of the
reference's), a stored script by id; `script_fields`; the errors a
script can raise (compile, sandbox, a missing doc value, a non-numeric
result); `_update` scripts (a change, `ctx.op` none and delete, a stored
script, `upsert` and `scripted_upsert`, through `_bulk` too); the
`_scripts/{id}` routes; and the template routes (`_search/template`,
`_render/template[/{id}]`, `_msearch/template`)."""

import numpy as np
import pytest

from elasticsearch_tpu.script.service import GLOBAL_SCRIPTS as REF_SCRIPTS
from elasticsearch_tpu_torch.script.service import GLOBAL_SCRIPTS
from tests.torch_rest_pair import Pair, load_mixed, mixed_vector


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("scripts"), mp)
    pair.rng = load_mixed(pair, "a", request.param, 41)
    yield pair
    pair.close()
    mp.undo()


@pytest.fixture(autouse=True)
def no_stored_scripts():
    """Both registries are process-wide: each test starts with none."""
    REF_SCRIPTS.clear()
    GLOBAL_SCRIPTS.clear()
    yield
    REF_SCRIPTS.clear()
    GLOBAL_SCRIPTS.clear()


QV = mixed_vector(np.random.default_rng(43))

SCRIPTS = {
    "expr_doc": {"source": "doc['n'].value * 2 + _score"},
    "expr_params": {"source": "params.a * doc['f'].value + params['b']",
                    "params": {"a": 0.5, "b": 3}},
    "expr_math": {"source": "Math.log(2 + doc['f'].value) "
                            "+ Math.max(doc['n'].value, 3)"},
    "expr_bool_empty": {"source": "doc['b'].value + (doc['f'].empty * 10)"
                                  " + doc['n'].size()"},
    "expr_ifexp": {"source": "1 if doc['n'].value > 10 else 2"},
    "expr_saturation": {"source": "saturation(doc['f'].value + 1, 4) "
                                  "+ sigmoid(doc['n'].value + 1, 3, 0.5)"},
    "statement": {"source": "def v = doc['n'].size() == 0 ? 0 : "
                            "doc['n'].value; if (v % 2 == 0) { return v * "
                            "10; } return v + _score;"},
    "statement_loop": {"source": "def t = 0; for (def x : doc['tag']"
                                 ".values) { if (x == 'red') { t += 100; }"
                                 " } return t + params.k;",
                       "params": {"k": 1}},
}

VECTOR_SCRIPTS = {
    "cosine": "cosineSimilarity(params.qv, 'v') + 1.0",
    "dot": "dotProduct(params.qv, 'v')",
    "l1": "1 / (1 + l1norm(params.qv, 'v'))",
    "l2": "1 / (1 + l2norm(params.qv, 'v'))",
    "statement_cosine": "double c = cosineSimilarity(params.qv, 'v'); "
                        "if (c > 0) { return c + 1; } return 1 / (2 - c);",
}


def _script_score(script, query=None):
    return {"query": {"script_score": {
        "query": query or {"match_all": {}}, "script": script}},
        "size": 30}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_script_score_matches_reference(world, case):
    world.same("POST", "/a/_search", _script_score(SCRIPTS[case]))
    world.same("POST", "/a/_search", _script_score(
        SCRIPTS[case], {"bool": {"filter": [{"range": {"n": {"gte": 0}}}],
                                 "should": [{"match": {"t": "alpha"}}]}}))


@pytest.mark.parametrize("case", sorted(VECTOR_SCRIPTS))
def test_vector_functions_match_reference(world, case):
    """Each vector function over the rows with a vector, unfiltered and
    over a filter; the scores within 1e-5 relative of the reference's."""
    script = {"source": VECTOR_SCRIPTS[case], "params": {"qv": QV}}
    for query in ({"exists": {"field": "v"}},
                  {"bool": {"filter": [{"exists": {"field": "v"}},
                                       {"term": {"tag": "green"}}]}}):
        want, got = world.same("POST", "/a/_search",
                               _script_score(script, query))
        ws = np.array([h["_score"] for h in want["hits"]["hits"]])
        gs = np.array([h["_score"] for h in got["hits"]["hits"]])
        np.testing.assert_allclose(gs, ws, rtol=1e-5)


def test_stored_script_by_id(world):
    for body in ({"script": {"lang": "painless", "source":
                             "doc['f'].value * params.m"}},
                 {"script": {"source": "if (doc['n'].size() == 0) { return "
                                       "0; } return doc['n'].value;"}}):
        world.same("PUT", "/_scripts/s1", body)
        world.same("GET", "/_scripts/s1")
        world.same("POST", "/a/_search", _script_score(
            {"id": "s1", "params": {"m": 4}}))
        world.same("POST", "/a/_search", {"size": 5, "script_fields": {
            "x": {"script": {"id": "s1", "params": {"m": 2}}}}})
    world.same("DELETE", "/_scripts/s1")
    world.same("GET", "/_scripts/s1")
    world.same("DELETE", "/_scripts/s1")
    world.same("POST", "/a/_search", _script_score({"id": "s1"}))
    world.same("PUT", "/_scripts/t1", {"script": {"lang": "mustache",
                                                  "source": "{{x}}"}})
    world.same("POST", "/a/_search", _script_score({"id": "t1"}))
    for bad in ({"script": {"source": "def x = ;"}},
                {"script": {"lang": "groovy", "source": "1"}},
                {"script": {"lang": "mustache", "source": "{{#a}}"}},
                {"nope": 1}):
        world.same("PUT", "/_scripts/bad", bad)


def test_script_fields_match_reference(world):
    world.same("POST", "/a/_search", {
        "query": {"match": {"t": "alpha"}}, "size": 12, "from": 2,
        "docvalue_fields": ["n"],
        "script_fields": {
            "twice": {"script": {"source": "doc['n'].value * 2"}},
            "cos": {"script": {"source": "cosineSimilarity(params.qv, 'v')",
                               "params": {"qv": QV}}},
            "stmt": {"script": "def s = 0; for (def x : doc['tag'].values)"
                               " { s += x.length(); } return s;"}}})
    world.same("POST", "/a/_search", {
        "sort": [{"n": "desc"}], "size": 5,
        "script_fields": {"f": {"script": "doc['f'].value + 1"}}})
    world.same("POST", "/a/_search", {
        "query": {"match_none": {}},
        "script_fields": {"bad": {"script": "def x = ;"}}})


@pytest.mark.parametrize("source", [
    "def x = ; return 1", "foo.bar", "__import__('os')",
    "int x = 1; return doc['nope'].value",
    "def l = [1]; return l.get(5);",
    "while (true) { }",
    "'abc'", "def s = 'abc'; return s;",
], ids=["compile", "unknown_name", "sandbox", "missing_value",
        "runtime", "loop_budget", "expression_string", "statement_string"])
def test_script_errors_match_reference(world, source):
    """A script's error is the reference's: its status, type and reason
    (a 500 has a stack trace, which is not compared)."""
    s1, want = world.ref("POST", "/a/_search", _script_score(source))
    s2, got = world.port("POST", "/a/_search", _script_score(source))
    assert s1 == s2 and s1 >= 400, (want, got)
    assert got["error"]["type"] == want["error"]["type"]
    assert got["error"]["reason"] == want["error"]["reason"]


def test_script_sort_answers_as_reference(world):
    """The reference sorts a `_script` clause as a field no document
    holds; the port answers the same."""
    world.same("POST", "/a/_search", {"sort": [
        {"_script": {"type": "number", "script": "doc['n'].value",
                     "order": "desc"}}, {"n": "asc"}], "size": 20})


def test_update_scripts_match_reference(world):
    world.same("PUT", "/u", {"settings": {"number_of_shards": 1}})
    for i in range(4):
        world.same("PUT", f"/u/_doc/d{i}", {"n": i, "stale": i % 2 == 0,
                                            "tags": ["x"]})
    world.same("POST", "/u/_update/d1", {"script": {
        "source": "ctx._source.n += params.by; ctx._source.tags.add('y')",
        "params": {"by": 5}}})
    world.same("POST", "/u/_update/d1", {"script": "ctx._source.n *= 2",
                                         "_source": True})
    world.same("POST", "/u/_update/d2", {"script": {
        "source": "if (ctx._source.stale) { ctx.op = 'none' } "
                  "else { ctx._source.n = 0 }"}})
    world.same("POST", "/u/_update/d0", {"script": {
        "source": "if (ctx._source.stale) { ctx.op = 'delete' }"}})
    world.same("GET", "/u/_doc/d0")
    world.same("GET", "/u/_doc/d1")
    world.same("GET", "/u/_doc/d2")
    # missing documents: upsert, scripted_upsert, and none
    world.same("POST", "/u/_update/d9", {"script": "ctx._source.n = 1",
                                         "upsert": {"n": 0}})
    world.same("POST", "/u/_update/d8", {"script": "ctx._source.n = 1",
                                         "upsert": {"n": 0},
                                         "scripted_upsert": True})
    world.same("POST", "/u/_update/d7", {"script": "ctx._source.n = 1"})
    world.same("GET", "/u/_doc/d9")
    # a stored script, then errors
    world.same("PUT", "/_scripts/inc", {"script": {
        "source": "ctx._source.n += params.k"}})
    world.same("POST", "/u/_update/d3", {"script": {"id": "inc",
                                                    "params": {"k": 7}}})
    world.same("PUT", "/_scripts/tpl", {"script": {"lang": "mustache",
                                                   "source": "{{a}}"}})
    for bad in ({"script": {"id": "tpl"}}, {"script": {"id": "nope"}},
                {"script": "ctx._source.missing += 1"},
                {"script": "def = ;"}, {"script": "ctx._source.n.foo()"}):
        world.same("POST", "/u/_update/d3", bad)
    world.same("POST", "/u/_refresh")
    world.same("POST", "/u/_search", {"sort": ["_doc"], "size": 20})
    # through `_bulk`
    world.same("POST", "/u/_bulk", [
        {"update": {"_id": "d1"}}, {"script": "ctx._source.n = -1"},
        {"update": {"_id": "d3"}}, {"script": {
            "source": "ctx.op = 'delete'"}},
        {"update": {"_id": "d2"}}, {"script": "ctx.op = 'none'"},
    ], ndjson=True, query={"refresh": "true"})
    world.same("POST", "/u/_search", {"sort": ["_doc"], "size": 20})
    world.same("DELETE", "/u")


TEMPLATE = {"source": {"query": {"match": {"t": "{{q}}"}},
                       "size": "{{size}}"},
            "params": {"q": "alpha beta", "size": 7}}
TEMPLATE_STR = ('{"query": {"bool": {"filter": [{"terms": {"tag": '
                '{{#toJson}}tags{{/toJson}}}}]}}, "size": {{n}}'
                '{{#sorted}}, "sort": ["n", "_doc"]{{/sorted}}}')


def test_search_templates_match_reference(world):
    world.same("POST", "/a/_search/template", TEMPLATE)
    world.same("GET", "/_search/template",
               {"source": TEMPLATE_STR, "explain": False,
                "params": {"tags": ["red", "blue"], "n": 4,
                           "sorted": True}})
    world.same("PUT", "/_scripts/tq", {"script": {"lang": "mustache",
                                                  "source": TEMPLATE_STR}})
    world.same("POST", "/a/_search/template",
               {"id": "tq", "params": {"tags": ["cyan"], "n": 3}})
    world.same("POST", "/_render/template", TEMPLATE)
    world.same("POST", "/_render/template/tq",
               {"params": {"tags": ["a"], "n": 1, "sorted": [1]}})
    world.same("GET", "/_render/template", {"id": "tq", "params": {
        "tags": [], "n": 2}})
    world.same("POST", "/a/_msearch/template", [
        {}, TEMPLATE, {"index": "a"},
        {"id": "tq", "params": {"tags": ["red"], "n": 2}},
        {}, {"id": "missing"},
        {}, {"source": "{{#a}}", "params": {}}], ndjson=True)
    for bad in ({"params": {}}, {"source": "{\"size\": {{n}}",
                                 "params": {"n": 1}},
                {"id": "nope"}):
        world.same("POST", "/a/_search/template", bad)
        world.same("POST", "/_render/template", bad)
    world.same("POST", "/_msearch/template", [{}], ndjson=True)
