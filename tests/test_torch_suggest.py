"""The suggesters through both REST layers on the CPU, request for request
(`tests/torch_rest_pair.py`): `term` (misspelt and present tokens,
`size`, `max_edits`, on text and keyword fields), `phrase`, and
`completion` on a `completion` field (weights, several inputs, one
option a document, `skip_duplicates`, `category` and `geo` contexts,
contexts from a document path, the mandatory-contexts error) and on a
keyword field; each alone (`size: 0`), beside a query, over two indices
(the options merged by score) and at 1 and 2 shards."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

WORDS = ["search", "engine", "vector", "query", "index", "shard",
         "segment", "cluster", "replica", "token", "analyzer", "filter"]
TYPOS = ["serch", "enigne", "vecter", "qeury", "indx", "shrad", "sgement",
         "clustre", "replika", "tokne", "analyser", "fitler"]
CITIES = {"paris": (48.8566, 2.3522), "lyon": (45.764, 4.8357),
          "berlin": (52.52, 13.405)}


def _docs(rng, n: int) -> list:
    docs = []
    for i in range(n):
        words = list(rng.choice(WORDS, size=int(rng.integers(3, 8))))
        if rng.random() < 0.2:
            words.append(str(rng.choice(TYPOS)))
        city = str(rng.choice(list(CITIES)))
        lat, lon = CITIES[city]
        inputs = [str(w) for w in rng.choice(WORDS, size=2, replace=False)]
        doc = {"body": " ".join(words), "kw": str(rng.choice(WORDS)),
               "city": city,
               "loc": {"lat": lat + float(rng.normal(0, 0.01)),
                       "lon": lon + float(rng.normal(0, 0.01))},
               "sugg": {"input": inputs, "weight": int(rng.integers(1, 30))},
               "plain": inputs if i % 3 else inputs[0],
               "ctx": {"input": inputs[:1],
                       "weight": int(rng.integers(1, 9)),
                       "contexts": {"genre": [str(rng.choice(
                           ["news", "blog", "doc"]))]}}}
        docs.append(doc)
    return docs


MAPPING = {"properties": {
    "body": {"type": "text"}, "kw": {"type": "keyword"},
    "city": {"type": "keyword"}, "loc": {"type": "geo_point"},
    "sugg": {"type": "completion"}, "plain": {"type": "completion"},
    "ctx": {"type": "completion", "contexts": [
        {"name": "genre", "type": "category"},
        {"name": "town", "type": "category", "path": "city"},
        {"name": "where", "type": "geo", "path": "loc",
         "precision": "20km"}]}}}


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def world(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    pair = Pair(tmp_path_factory.mktemp("suggest"), mp)
    rng = np.random.default_rng(51)
    for name, n in (("s1", 90), ("s2", 40)):
        pair.same("PUT", f"/{name}", {"settings": {
            "number_of_shards": request.param}, "mappings": MAPPING})
        ops = []
        for i, doc in enumerate(_docs(rng, n)):
            ops += [{"index": {"_id": f"{name}-{i}"}}, doc]
        pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        pair.same("POST", f"/{name}/_bulk", [
            {"delete": {"_id": f"{name}-{i}"}} for i in range(0, n, 10)],
            ndjson=True)
        pair.same("POST", f"/{name}/_refresh")
    yield pair
    pair.close()
    mp.undo()


SUGGESTS = {
    "term": {"s": {"text": "serch enigne vector", "term": {
        "field": "body"}}},
    "term_size_edits": {"s": {"text": "qery shardd tokens", "term": {
        "field": "body", "size": 2, "max_edits": 1}}},
    "term_global_text": {"text": "fiter replca", "a": {"term": {
        "field": "body"}}, "b": {"term": {"field": "kw", "size": 3}}},
    "term_keyword": {"s": {"text": "analyzr", "term": {"field": "kw"}}},
    "phrase": {"p": {"text": "vecter serch engin", "phrase": {
        "field": "body"}}},
    "phrase_correct": {"p": {"text": "vector search", "phrase": {
        "field": "body"}}},
    "completion": {"c": {"prefix": "se", "completion": {"field": "sugg"}}},
    "completion_size": {"c": {"prefix": "S", "completion": {
        "field": "sugg", "size": 3}}},
    "completion_dedup": {"c": {"prefix": "", "completion": {
        "field": "sugg", "size": 20, "skip_duplicates": True}}},
    "completion_list": {"c": {"text": "in", "completion": {
        "field": "plain"}}},
    "completion_category": {"c": {"prefix": "s", "completion": {
        "field": "ctx", "size": 10, "contexts": {"genre": ["news"]}}}},
    "completion_path_category": {"c": {"prefix": "", "completion": {
        "field": "ctx", "size": 10, "contexts": {
            "town": [{"context": "lyon"}]}}}},
    "completion_geo": {"c": {"prefix": "", "completion": {
        "field": "ctx", "size": 10, "contexts": {
            "where": [{"lat": 48.86, "lon": 2.35}]}}}},
    "completion_missing_contexts": {"c": {"prefix": "s", "completion": {
        "field": "ctx"}}},
    "completion_keyword": {"c": {"prefix": "s", "completion": {
        "field": "kw"}}},
    "completion_text": {"c": {"prefix": "seg", "completion": {
        "field": "body", "size": 2}}},
    "unknown": {"x": {"text": "a", "magic": {"field": "body"}}},
}


@pytest.mark.parametrize("case", sorted(SUGGESTS))
def test_suggest_matches_reference(world, case):
    spec = SUGGESTS[case]
    world.same("POST", "/s1/_search", {"suggest": spec, "size": 0})
    world.same("POST", "/s1/_search", {"suggest": spec,
                                       "query": {"match": {"body": "index"}},
                                       "size": 3})
    world.same("POST", "/s1,s2/_search", {"suggest": spec, "size": 0})
