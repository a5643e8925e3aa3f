"""Two repaired faults through both REST layers on the CPU
(`tests/torch_rest_pair.py`): `GET /` carries the reference's keys
(`cluster_name` among them), and a `knn` spec with a key the reference
does not read (`similarity`, an invented one) is answered as the
reference answers it, on a plain body and on both hybrid paths (the
fused `rank: {rrf}` of one index and the general one)."""

import numpy as np
import pytest

from tests.torch_rest_pair import Pair

DIMS = 4


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    p = Pair(tmp_path_factory.mktemp("root"), mp)
    rng = np.random.default_rng(31)
    for name in ("v1", "v2"):
        p.same("PUT", f"/{name}", {"mappings": {"properties": {
            "v": {"type": "dense_vector", "dims": DIMS,
                  "similarity": "cosine"},
            "t": {"type": "text"}, "n": {"type": "integer"}}}})
        ops = []
        for i in range(50):
            ops += [{"index": {"_id": str(i)}},
                    {"v": np.round(rng.standard_normal(DIMS), 3).tolist(),
                     "t": ["alpha beta", "beta gamma", "gamma"][i % 3],
                     "n": i}]
        p.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        p.same("POST", f"/{name}/_refresh")
    yield p
    p.close()
    mp.undo()


def test_root_keys_are_the_reference_keys(pair):
    s1, want = pair.ref("GET", "/")
    s2, got = pair.port("GET", "/")
    assert s1 == s2 == 200
    assert set(got) == set(want)
    assert set(got["version"]) >= {"number", "build_flavor",
                                   "lucene_version"}
    assert got["cluster_name"] == pair.port_node.cluster_name \
        == want["cluster_name"]


KNN = {"field": "v", "query_vector": [0.3, -0.1, 0.5, 0.2], "k": 5,
       "num_candidates": 20}


@pytest.mark.parametrize("extra", [{"similarity": 0.1},
                                   {"similarity": 0.9, "frobnicate": 3},
                                   {"inner_product_boost": "x"}],
                         ids=["similarity", "two_keys", "invented"])
def test_knn_ignores_keys_it_does_not_read(pair, extra):
    """The plain body over one index and over two, with `filter` too."""
    knn = {**KNN, **extra}
    for target in ("v1", "v1,v2"):
        pair.same("POST", f"/{target}/_search", {"knn": knn})
        pair.same("POST", f"/{target}/_search", {
            "knn": {**knn, "filter": {"range": {"n": {"gte": 10}}}},
            "size": 3})
        pair.same("POST", f"/{target}/_search", {
            "knn": [knn, {**KNN, "query_vector": [0.1, 0.1, -0.4, 0.3]}],
            "query": {"match": {"t": "gamma"}}})


@pytest.mark.parametrize("extra", [{"similarity": 0.1},
                                   {"similarity": 0.5, "frobnicate": 3}],
                         ids=["similarity", "two_keys"])
@pytest.mark.parametrize("path", ["fused", "general"])
def test_hybrid_knn_ignores_keys_it_does_not_read(pair, extra, path):
    """A `rank: {rrf}` body whose knn leg carries the keys: the same hits
    through the fused path (one index) and the general one (two
    indices)."""
    body = {"query": {"match": {"t": "gamma"}}, "knn": {**KNN, **extra},
            "rank": {"rrf": {}}, "size": 5}
    target = "v1" if path == "fused" else "v1,v2"
    s1, want = pair.ref("POST", f"/{target}/_search", body)
    s2, got = pair.port("POST", f"/{target}/_search",
                        dict(body, request_cache=False))
    assert s1 == s2 == 200, got
    pair.match(want["hits"], got["hits"], path)
    assert [h["_id"] for h in got["hits"]["hits"]] \
        == [h["_id"] for h in want["hits"]["hits"]]
