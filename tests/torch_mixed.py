"""The seeded mixed corpus of the search-body tests, without the JAX
package: the CPU parity tests (`tests/torch_rest_pair.py::load_mixed`)
and the CUDA cases of `tests/test_torch_gpu.py` load the same
documents."""

import numpy as np


MIXED_DIMS = 16
MIXED_WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta",
               "theta", "iota", "kappa"]
MIXED_TAGS = ["red", "green", "blue", "cyan"]


def mixed_mapping(shards: int) -> dict:
    """Every field kind the search-body tests read: a 16-d vector, keyword
    (one stored, one with `ignore_above`), integer (`ignore_malformed`),
    float, boolean and text."""
    return {"settings": {"number_of_shards": shards,
                         "number_of_replicas": 0},
            "mappings": {"properties": {
                "v": {"type": "dense_vector", "dims": MIXED_DIMS,
                      "similarity": "cosine"},
                "tag": {"type": "keyword"},
                "s": {"type": "keyword", "store": True},
                "k": {"type": "keyword", "ignore_above": 6},
                "n": {"type": "integer", "ignore_malformed": True},
                "f": {"type": "float"}, "b": {"type": "boolean"},
                "t": {"type": "text"}}}}


def mixed_doc(rng, i: int) -> dict:
    """Document i: each field missing one time in ten (the vector one in
    twenty), a few integers malformed, few distinct values so sorts
    tie."""
    doc = {"s": f"s{i % 7}",
           "t": " ".join(rng.choice(MIXED_WORDS,
                                    size=int(rng.integers(2, 8))))}
    if rng.random() > 0.05:
        doc["v"] = np.round(rng.standard_normal(MIXED_DIMS), 4).tolist()
    if rng.random() > 0.1:
        doc["tag"] = MIXED_TAGS[int(rng.integers(len(MIXED_TAGS)))]
    if rng.random() > 0.1:
        doc["n"] = int(rng.integers(0, 25)) if rng.random() > 0.04 \
            else "abc"
    if rng.random() > 0.1:
        doc["f"] = round(float(rng.random() * 10), 3)
    if rng.random() > 0.1:
        doc["b"] = bool(rng.random() > 0.5)
    if rng.random() > 0.5:
        doc["k"] = ["short", "much-too-long"][int(rng.integers(2))]
    return doc


def mixed_vector(rng) -> list:
    return np.round(rng.standard_normal(MIXED_DIMS), 4).tolist()


def mixed_bulks(name: str, n: int, rng) -> tuple:
    """The two `_bulk` bodies of a mixed index: `n` documents, then one in
    nine deleted and one in eleven updated (a new row at version 2); each
    is followed by a refresh."""
    ops = []
    for i in range(n):
        ops += [{"index": {"_id": f"{name}{i}"}}, mixed_doc(rng, i)]
    writes = [{"delete": {"_id": f"{name}{i}"}} for i in range(0, n, 9)]
    for i in range(1, n, 11):
        writes += [{"update": {"_id": f"{name}{i}"}},
                   {"doc": {"n": int(rng.integers(0, 25)),
                            "t": "alpha omega " + MIXED_WORDS[i % 10]}}]
    return ops, writes
