"""Document → shard routing (port of `elasticsearch_tpu/cluster/routing.py`).

shard = murmur3_32(routing key) floorMod number_of_shards, where the
routing key defaults to the document id (`OperationRouting.generateShardId`).
The hash is MurmurHash3 x86 32-bit with seed 0 over the bytes the
reference hashes: each Java char as two little-endian bytes (UTF-16LE,
`Murmur3HashFunction.java`), so a document lands on the shard the
reference puts it on. One numpy implementation (`murmur3_x86_32_many`)
serves a single key and a whole batch alike.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_x86_32_rows(data: np.ndarray, seed: int = 0) -> np.ndarray:
    """MurmurHash3 x86 32-bit with `seed` of each row of a uint8 [n, L]
    matrix (n strings of L bytes), as Java signed 32-bit ints (int64
    [n]); uint32 products wrap as the hash's do."""
    n, length = data.shape
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
    h = np.full(n, seed & 0xFFFFFFFF, dtype=np.uint32)
    rounded = length & ~0x3
    blocks = np.ascontiguousarray(data[:, :rounded]).view("<u4")
    for j in range(rounded // 4):
        k = _rotl(blocks[:, j].astype(np.uint32) * c1, 15) * c2
        h = _rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
    tail = length & 0x3
    if tail:
        k = np.zeros(n, dtype=np.uint32)
        for t in range(tail - 1, -1, -1):
            k ^= data[:, rounded + t].astype(np.uint32) << np.uint32(8 * t)
        h ^= _rotl(k * c1, 15) * c2
    h ^= np.uint32(length)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    signed = h.astype(np.int64)
    signed[signed >= (1 << 31)] -= 1 << 32
    return signed


def murmur3_x86_32_many(datas: Sequence[bytes], seed: int = 0) -> np.ndarray:
    """`murmur3_x86_32_rows` of every byte string (int64 [len(datas)]),
    the strings of one byte length hashed together. The port's one copy
    of the hash: routing, the terms aggregation's partitions and sliced
    scrolls read it."""
    out = np.zeros(len(datas), dtype=np.int64)
    lengths = np.fromiter(map(len, datas), dtype=np.int64, count=len(datas))
    for length in np.unique(lengths).tolist():
        where = np.nonzero(lengths == length)[0]
        data = np.frombuffer(b"".join(datas[i] for i in where),
                             dtype=np.uint8).reshape(len(where), length)
        out[where] = murmur3_x86_32_rows(data, seed)
    return out


def hash_routings(routings: Sequence[str]) -> np.ndarray:
    """`Murmur3HashFunction.hash(String)` of every key, as Java signed
    32-bit ints (int64 [len(routings)]): murmur3 with seed 0 over the
    UTF-16LE char bytes."""
    return murmur3_x86_32_many([r.encode("utf-16-le") for r in routings])


def hash_routing(routing: str) -> int:
    """`hash_routings` of one key."""
    return int(hash_routings([routing])[0])


def shard_ids_for(routings: Sequence[str], num_shards: int) -> np.ndarray:
    """murmur3(routing) floorMod num_shards of every key (numpy's % of
    int64 is a floor mod). Returns int64 [len(routings)]."""
    if num_shards == 1:
        return np.zeros(len(routings), dtype=np.int64)
    return hash_routings(routings) % num_shards


def shard_id_for(routing: str, num_shards: int) -> int:
    """`shard_ids_for` of one key."""
    return int(shard_ids_for([routing], num_shards)[0])
