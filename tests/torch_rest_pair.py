"""Both REST layers in one process on the CPU: the reference `Node` and the
port's `Node` behind their own `RestController`s, fed the same requests.

`Pair.same` sends one request to both and holds the port's answer to the
reference's: the status, then the body less `took`, the index `uuid` and
`creation_date`, with the port's auto ids read as the reference's (each
pair of 20-hex-digit ids met at one place in two bodies is recorded) and
hits compared as `tests/test_torch_rest.py` compares them (ids where the
reference's score gap exceeds 1e-4, scores within 1e-4). `same_profile`
holds a profiled search the same way, and its profile by structure."""

import json
import re

import numpy as np

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.actions import register_all as ref_register
from elasticsearch_tpu.rest.controller import RestController as RefController
from elasticsearch_tpu.vectors import store as ref_store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from tests.torch_mixed import (  # noqa: F401  (the tests' one import)
    mixed_bulks, mixed_mapping, mixed_vector,
)

_AUTO_ID = re.compile(r"^[0-9a-f]{20}$")
_VOLATILE = {"took", "uuid", "creation_date", "index.uuid",
             "index.creation_date"}
TOL = 1e-4


def raw(body, ndjson=False) -> bytes:
    if body is None:
        return b""
    if ndjson:
        return b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
    return json.dumps(body).encode()


class Pair:
    def __init__(self, tmp_path, monkeypatch, settings=None):
        # the reference serves from its device route, as in test_torch_rest
        monkeypatch.setattr(ref_store.native, "AVAILABLE", False)
        self.ref_node = RefNode(str(tmp_path / "data"))
        self.port_node = Node(device="cpu", settings=settings)
        self.ref_rc = RefController()
        ref_register(self.ref_rc, self.ref_node)
        self.port_rc = RestController()
        register_all(self.port_rc, self.port_node)
        self.ids = {}       # port auto id -> the reference's

    def close(self):
        self.ref_node.close()

    def ref(self, method, path, body=None, ndjson=False, query=None):
        return self.ref_rc.dispatch(method, path, dict(query or {}),
                                    raw(body, ndjson), "application/json")

    def port(self, method, path, body=None, ndjson=False, query=None):
        return self.port_rc.dispatch(method, path, dict(query or {}),
                                     raw(body, ndjson))

    def same(self, method, path, body=None, ndjson=False, query=None,
             volatile=()):
        """One request to both layers; asserts the port answers as the
        reference does and returns (reference body, port body). Keys in
        `volatile` are left out too (an auto id's `_seq_no` depends on the
        shard its random id routes to)."""
        s1, want = self.ref(method, path, body, ndjson, query)
        s2, got = self.port(method, path, body, ndjson, query)
        where = f"{method} {path} {query or ''}"
        assert s1 == s2, (where, want, got)
        self.match(want, got, where, _VOLATILE | set(volatile))
        return want, got

    def match(self, want, got, where="", volatile=_VOLATILE) -> None:
        _match(self, want, got, where, volatile)


def _match(pair, want, got, where, volatile=_VOLATILE) -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict), (where, want, got)
        wk = set(want) - volatile
        gk = set(got) - volatile
        assert wk == gk, (where, sorted(wk ^ gk), want, got)
        for k in wk:
            if k == "hits" and isinstance(want[k], list):
                _match_hits(pair, want[k], got[k], f"{where}.hits")
            else:
                _match(pair, want[k], got[k], f"{where}.{k}", volatile)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (where, want, got)
        for i, (w, g) in enumerate(zip(want, got)):
            _match(pair, w, g, f"{where}[{i}]", volatile)
        return
    if isinstance(want, str) and isinstance(got, str) \
            and _AUTO_ID.match(want) and _AUTO_ID.match(got):
        known = pair.ids.setdefault(got, want)
        assert known == want, (where, want, got)
        return
    if isinstance(want, float) and isinstance(got, (int, float)) \
            and not isinstance(got, bool):
        assert abs(want - got) <= TOL, (where, want, got)
        return
    assert want == got, (where, want, got)


def _match_hits(pair, want, got, where) -> None:
    """Hits rank by score: scores within TOL rank by rank, and a hit whose
    score is apart from its neighbours' by more than TOL is the same hit."""
    assert len(got) == len(want), (where, want, got)
    if not want or "_score" not in want[0] or want[0]["_score"] is None:
        _match(pair, want, got, where)
        return
    ws = np.array([h["_score"] for h in want])
    gs = np.array([h["_score"] for h in got])
    np.testing.assert_allclose(gs, ws, atol=TOL, err_msg=where)
    gap = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                     np.abs(np.diff(ws, append=-np.inf)))
    for j in range(len(want)):
        if gap[j] > TOL:
            _match(pair, want[j], got[j], f"{where}[{j}]")


def hit_ids(body) -> list:
    return [h["_id"] for h in body["hits"]["hits"]]


def load_mixed(pair, name: str, shards: int, seed: int, n: int = 200):
    """A mixed index (`tests/torch_mixed.py`) in both layers: `n`
    documents, then its deletes and updates, each refreshed; the
    generator is returned for the queries."""
    rng = np.random.default_rng(seed)
    pair.same("PUT", f"/{name}", mixed_mapping(shards))
    for ops in mixed_bulks(name, n, rng):
        pair.same("POST", f"/{name}/_bulk", ops, ndjson=True)
        pair.same("POST", f"/{name}/_refresh")
    return rng


def profile_skeleton(x):
    """A profile's structure: keys, strings and None kept, numbers and
    bools by kind, launch event lists and the trace left out."""
    if isinstance(x, dict):
        return {k: profile_skeleton(v) for k, v in x.items()
                if k not in ("dispatch", "trace")}
    if isinstance(x, list):
        return [profile_skeleton(v) for v in x]
    if isinstance(x, bool):
        return "bool"
    if isinstance(x, (int, float)):
        return "number"
    return x


def same_profile(pair, path: str, body: dict, query=None, hits_only=False,
                 skeleton=profile_skeleton):
    """One profiled request to both layers: the response less `profile`
    as `Pair.same` holds it (only its `hits` with `hits_only`), then the
    profile's structure; each query time is positive and `profile.trace`
    names a trace with spans. Returns (reference profile, port
    profile)."""
    s1, want = pair.ref("POST", path, body, query=query)
    s2, got = pair.port("POST", path, body, query=query)
    assert s1 == s2 == 200, (want, got)
    wp, gp = want.pop("profile"), got.pop("profile")
    if hits_only:
        pair.match(want["hits"], got["hits"], path)
    else:
        pair.match(want, got, path)
    assert skeleton(gp) == skeleton(wp), (wp, gp)
    for prof in (wp, gp):
        assert set(prof["trace"]) == {"trace_id", "top_spans"}
        assert prof["trace"]["top_spans"]
    for shard in gp.get("shards", []):
        assert shard["searches"][0]["query"][0]["time_in_nanos"] > 0
    if "hybrid" in gp:
        assert gp["hybrid"]["breakdown"]["score_nanos"] > 0
    return wp, gp
