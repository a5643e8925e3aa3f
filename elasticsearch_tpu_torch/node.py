"""One node holding single-shard indices (port of the served slices of
`elasticsearch_tpu/node.py`): index create (with the `index.knn.*` engine
settings), document writes, `_bulk`, refresh, realtime GET, `_search` with
`knn` (one spec or a list, each with an optional filter) and / or a
`query` of the ported kinds, and hybrid `rank: {rrf}` searches (one
`HybridExecutor` per index), with the reference's response shapes."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional

from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, IndexNotFoundError, ResourceAlreadyExistsError,
    SearchEngineError,
)
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.search.hybrid_plan import HybridExecutor
from elasticsearch_tpu_torch.search.queries import SearchContext
from elasticsearch_tpu_torch.search.service import execute_search
from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

_SHARDS_OK = {"total": 1, "successful": 1, "failed": 0}


def flat_settings(settings: Optional[dict]) -> Dict[str, object]:
    """Index settings as one flat dict under the `index.` namespace, as the
    reference normalizes them: bodies mix bare keys (`knn.engine`), dotted
    keys (`index.knn.engine`) and nested objects (`{"index": {"knn": ...}}`)
    freely."""
    flat: Dict[str, object] = {}

    def put(prefix: str, obj: dict) -> None:
        for k, v in obj.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}.", v)
            else:
                flat[f"{prefix}{k}"] = v

    for k, v in (settings or {}).items():
        if k == "index" and isinstance(v, dict):
            put("index.", v)
        elif k.startswith("index."):
            put("", {k: v})
        else:
            put("index.", {k: v})
    return flat


def validate_knn_settings(settings: Dict[str, object]):
    """Validate + normalize the flat `index.knn.*` engine settings; returns
    (engine, nlist, nprobe), with the reference's 400 errors (port of
    `elasticsearch_tpu/indices/service.py::validate_knn_settings`)."""
    engine = str(settings.get("index.knn.engine", "tpu"))
    if engine not in ("tpu", "tpu_ivf"):
        raise IllegalArgumentError(
            f"unknown [index.knn.engine] value [{engine}]; "
            f"expected one of [tpu, tpu_ivf]")
    nlist = settings.get("index.knn.nlist")
    if nlist is not None:
        try:
            nlist = int(nlist)
        except (TypeError, ValueError):
            nlist = 0
        if nlist < 1:
            raise IllegalArgumentError(
                f"[index.knn.nlist] must be an integer >= 1, got "
                f"[{settings.get('index.knn.nlist')}]")
    nprobe = settings.get("index.knn.nprobe", "auto")
    if nprobe != "auto":
        try:
            nprobe = int(nprobe)
        except (TypeError, ValueError):
            nprobe = 0
        if nprobe < 1:
            raise IllegalArgumentError(
                f"[index.knn.nprobe] must be an integer >= 1 or "
                f"\"auto\", got [{settings.get('index.knn.nprobe')}]")
    return engine, nlist, nprobe


class IndexService:
    """One single-shard index: mapping, engine and device vector store."""

    def __init__(self, name: str, mapping: Optional[dict], device,
                 knn_engine: str = "tpu", knn_nlist=None, knn_nprobe="auto",
                 settings: Optional[Dict[str, object]] = None):
        self.name = name
        self.settings = dict(settings or {})   # flat `index.*` settings
        self.uuid = uuid.uuid4().hex[:22]
        self.mapper_service = MapperService(mapping)
        self.engine = Engine(self.mapper_service)
        self.store = VectorStoreShard(device=device, knn_engine=knn_engine,
                                      knn_nlist=knn_nlist,
                                      knn_nprobe=knn_nprobe)
        self.engine.add_refresh_listener(
            lambda reader: self.store.sync(
                reader, self.mapper_service.vector_fields()))


class Node:
    def __init__(self, device="cuda", node_name: str = "node-0"):
        self.device = resolve_device(device)
        self.node_name = node_name
        self.node_id = uuid.uuid4().hex[:22]
        self.indices: Dict[str, IndexService] = {}
        # index name -> its hybrid executor (plan cache + late-interaction
        # store), made at the index's first hybrid search
        self._hybrid: Dict[str, HybridExecutor] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------------- indices
    def create_index(self, name: str, body: Optional[dict]) -> dict:
        body = body or {}
        if name != name.lower() or name.startswith(("_", "-", "+")):
            raise IllegalArgumentError(f"invalid index name [{name}]")
        settings = flat_settings(body.get("settings"))
        shards = settings.get("index.number_of_shards", 1)
        if int(shards) != 1:
            raise IllegalArgumentError(
                "this build serves single-shard indices only: "
                f"[number_of_shards] must be 1, got [{shards}]")
        with self._lock:
            if name in self.indices:
                svc = self.indices[name]
                raise ResourceAlreadyExistsError(
                    f"index [{name}/{svc.uuid}] already exists", index=name)
            engine, nlist, nprobe = validate_knn_settings(settings)
            self.indices[name] = IndexService(
                name, body.get("mappings"), self.device, knn_engine=engine,
                knn_nlist=nlist, knn_nprobe=nprobe, settings=settings)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundError(name)
        return svc

    def _index_or_autocreate(self, name: str) -> IndexService:
        if name not in self.indices:
            try:
                self.create_index(name, None)
            except ResourceAlreadyExistsError:
                pass  # raced: another writer created it
        return self.indices[name]

    # ------------------------------------------------------------ documents
    @staticmethod
    def _write_response(svc, res) -> dict:
        return {"_index": svc.name, "_id": res.doc_id,
                "_version": res.version, "result": res.result,
                "_shards": dict(_SHARDS_OK), "_seq_no": res.seq_no,
                "_primary_term": res.primary_term}

    def index_doc(self, index: str, doc_id: Optional[str], body: dict,
                  op_type: str = "index",
                  refresh: Optional[str] = None) -> dict:
        svc = self._index_or_autocreate(index)
        if doc_id is None:
            doc_id, op_type = uuid.uuid4().hex[:20], "create"
        res = svc.engine.index(str(doc_id), body, op_type=op_type)
        out = self._write_response(svc, res)
        if refresh in ("true", ""):
            svc.engine.refresh()
            out["forced_refresh"] = True
        return out

    def get_doc(self, index: str, doc_id: str) -> dict:
        svc = self.index(index)
        doc = svc.engine.get(doc_id)
        if doc is None:
            return {"_index": svc.name, "_id": doc_id, "found": False}
        out = {"_index": svc.name, "_id": doc_id,
               "_version": doc["_version"], "_seq_no": doc["_seq_no"],
               "_primary_term": doc["_primary_term"], "found": True}
        if svc.mapper_service.source_enabled:
            out["_source"] = doc["_source"]
        return out

    def bulk(self, ops: List[dict], default_index: Optional[str] = None,
             refresh: Optional[str] = None) -> dict:
        """`index` and `create` actions. Each document is validated on its
        own (a bad one fails its item only); the valid documents of each
        run of one index and action go to the engine in one `index_many`."""
        start = time.perf_counter()
        items: List[Optional[dict]] = []
        groups: Dict[tuple, list] = {}
        i = 0
        while i < len(ops):
            action = ops[i]
            if not isinstance(action, dict) or len(action) != 1:
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{i + 1}], expected "
                    f"a simple value for field [_index] but found "
                    f"[{action!r}]")
            (op, meta), = action.items()
            meta = meta or {}
            if op not in ("index", "create"):
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{i + 1}], expected "
                    f"one of [create, index] but found [{op}]")
            source = ops[i + 1] if i + 1 < len(ops) else None
            i += 2
            name = meta.get("_index", default_index)
            slot = len(items)
            items.append(None)
            try:
                if name is None:
                    raise IllegalArgumentError("index is missing")
                if not isinstance(source, dict):
                    raise IllegalArgumentError(
                        "the bulk request must be terminated by a newline")
                svc = self._index_or_autocreate(name)
                svc.mapper_service.parse_document(source)
                doc_id = meta.get("_id")
                if doc_id is None:
                    doc_id, op = uuid.uuid4().hex[:20], "create"
                groups.setdefault((name, op), []).append(
                    (slot, str(doc_id), source))
            except SearchEngineError as e:
                items[slot] = {op: {"_index": name, "_id": meta.get("_id"),
                                    "status": e.status, "error": e.to_dict()}}
        for (name, op), docs in groups.items():
            svc = self.indices[name]
            status = 201
            try:
                results = svc.engine.index_many(
                    [d for _, d, _ in docs], [s for _, _, s in docs],
                    op_type=op)
            except SearchEngineError as e:
                for slot, doc_id, _ in docs:
                    items[slot] = {op: {"_index": name, "_id": doc_id,
                                        "status": e.status,
                                        "error": e.to_dict()}}
                continue
            for (slot, _, _), res in zip(docs, results):
                resp = self._write_response(svc, res)
                resp["status"] = status if res.result == "created" else 200
                items[slot] = {op: resp}
        if refresh in ("true", ""):
            for name, _ in groups:
                self.indices[name].engine.refresh()
        return {"took": int((time.perf_counter() - start) * 1000),
                "errors": any("error" in next(iter(it.values()))
                              for it in items),
                "items": items}

    def refresh(self, index: str) -> dict:
        self.index(index).engine.refresh()
        return {"_shards": dict(_SHARDS_OK)}

    # --------------------------------------------------------------- search
    def _hybrid_executor(self, svc: IndexService) -> HybridExecutor:
        with self._lock:
            ex = self._hybrid.get(svc.name)
            if ex is None:
                ex = self._hybrid[svc.name] = HybridExecutor(svc, self.device)
            return ex

    def _search_rrf(self, svc: IndexService, body: dict) -> dict:
        """Reciprocal-rank fusion of the body's sub-searches through the
        index's hybrid executor (plan cache, one dispatch per leg group,
        RRF, fetch of the final window)."""
        return self._hybrid_executor(svc).submit(body)

    def search(self, index: str, body: Optional[dict]) -> dict:
        start = time.perf_counter()
        svc = self.index(index)
        rank = (body or {}).get("rank")
        if isinstance(rank, dict) and "rrf" in rank:
            return self._search_rrf(svc, body)
        ctx = SearchContext(svc.engine.acquire_searcher(), svc.mapper_service,
                            svc.store, svc.settings)
        hits = execute_search(ctx, body or {}, svc.name)
        return {"took": int((time.perf_counter() - start) * 1000),
                "timed_out": False,
                "_shards": {"total": 1, "successful": 1, "skipped": 0,
                            "failed": 0},
                "hits": hits}
