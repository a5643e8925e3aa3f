"""The index service: one index's mapping and shards (port of the shard
holding part of `elasticsearch_tpu/indices/service.py`).

An index has `index.number_of_shards` shards (1 to 1024) on the one card.
Each shard owns an `Engine` and a `VectorStoreShard`, synced at every
refresh of its engine. A document goes to shard `murmur3(routing or _id)
floorMod number_of_shards` (`cluster/routing.py`). A search reads one
combined reader whose rows are rebased by shard: shard s owns the rows
[s * SHARD_ROW_SPACE, (s + 1) * SHARD_ROW_SPACE), so a row names its shard
and its row in that shard's engine.

An index carries its aliases (alias name -> its options: `filter`,
`index_routing`, `search_routing`, `is_write_index`, `is_hidden`), its
closed flag and its dynamic settings (`settings_update`). Closing keeps
the index's host and device state as it is, so a reopened index serves
what it served before without a rebuild; only the node's routes refuse
data operations on it meanwhile.

The module also holds the node's index-name rules (port of
`IndicesService.validate_index_name`, `get`, `resolve` and
`update_aliases`): `resolve_expression` turns an index expression (none,
`_all`, a comma list, `*` patterns, aliases) into index services,
deduplicated in order, under the `ignore_unavailable`,
`allow_no_indices` and open / closed expansion options; `get_index`
resolves one name or single-index alias for a document operation; every
API that takes an expression resolves it there.

Left out, as ROADMAP.md lists: hidden indices, templates, date math in
names, and the shard-failure retry (`exclude_shards`). An expression part
in date math, an `index.hidden` setting and an `expand_wildcards` that
names hidden indices are 400s.
"""

from __future__ import annotations

import copy
import fnmatch
import re
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.cluster.routing import shard_id_for, shard_ids_for
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, IndexClosedError, IndexNotFoundError,
    InvalidIndexNameError,
)
from elasticsearch_tpu_torch.index.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.index.engine import Engine, EngineResult
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentView, ShardReader
from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

# Rebased multi-shard row space: shard s contributes rows in
# [s * SHARD_ROW_SPACE, (s+1) * SHARD_ROW_SPACE).
SHARD_ROW_SPACE = 1 << 40
MAX_SHARDS = 1024
_INDEX_NAME_RE = re.compile(r"^[^A-Z\\/*?\"<>| ,#:][^A-Z\\/*?\"<>| ,#]*$")


def validate_index_name(name: str) -> None:
    """The reference's index-name rules: not empty, `.` or `..`, no
    leading `-`, `_` or `+`, no upper case or `\\/*?"<>| ,#` (nor a
    leading `:`), at most 255 bytes."""
    if not name or name in (".", "..") or name.startswith(("-", "_", "+")) \
            or not _INDEX_NAME_RE.match(name) or len(name.encode()) > 255:
        raise InvalidIndexNameError(f"Invalid index name [{name}]",
                                    index=name)


def resolve_expression(indices: Dict[str, "IndexService"],
                       expression: Optional[str],
                       ignore_unavailable: bool = False,
                       allow_no_indices: bool = True,
                       expand_open: bool = True,
                       expand_closed: bool = False,
                       forbid_closed: bool = False) -> List["IndexService"]:
    """The indices an expression names, deduplicated in order. None or ""
    names every index; else each comma-separated part is `_all` or a `*`
    pattern over index and alias names (matching no index raises
    `IndexNotFoundError` for that part when `allow_no_indices` is false),
    a concrete index name, or an alias, which names all its indices
    (missing, it raises `IndexNotFoundError` unless `ignore_unavailable`
    drops it). Patterns take the open indices, and the closed ones with
    `expand_closed`; `expand_open=False` leaves the open ones out. With
    `forbid_closed` (data operations) a closed index in the result is an
    `IndexClosedError`, or is dropped under `ignore_unavailable`. A part
    in date math (`<...>`) is a 400."""

    def wanted(svc) -> bool:
        return expand_closed if svc.closed else expand_open

    if expression in (None, ""):
        out = {n: s for n, s in indices.items() if wanted(s)}
        return _check_closed(list(out.values()), forbid_closed,
                             ignore_unavailable)
    out: Dict[str, IndexService] = {}
    for part in expression.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("<") and part.endswith(">"):
            raise IllegalArgumentError(
                f"date math index expressions are not supported by this "
                f"build: [{part}] (ROADMAP.md queue 1 item 16)")
        if part == "_all" or "*" in part:
            pat = re.compile(".*" if part == "_all" else
                             ".*".join(map(re.escape, part.split("*"))))
            matched = [n for n, s in indices.items()
                       if pat.fullmatch(n) and wanted(s)]
            matched += [n for n, s in indices.items()
                        if (expand_closed or not s.closed)
                        and any(pat.fullmatch(a) for a in s.aliases)]
            if not matched and not allow_no_indices:
                raise IndexNotFoundError(part)
            for n in matched:
                out.setdefault(n, indices[n])
            continue
        svc = indices.get(part)
        if svc is not None:
            out.setdefault(part, svc)
            continue
        holders = [n for n, s in indices.items() if part in s.aliases]
        if not holders:
            if ignore_unavailable:
                continue
            raise IndexNotFoundError(part)
        for n in holders:
            out.setdefault(n, indices[n])
    return _check_closed(list(out.values()), forbid_closed,
                         ignore_unavailable)


def resolve_info(indices: Dict[str, "IndexService"],
                 expression: Optional[str],
                 ignore_unavailable: bool = False,
                 allow_no_indices: bool = True, expand_open: bool = True,
                 expand_closed: bool = False) -> List["IndexService"]:
    """The indices an index-info API (`GET /{index}`, `_mapping`) names,
    as the reference's REST layer resolves them: patterns over index
    names only, open and closed ones as `expand_open` / `expand_closed`
    say; a concrete part through `get_index` (a single-index alias; one
    of several indices is a 400), a closed index served. A part that
    names nothing raises as in `resolve_expression`."""
    out: Dict[str, IndexService] = {}
    for part in (expression or "_all").split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("<") and part.endswith(">"):
            resolve_expression(indices, part)   # date math: the 400
        if "*" in part or part == "_all":
            pat = "*" if part == "_all" else part
            matched = [n for n, s in indices.items()
                       if fnmatch.fnmatchcase(n, pat)
                       and (expand_closed if s.closed else expand_open)]
            if not matched and not allow_no_indices:
                raise IndexNotFoundError(part)
            for n in matched:
                out.setdefault(n, indices[n])
            continue
        try:
            svc = get_index(indices, part)
        except IndexNotFoundError:
            if ignore_unavailable:
                continue
            raise
        out.setdefault(svc.name, svc)
    return list(out.values())


def _check_closed(services: List["IndexService"], forbid: bool,
                  drop: bool) -> List["IndexService"]:
    if not forbid:
        return services
    if drop:
        return [s for s in services if not s.closed]
    for svc in services:
        check_open(svc)
    return services


def check_open(svc: "IndexService") -> "IndexService":
    """The index, or the reference's `index_closed_exception`."""
    if svc.closed:
        raise IndexClosedError(f"closed index [{svc.name}]")
    return svc


def get_index(indices: Dict[str, "IndexService"],
              name: str) -> "IndexService":
    """A concrete index, or the one index of an alias, for a document
    operation; an alias of several indices is the reference's 400."""
    svc = indices.get(name)
    if svc is not None:
        return svc
    holders = [s for s in indices.values() if name in s.aliases]
    if len(holders) > 1:
        names = ", ".join(sorted(s.name for s in holders))
        raise IllegalArgumentError(
            f"Alias [{name}] has more than one indices associated with it "
            f"[[{names}]], can't execute a single index op")
    if holders:
        return holders[0]
    raise IndexNotFoundError(name)


def index_or_alias_exists(indices: Dict[str, "IndexService"],
                          name: str) -> bool:
    return name in indices or any(name in s.aliases
                                  for s in indices.values())


def update_aliases(indices: Dict[str, "IndexService"], actions: List[dict],
                   delete_index) -> None:
    """`POST /_aliases` actions in order: `add` (with its options; a plain
    `routing` becomes both `index_routing` and `search_routing`, routing
    values as strings), `remove` (alias names may be patterns) and
    `remove_index` (`delete_index(name)`). `index` / `indices` and
    `alias` / `aliases` are interchangeable, and an index part with `*`
    names every open index it matches."""

    def targets(spec, key, plural):
        vals = spec.get(plural)
        if vals is None:
            one = spec.get(key)
            if one is None:
                raise IllegalArgumentError(f"[{key}] is required")
            vals = [one]
        elif isinstance(vals, str):
            vals = [vals]
        return [str(v) for v in vals]

    def services(spec):
        for name in targets(spec, "index", "indices"):
            yield from (resolve_expression(indices, name) if "*" in name
                        else [get_index(indices, name)])

    for action in actions:
        if "add" in action:
            spec = action["add"]
            opts = {k: v for k, v in spec.items()
                    if k not in ("index", "indices", "alias", "aliases")}
            if "routing" in opts:
                routing = opts.pop("routing")
                opts.setdefault("index_routing", str(routing))
                opts.setdefault("search_routing", str(routing))
            for rk in ("index_routing", "search_routing"):
                if rk in opts:
                    opts[rk] = str(opts[rk])
            for svc in services(spec):
                for alias in targets(spec, "alias", "aliases"):
                    svc.aliases[alias] = dict(opts)
        elif "remove" in action:
            spec = action["remove"]
            for svc in services(spec):
                for alias in targets(spec, "alias", "aliases"):
                    if "*" in alias:
                        for a in [a for a in svc.aliases
                                  if fnmatch.fnmatch(a, alias)]:
                            svc.aliases.pop(a, None)
                    else:
                        svc.aliases.pop(alias, None)
        elif "remove_index" in action:
            for name in targets(action["remove_index"], "index", "indices"):
                delete_index(name)
        else:
            raise IllegalArgumentError(
                "alias action must be add, remove, or remove_index")


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
    (engine, nlist, nprobe), with the reference's 400 errors."""
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


def validate_segments_settings(settings: Dict[str, object]) -> dict:
    """Validate + normalize the flat `index.segments.*` settings of the
    generational device corpus into `VectorStoreShard` keyword arguments,
    with the reference's 400 errors."""
    enabled = settings.get("index.segments.enabled", True)
    if not isinstance(enabled, bool):
        enabled = str(enabled).strip().lower() in ("true", "1", "yes", "on")
    out = {"segments_enabled": enabled}
    for key, attr, floor in (("index.segments.tier_size",
                              "segments_tier_size", 2),
                             ("index.segments.max_l0",
                              "segments_max_l0", 1)):
        raw = settings.get(key)
        if raw is None:
            continue
        try:
            val = int(raw)
        except (TypeError, ValueError):
            val = floor - 1
        if val < floor:
            raise IllegalArgumentError(
                f"[{key}] must be an integer >= {floor}, got [{raw}]")
        out[attr] = val
    raw = settings.get("index.segments.merge_budget_ms")
    if raw is not None:
        try:
            val = float(raw)
        except (TypeError, ValueError):
            val = -1.0
        if val <= 0:
            raise IllegalArgumentError(
                f"[index.segments.merge_budget_ms] must be a number "
                f"> 0, got [{raw}]")
        out["segments_merge_budget_ms"] = val
    return out


class IndexShardHandle:
    """One shard: its engine and its device vector store, which syncs from
    every reader the engine's refresh makes."""

    def __init__(self, shard_id: int, mapper_service: MapperService, device,
                 knn_engine: str = "tpu", knn_nlist=None, knn_nprobe="auto",
                 segments_settings: Optional[dict] = None):
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.engine = Engine(mapper_service)
        self.vector_store = VectorStoreShard(
            device=device, knn_engine=knn_engine, knn_nlist=knn_nlist,
            knn_nprobe=knn_nprobe, **(segments_settings or {}))
        self.engine.add_refresh_listener(self._sync_vectors)

    def _sync_vectors(self, reader: ShardReader) -> None:
        self.vector_store.sync(reader, self.mapper_service.vector_fields())


class IndexService:
    """One index: mapping, settings and `number_of_shards` shards."""

    def __init__(self, name: str, mapping: Optional[dict], device,
                 settings: Optional[Dict[str, object]] = None):
        self.name = name
        self.settings = dict(settings or {})   # flat `index.*` settings
        self.uuid = uuid.uuid4().hex[:22]
        self.creation_date = int(time.time() * 1000)
        self.num_shards = int(self.settings.get("index.number_of_shards", 1))
        if not 1 <= self.num_shards <= MAX_SHARDS:
            raise IllegalArgumentError(
                f"index [{name}]: number_of_shards must be in "
                f"[1, {MAX_SHARDS}], got {self.num_shards}")
        if str(self.settings.get("index.hidden", "false")).lower() != "false":
            raise IllegalArgumentError(
                "index setting [index.hidden] is not supported by this "
                "build: hidden indices are not ported (ROADMAP.md queue 1 "
                "item 16)")
        knn_engine, knn_nlist, knn_nprobe = validate_knn_settings(
            self.settings)
        # the generational device corpus's knobs (`segments/`)
        segments_settings = validate_segments_settings(self.settings)
        # the index's analyzers: the built-ins and its `index.analysis.*`
        self.mapper_service = MapperService(
            mapping, registry=AnalysisRegistry.from_index_settings(
                self.settings))
        nested_limit = self.settings.get(
            "index.mapping.nested_objects.limit",
            self.settings.get("mapping.nested_objects.limit"))
        if nested_limit is not None:
            self.mapper_service.nested_objects_limit = int(nested_limit)
        self.shards: List[IndexShardHandle] = [
            IndexShardHandle(s, self.mapper_service, device,
                             knn_engine=knn_engine, knn_nlist=knn_nlist,
                             knn_nprobe=knn_nprobe,
                             segments_settings=segments_settings)
            for s in range(self.num_shards)]
        self._combined = None    # (shard readers, their combined reader)
        # the index's scatter-gather kNN store over its shards (the node's
        # `_MultiShardVectorStore`, set when the node creates the index)
        self.vector_store = None
        self.aliases: Dict[str, dict] = {}
        self.closed = False

    @property
    def num_replicas(self) -> int:
        """`index.number_of_replicas`, read live (a settings update
        changes it)."""
        return int(self.settings.get("index.number_of_replicas", 1))

    def settings_update(self, updates: Dict[str, object]) -> None:
        """Dynamic settings (flat `index.*` keys) merged into the index's;
        `null` resets a key to its default. `index.number_of_shards` and
        `index.uuid` are static, and the removed translog retention
        settings are refused, as in the reference. The dict is updated in
        place: every reader of `settings` sees the new values."""
        for key in updates:
            if key.replace("index.", "", 1).startswith(
                    "translog.retention."):
                raise IllegalArgumentError(
                    f"Translog retention setting [{key}] is no longer "
                    f"supported; history is retained by soft deletes")
            if key in ("index.number_of_shards", "index.uuid"):
                raise IllegalArgumentError(
                    f"setting [{key}] is not dynamically updateable")
        for k, v in updates.items():
            if v is None:
                self.settings.pop(k, None)
            else:
                self.settings[k] = v

    def _single(self) -> IndexShardHandle:
        if self.num_shards != 1:
            raise ValueError(
                f"index [{self.name}] has {self.num_shards} shards; "
                f"address one through [shards]")
        return self.shards[0]

    @property
    def engine(self) -> Engine:
        """The engine of a single-shard index."""
        return self._single().engine

    @property
    def store(self) -> VectorStoreShard:
        """The vector store of a single-shard index."""
        return self._single().vector_store

    def route(self, doc_id: str,
              routing: Optional[str] = None) -> IndexShardHandle:
        key = routing if routing is not None else doc_id
        return self.shards[shard_id_for(key, self.num_shards)]

    def index_many(self, ids: List[str], sources=None,
                   vectors=None, routings=None) -> List[EngineResult]:
        """`Engine.index_many` over the shards: each document goes to the
        shard its routing value (else its `_id`) hashes to, as `_bulk`
        sends it, with its rows of `vectors` ([n, dims] arrays). Results
        come back in the batch's order."""
        ids = list(ids)
        sources = None if sources is None else list(sources)
        target = shard_ids_for(ids if routings is None else [
            i if r is None else r for i, r in zip(ids, routings)],
            self.num_shards)
        out: List[Optional[EngineResult]] = [None] * len(ids)
        for s in np.unique(target).tolist():
            pos = np.nonzero(target == s)[0]
            whole = len(pos) == len(ids)
            at = pos.tolist()
            res = self.shards[s].engine.index_many(
                ids if whole else [ids[i] for i in at],
                sources=sources if sources is None or whole
                else [sources[i] for i in at],
                vectors=None if vectors is None else {
                    f: block if whole else block[pos]
                    for f, block in vectors.items()},
                routings=None if routings is None
                else [routings[i] for i in at])
            for i, r in zip(at, res):
                out[i] = r
        return out

    def refresh(self) -> None:
        for s in self.shards:
            s.engine.refresh()

    def force_merge(self) -> None:
        """`POST /{index}/_forcemerge`: each shard's engine compacts its
        segments into one (`Engine.merge`), and its store rebuilds the
        re-based rows."""
        for s in self.shards:
            s.engine.merge()

    def close(self) -> None:
        """Let go of the index's device memory: every shard store's corpora,
        generations (their merge threads stopped first), snapshots and
        batchers, and the memoized combined reader."""
        for s in self.shards:
            s.vector_store.close()
        self._combined = None

    def doc_count(self) -> int:
        return sum(s.engine.acquire_searcher().num_docs for s in self.shards)

    def combined_reader(self) -> ShardReader:
        """A reader over every shard, each shard's segments copied at
        `base + shard_id * SHARD_ROW_SPACE`. Memoized on the shards'
        readers: searches between refreshes share one reader (and the
        per-reader caches on it), and so one `gen`, which keys the node
        query cache until a refresh changes a shard's reader. `shard_readers` names the shard readers
        it was made from, so a store serves each shard from the snapshot
        the search's filters ran on."""
        readers = tuple(s.engine.acquire_searcher() for s in self.shards)
        cached = self._combined
        if cached is not None and len(cached[0]) == len(readers) and all(
                a is b for a, b in zip(cached[0], readers)):
            return cached[1]
        views = []
        for s, reader in zip(self.shards, readers):
            offset = s.shard_id * SHARD_ROW_SPACE
            for view in reader.views:
                if not offset:
                    views.append(view)
                    continue
                seg = copy.copy(view.segment)
                seg.base = view.segment.base + offset
                v2 = SegmentView.__new__(SegmentView)
                v2.segment, v2.live, v2.all_live = seg, view.live, view.all_live
                views.append(v2)
        combined = ShardReader(views)
        combined.shard_readers = readers
        self._combined = (readers, combined)
        return combined

    def shard_of_row(self, row: int) -> IndexShardHandle:
        return self.shards[int(row) // SHARD_ROW_SPACE]
