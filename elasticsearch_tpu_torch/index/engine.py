"""In-memory shard engine (port of the kNN and filter slice of
`elasticsearch_tpu/index/engine.py`).

Indexing appends to a buffer; `refresh` seals the buffer into an immutable
segment, tombstones replaced rows, and hands the new reader to refresh
listeners (the vector store syncs there). Vectors travel as numpy blocks:
`index_many` takes a whole batch, optionally with its vectors as one
[n, dims] array per field, which is how a million-document shard loads.
Keyword, numeric, boolean, date, ip, geo-point and range values are
parsed from each `_source` (objects by path, new fields mapped
dynamically into the index's shared mapping); the seal builds their
postings and doc-values columns with numpy. Text values
are analyzed (`TextFieldMapper.analyze_positions`); their tokens enter
the buffer as integer codes of a per-field vocabulary with their
positions, and the seal builds the positional postings and the field
lengths from those arrays. Feature maps (`rank_features`, `sparse_vector`)
enter the buffer likewise, as integer codes of a per-field feature
vocabulary with their f64 weights, and seal into a `FeatureMapColumn`
without walking a dict. A document's
`_source` is kept as it was sent; vectors given as arrays (a numpy row in
a source, or `vectors=` / `token_vectors=`) have no JSON to keep and are
rendered from their blocks. A document's routing value, when it has one,
is kept beside its `_id`, and its seq_no beside it too; its `_version` and
`_primary_term` seal as doc values of its row, as the reference's engine
keeps them, so a hit reads them from a sealed row.

Writes are versioned as in the reference: each takes a seq_no, a version
(internal, or the caller's `external` / `external_gte` one) and is checked
against the version map first (`create` on a live id, `if_seq_no` /
`if_primary_term`, `version`). `delete` tombstones the live row and keeps a
deleted entry in the version map, so a later write of the id is `created`
at version 1. A realtime GET reads a sealed row from its segment directly.

`merge` compacts the sealed segments into one without the deleted docs
(`POST /_forcemerge`): rows are new, and the vector store rebuilds.

This slice has no translog and no flush: nothing survives the process.
"""

from __future__ import annotations

import bisect
import itertools
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    DocumentMissingError, IllegalArgumentError, MapperParsingError,
    SearchEngineError, VersionConflictError,
)
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (
    DocValuesColumn, FeatureMapColumn, FieldPostings, Segment, SegmentView,
    ShardReader,
)

PRIMARY_TERM = 1


class EngineResult(NamedTuple):
    doc_id: str
    seq_no: int
    primary_term: int
    version: int
    result: str    # "created" | "updated" | "deleted"
    row: int


class _VersionValue(NamedTuple):
    version: int
    seq_no: int
    row: int            # -1 once deleted
    deleted: bool = False


_EXTERNAL = ("external", "external_gt", "external_gte")


class _Buffer:
    """The indexing buffer of the next segment."""

    def __init__(self, seg_id: int, base: int):
        self.seg_id = seg_id
        self.base = base
        self.ids: List[str] = []
        self.sources: List[Optional[dict]] = []
        self.routings: List[Optional[str]] = []
        # each row's seq_no and version
        self.seq_nos: List[int] = []
        self.versions: List[int] = []
        # field -> [(local rows [m], vectors [m, d])]
        self.blocks: Dict[str, list] = {}
        # field -> [(local rows [m], tokens [T, d], counts [m] >= 1)]
        self.token_blocks: Dict[str, list] = {}
        # field -> ([local doc a term], [term]) and ([local doc], [value])
        self.terms: Dict[str, Tuple[list, list]] = {}
        self.doc_values: Dict[str, Tuple[list, list]] = {}
        # text field -> its vocabulary (term -> code), its token arrays
        # [(local docs, codes, positions)] and its [(local docs, lengths)]
        self.vocab: Dict[str, Dict[str, int]] = {}
        self.text: Dict[str, list] = {}
        self.lengths: Dict[str, list] = {}
        # feature-map field -> its feature vocabulary (name -> code) and
        # its arrays [(local docs, features a doc, codes, f64 weights)]
        self.feature_vocab: Dict[str, Dict[str, int]] = {}
        self.features: Dict[str, list] = {}

    def add_text(self, start: int, text: Dict[str, tuple]) -> None:
        """Append a batch's text fields: field -> (batch positions of the
        docs, their term lists, their position lists, their lengths)."""
        for field, (pos, terms, positions, lengths) in text.items():
            vocab = self.vocab.setdefault(field, {})
            counts = np.fromiter(map(len, terms), dtype=np.int64,
                                 count=len(terms))
            docs = np.repeat(np.asarray(pos, dtype=np.int64) + start, counts)
            flat = list(itertools.chain.from_iterable(terms))
            for t in dict.fromkeys(flat):       # the batch's words, once
                vocab.setdefault(t, len(vocab))
            codes = np.fromiter(map(vocab.__getitem__, flat), dtype=np.int32,
                                count=len(flat))
            flat_pos = np.fromiter(itertools.chain.from_iterable(positions),
                                   dtype=np.int32, count=len(flat))
            self.text.setdefault(field, []).append((docs, codes, flat_pos))
            self.lengths.setdefault(field, []).append(
                (np.asarray(pos, dtype=np.int64) + start,
                 np.asarray(lengths, dtype=np.int32)))

    def add_features(self, start: int, features: Dict[str, tuple]) -> None:
        """Append a batch's feature maps: field -> (batch positions of the
        docs, their key lists, their weight lists)."""
        for field, (pos, keys, weights) in features.items():
            vocab = self.feature_vocab.setdefault(field, {})
            counts = np.fromiter(map(len, keys), dtype=np.int64,
                                 count=len(keys))
            flat = list(itertools.chain.from_iterable(keys))
            for t in dict.fromkeys(flat):       # the batch's features, once
                vocab.setdefault(t, len(vocab))
            codes = np.fromiter(map(vocab.__getitem__, flat), dtype=np.int32,
                                count=len(flat))
            w = np.fromiter(itertools.chain.from_iterable(weights),
                            dtype=np.float64, count=len(flat))
            self.features.setdefault(field, []).append(
                (np.asarray(pos, dtype=np.int64) + start, counts, codes, w))

    def add(self, ids, sources, routings, stamps, vectors, tokens, terms,
            doc_values) -> int:
        """Append a batch. `stamps` holds each document's (seq_no,
        version); `terms` and `doc_values` map a field to (batch
        positions, values), one entry a term or a doc value."""
        start = len(self.ids)
        self.ids.extend(ids)
        self.sources.extend(sources)
        self.routings.extend(routings)
        self.seq_nos.extend(s for s, _ in stamps)
        self.versions.extend(v for _, v in stamps)
        locals_ = np.arange(start, start + len(ids), dtype=np.int64)
        for field, (mask, block) in vectors.items():
            self.blocks.setdefault(field, []).append(
                (locals_ if mask is None else locals_[mask], block))
        for field, (mask, toks, counts) in tokens.items():
            self.token_blocks.setdefault(field, []).append(
                (locals_[mask], toks, counts))
        for into, cols in ((self.terms, terms),
                           (self.doc_values, doc_values)):
            for field, (pos, values) in cols.items():
                docs, vals = into.setdefault(field, ([], []))
                docs.extend(p + start for p in pos)
                vals.extend(values)
        return start

    def source(self, local: int) -> dict:
        src = dict(self.sources[local] or {})
        for field, parts in self.blocks.items():
            if field in src:
                continue
            for rows, block in parts:
                hit = np.nonzero(rows == local)[0]
                if len(hit):
                    src[field] = block[hit[0]].tolist()
        for field, parts in self.token_blocks.items():
            if field in src:
                continue
            for rows, toks, counts in parts:
                hit = np.nonzero(rows == local)[0]
                if len(hit):
                    lo = int(counts[:hit[0]].sum())
                    src[field] = toks[lo:lo + int(counts[hit[0]])].tolist()
        return src

    def _seal_tokens(self, n: int) -> Dict[str, tuple]:
        """Per field: the ragged token matrix in local-doc order with its
        offsets and presence (parts arrive in ascending local rows)."""
        out = {}
        for field, parts in self.token_blocks.items():
            counts = np.zeros(n, dtype=np.int64)
            for rows, _toks, cnt in parts:
                counts[rows] = cnt
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            toks = (np.ascontiguousarray(parts[0][1], dtype=np.float32)
                    if len(parts) == 1 else
                    np.concatenate([t for _r, t, _c in parts]))
            out[field] = (toks, offsets, counts > 0)
        return out

    def _seal_features(self, n: int, field: str,
                       parts: list) -> FeatureMapColumn:
        """One feature-map field's column: the batches' code and weight
        arrays in local-doc order (parts arrive in ascending local docs),
        and its docs holding a list of maps as plain values."""
        counts = np.zeros(n, dtype=np.int64)
        present = np.zeros(n, dtype=bool)
        for docs, cnt, _codes, _w in parts:
            counts[docs] = cnt
            present[docs] = True
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        other = {}
        if field in self.doc_values:
            docs, vals = self.doc_values[field]
            other = dict(zip(docs, vals))
            present[docs] = True
        return FeatureMapColumn(
            np.asarray(list(self.feature_vocab[field]), dtype=str), offsets,
            np.concatenate([p[2] for p in parts]),
            np.concatenate([p[3] for p in parts]), present, other)

    def seal(self, dims: Dict[str, int]) -> Segment:
        n = len(self.ids)
        vectors = {}
        for field, parts in self.blocks.items():
            if len(parts) == 1 and len(parts[0][0]) == n:
                mat = np.ascontiguousarray(parts[0][1], dtype=np.float32)
                present = np.ones(n, dtype=bool)
            else:
                mat = np.zeros((n, dims[field]), dtype=np.float32)
                present = np.zeros(n, dtype=bool)
                for rows, block in parts:
                    mat[rows] = block
                    present[rows] = True
            vectors[field] = (mat, present)
        postings = {f: FieldPostings.build(np.asarray(docs), terms)
                    for f, (docs, terms) in self.terms.items()}
        for field, parts in self.text.items():
            postings[field] = FieldPostings.build_text(
                *(np.concatenate([p[i] for p in parts]) for i in range(2)),
                list(self.vocab[field]),
                np.concatenate([p[2] for p in parts]))
        field_lengths = {}
        for field, parts in self.lengths.items():
            fl = np.zeros(n, dtype=np.int32)
            for docs, lengths in parts:
                fl[docs] = lengths
            field_lengths[field] = fl
        doc_values = {f: DocValuesColumn.build(n, np.asarray(docs), vals)
                      for f, (docs, vals) in self.doc_values.items()
                      if f not in self.features}
        for field, parts in self.features.items():
            doc_values[field] = self._seal_features(n, field, parts)
        doc_values["_version"] = DocValuesColumn.of_ints(
            np.asarray(self.versions, dtype=np.int64))
        doc_values["_primary_term"] = DocValuesColumn.of_ints(
            np.full(n, PRIMARY_TERM, dtype=np.int64))
        routings = (self.routings if any(r is not None for r in self.routings)
                    else None)
        return Segment(self.seg_id, self.base, self.ids, self.sources, vectors,
                       self._seal_tokens(n), postings, doc_values, routings,
                       field_lengths,
                       seq_nos=np.asarray(self.seq_nos, dtype=np.int64))


class Engine:
    def __init__(self, mapper_service: MapperService):
        self.mapper_service = mapper_service
        self._lock = threading.Lock()
        self.segments: List[Segment] = []
        self._seg_bases: List[int] = []           # each segment's base row
        self.deleted_rows: Dict[int, set] = {}    # seg_id -> local rows
        self.version_map: Dict[str, _VersionValue] = {}
        self._next_seq_no = 0
        self._next_row = 0
        self._next_seg_id = 0
        self._buffer: Optional[_Buffer] = None
        # an empty point-in-time view until the first refresh, as the
        # reference's engine opens with one: writes stay unsearchable
        self._reader = ShardReader([])
        self._refresh_listeners: List[Callable[[ShardReader], None]] = []

    # ---------------------------------------------------------------- writes
    def index(self, doc_id: str, source: dict, op_type: str = "index",
              routing: Optional[str] = None,
              if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              version: Optional[int] = None,
              version_type: str = "internal") -> EngineResult:
        """One document, its conflicts checked as the reference checks
        them (`_check_conflicts`); a conflict raises. A document that
        fails to parse takes its seq_no (the reference's engine assigns it
        before it parses) unless it conflicts, which raises first."""
        try:
            res = self.index_many(
                [doc_id], [source], op_type=op_type, routings=[routing],
                if_seq_no=if_seq_no, if_primary_term=if_primary_term,
                version=version, version_type=version_type)[0]
        except SearchEngineError:
            with self._lock:
                self._check_conflicts(
                    doc_id, self.version_map.get(doc_id), version,
                    version_type, if_seq_no, if_primary_term, op_type)
            self.fail_seq_no()
            raise
        if isinstance(res, SearchEngineError):
            raise res
        return res

    def index_many(self, ids: List[str], sources: Optional[List[dict]] = None,
                   vectors: Optional[Dict[str, np.ndarray]] = None,
                   token_vectors: Optional[Dict[str, tuple]] = None,
                   op_type: str = "index",
                   routings: Optional[List[Optional[str]]] = None,
                   if_seq_no: Optional[int] = None,
                   if_primary_term: Optional[int] = None,
                   version: Optional[int] = None,
                   version_type: str = "internal") -> list:
        """Index a batch. `sources[i]` is document i's `_source` (dense_vector
        values may be lists or numpy rows, rank_vectors values lists of
        token vectors); `vectors` may instead supply a field's values for
        the whole batch as one [n, dims] array, and `token_vectors` a
        rank_vectors field's as (tokens [T, dims], counts [n]): document i
        owns the next counts[i] rows, and a count of 0 leaves the document
        without the field. `routings[i]` is document i's routing value (or
        None). The batch is validated before any document is applied.

        Each document's version conflicts are checked in the batch's order
        under the engine lock (`create` on a live id, and the conditional
        parameters, which apply to every document of the batch): a
        document that conflicts is not applied and takes no seq_no, and
        its place in the returned list holds its `VersionConflictError`;
        every other place holds its `EngineResult`."""
        n = len(ids)
        sources = [None] * n if sources is None else list(sources)
        routings = [None] * n if routings is None else list(routings)
        if len(sources) != n or len(routings) != n:
            raise ValueError("ids, sources and routings differ in length")
        if op_type == "create" and version_type != "internal":
            raise IllegalArgumentError(
                "create operations only support internal versioning. use "
                "index instead")
        mappers = self.mapper_service.vector_fields()
        token_mappers = self.mapper_service.token_fields()
        token_columns = {f: self._token_column(f, token_mappers, value, n)
                         for f, value in (token_vectors or {}).items()}
        blocks = {}
        for field, block in (vectors or {}).items():
            mapper = mappers.get(field)
            if mapper is None:
                raise MapperParsingError(
                    f"[{field}] is not a mapped dense_vector field")
            block = np.ascontiguousarray(block, dtype=np.float32)
            if block.shape != (n, mapper.dims):
                raise MapperParsingError(
                    f"[{field}] vector block has shape {block.shape}, "
                    f"mapping requires [{n}, {mapper.dims}]")
            if not np.isfinite(block).all():
                raise MapperParsingError(
                    f"[{field}] vector contains non-finite values")
            blocks[field] = block
        parsed = [None if src is None
                  else self.mapper_service.parse_document(src)
                  for src in sources]
        checked = (op_type == "create" or version is not None
                   or if_seq_no is not None or if_primary_term is not None
                   or version_type != "internal")
        with self._lock:
            out: list = [None] * n
            keep = list(range(n))
            if checked:
                # the batch's own earlier documents count, in order
                seen: Dict[str, _VersionValue] = {}
                keep = []
                for i, doc_id in enumerate(ids):
                    existing = seen.get(doc_id, self.version_map.get(doc_id))
                    try:
                        self._check_conflicts(
                            doc_id, existing, version, version_type,
                            if_seq_no, if_primary_term, op_type)
                    except VersionConflictError as e:
                        out[i] = e
                        continue
                    keep.append(i)
                    seen[doc_id] = _VersionValue(
                        self._new_version(existing, version, version_type),
                        -1, -1)
            if not keep:
                return out
            whole = len(keep) == n
            ids_k = list(ids) if whole else [ids[i] for i in keep]
            columns = {f: (None, b if whole else b[keep])
                       for f, b in blocks.items()}
            tokens = token_columns if whole else {
                f: self._token_subset(col, keep, n)
                for f, col in token_columns.items()}
            # each document's (seq_no, version) before it is appended, its
            # row keeps both; an id repeated in the batch versions on its
            # earlier copy
            stamps = []
            stamped: Dict[str, _VersionValue] = {}
            for j, i in enumerate(keep):
                existing = stamped.get(ids[i], self.version_map.get(ids[i]))
                stamp = (self._next_seq_no + j,
                         self._new_version(existing, version, version_type))
                stamped[ids[i]] = _VersionValue(stamp[1], stamp[0], -1)
                stamps.append(stamp)
            start = self._append(
                ids_k, [sources[i] for i in keep] if not whole else sources,
                [routings[i] for i in keep] if not whole else routings,
                stamps, [parsed[i] for i in keep] if not whole else parsed,
                columns, tokens, mappers, token_mappers)
            for j, i in enumerate(keep):
                doc_id = ids[i]
                row = self._buffer.base + start + j
                existing = self.version_map.get(doc_id)
                live = existing is not None and not existing.deleted
                if live:
                    self._tombstone(existing.row)
                seq_no, new_version = stamps[j]
                self._next_seq_no += 1
                self.version_map[doc_id] = _VersionValue(new_version, seq_no,
                                                         row)
                out[i] = EngineResult(
                    doc_id, seq_no, PRIMARY_TERM, new_version,
                    "updated" if live else "created", row)
            return out

    @staticmethod
    def _new_version(existing: Optional[_VersionValue], version,
                     version_type: str) -> int:
        """The version a write gives its document: the external one, else
        one past a live document's (1 for a new or deleted id)."""
        if version_type in _EXTERNAL:
            return version
        return 1 if existing is None or existing.deleted \
            else existing.version + 1

    @staticmethod
    def _token_subset(col: tuple, keep: List[int], n: int) -> tuple:
        """A rank_vectors column (mask, tokens, counts) cut to the batch
        positions `keep`."""
        mask, toks, counts = col
        full = np.zeros(n, dtype=np.int64)
        full[mask] = counts
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(full, out=offsets[1:])
        kept = np.asarray(keep, dtype=np.int64)
        sub = full[kept]
        rows = (np.concatenate([np.arange(offsets[i], offsets[i + 1])
                                for i in kept]) if len(kept)
                else np.zeros(0, dtype=np.int64))
        return sub > 0, toks[rows], sub[sub > 0]

    def _append(self, ids, sources, routings, stamps, parsed, columns,
                token_columns, mappers, token_mappers) -> int:
        """Append validated documents to the buffer (caller holds the
        lock); returns the first one's local row."""
        if self._buffer is None:
            self._buffer = _Buffer(self._next_seg_id, self._next_row)
            self._next_seg_id += 1
        start = self._fill(self._buffer, ids, sources, routings, stamps,
                           parsed, columns, token_columns, mappers,
                           token_mappers)
        self._next_row += len(ids)
        return start

    @staticmethod
    def _fill(buf: _Buffer, ids, sources, routings, stamps, parsed, columns,
              token_columns, mappers, token_mappers) -> int:
        """Append documents to `buf`: their parsed terms, doc values, text
        and feature maps, and their vectors (from `columns` /
        `token_columns` where given, else from the parsed sources)."""
        n = len(ids)
        stored = []
        per_field: Dict[str, list] = {
            f: [] for f in (*mappers, *token_mappers)
            if f not in columns and f not in token_columns}
        terms: Dict[str, Tuple[list, list]] = {}
        doc_values: Dict[str, Tuple[list, list]] = {}
        text: Dict[str, Tuple[list, list, list, list]] = {}
        features: Dict[str, Tuple[list, list, list]] = {}
        for i, (src, doc) in enumerate(zip(sources, parsed)):
            if src is None:
                stored.append(None)
                continue
            for field, vec in doc.vectors.items():
                if field in per_field:
                    per_field[field].append((i, vec))
            doc_terms = dict(doc.terms)
            for field, length in doc.field_lengths.items():
                pos, ts, ps, lens = text.setdefault(field, ([], [], [], []))
                pos.append(i)
                ts.append(doc_terms.pop(field, []))
                ps.append(doc.term_positions[field])
                lens.append(length)
            for field, (keys, weights) in doc.features.items():
                pos, ks, ws = features.setdefault(field, ([], [], []))
                pos.append(i)
                ks.append(keys)
                ws.append(weights)
            for field, ts in doc_terms.items():
                pos, vals = terms.setdefault(field, ([], []))
                pos.extend([i] * len(ts))
                vals.extend(ts)
            for field, dv in doc.doc_values.items():
                pos, vals = doc_values.setdefault(field, ([], []))
                pos.append(i)
                vals.append(dv)
            # the source as sent; a vector given as an array has no JSON
            # form, and renders from its block
            stored.append({k: v for k, v in src.items()
                           if not (isinstance(v, np.ndarray)
                                   and (k in mappers or k in token_mappers))})
        for field, items in per_field.items():
            if not items:
                continue
            mask = np.zeros(n, dtype=bool)
            mask[[i for i, _ in items]] = True
            if field in token_mappers:
                token_columns[field] = (
                    mask, np.concatenate([v for _, v in items]),
                    np.asarray([len(v) for _, v in items], dtype=np.int64))
            else:
                columns[field] = (mask, np.stack([v for _, v in items]))
        start = buf.add(list(ids), stored, routings, stamps, columns,
                        token_columns, terms, doc_values)
        buf.add_text(start, text)
        buf.add_features(start, features)
        return start

    def delete(self, doc_id: str, if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None,
               version: Optional[int] = None,
               version_type: str = "internal") -> EngineResult:
        """Tombstone the document's live row and record it deleted in the
        version map under a new seq_no; a missing or deleted id raises
        `DocumentMissingError`."""
        with self._lock:
            existing = self.version_map.get(doc_id)
            if existing is None or existing.deleted:
                raise DocumentMissingError(f"[{doc_id}]: document missing")
            self._check_conflicts(doc_id, existing, version, version_type,
                                  if_seq_no, if_primary_term, "delete")
            seq_no = self._next_seq_no
            self._next_seq_no += 1
            new_version = (existing.version + 1 if version_type == "internal"
                           else version) or 1
            self._tombstone(existing.row)
            self.version_map[doc_id] = _VersionValue(new_version, seq_no, -1,
                                                     True)
            return EngineResult(doc_id, seq_no, PRIMARY_TERM, new_version,
                                "deleted", -1)

    @staticmethod
    def _check_conflicts(doc_id, existing, version, version_type, if_seq_no,
                         if_primary_term, op_type) -> None:
        """The reference's conflict rules: `create` on a live id, the
        `if_seq_no` / `if_primary_term` pair, an internal `version`, and the
        `external` / `external_gte` version types (a missing document
        compares as -1)."""
        live = existing is not None and not existing.deleted
        if op_type == "create" and live:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, document already exists "
                f"(current version [{existing.version}])")
        if if_seq_no is not None or if_primary_term is not None:
            if not live:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, document does not exist")
            if (if_seq_no is not None and existing.seq_no != if_seq_no) or \
                    (if_primary_term is not None
                     and PRIMARY_TERM != if_primary_term):
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, required seqNo "
                    f"[{if_seq_no}], primary term [{if_primary_term}], "
                    f"current document has seqNo [{existing.seq_no}] and "
                    f"primary term [{PRIMARY_TERM}]")
        if version_type in _EXTERNAL:
            if version is None:
                raise IllegalArgumentError(
                    f"[{doc_id}]: external version type requires an "
                    f"explicit version")
            current = existing.version if live else -1
            # external wants strictly greater; external_gte allows equal
            if (version < current) if version_type == "external_gte" \
                    else (version <= current):
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, current version "
                    f"[{current}] is higher or equal to the one provided "
                    f"[{version}]")
        elif version is not None and version_type == "internal":
            current = existing.version if live else None
            if current != version:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, current version "
                    f"[{current}] is different than the one provided "
                    f"[{version}]")

    def fail_seq_no(self) -> int:
        """Take one seq_no and apply nothing: a document that fails to
        parse after the primary gave it its seq_no, as in the reference
        (its engine assigns the seq_no before it parses)."""
        with self._lock:
            seq_no = self._next_seq_no
            self._next_seq_no += 1
            return seq_no

    @staticmethod
    def _token_column(field: str, token_mappers, value, n: int) -> tuple:
        """Validate one rank_vectors field given for a whole batch as
        (tokens [T, dims], counts [n]); returns (mask of the documents that
        hold it, their tokens, their counts)."""
        mapper = token_mappers.get(field)
        if mapper is None:
            raise MapperParsingError(
                f"[{field}] is not a mapped rank_vectors field")
        tokens, counts = value
        counts = np.asarray(counts)
        if counts.shape != (n,) or counts.dtype.kind not in "iu" \
                or (counts < 0).any():
            raise MapperParsingError(
                f"[{field}] token counts must be {n} integers >= 0")
        counts = counts.astype(np.int64)
        tokens = np.ascontiguousarray(tokens, dtype=np.float32)
        if tokens.shape != (int(counts.sum()), mapper.dims):
            raise MapperParsingError(
                f"[{field}] token block has shape {tokens.shape}, counts "
                f"require [{int(counts.sum())}, {mapper.dims}]")
        if not np.isfinite(tokens).all():
            raise MapperParsingError(
                f"[{field}] rank_vectors contains non-finite values")
        mask = counts > 0
        return mask, tokens, counts[mask]

    def _sealed(self, row: int) -> Optional[Tuple[Segment, int]]:
        """The sealed segment holding a row and the row's local doc, found
        by a binary search over the segments' bases."""
        i = bisect.bisect_right(self._seg_bases, row) - 1
        if i >= 0:
            seg = self.segments[i]
            if row < seg.base + seg.num_docs:
                return seg, row - seg.base
        return None

    def _tombstone(self, row: int) -> None:
        hit = self._sealed(row)
        if hit is not None:
            self.deleted_rows.setdefault(hit[0].seg_id, set()).add(hit[1])
            return
        buf = self._buffer
        self.deleted_rows.setdefault(buf.seg_id, set()).add(row - buf.base)

    # ----------------------------------------------------------------- reads
    def get(self, doc_id: str, realtime: bool = True) -> Optional[dict]:
        """The latest version of a live document: sealed or still buffered
        when `realtime`, else only as the last refresh sealed it (None
        while its latest write is unrefreshed)."""
        with self._lock:
            vv = self.version_map.get(doc_id)
            if vv is None or vv.deleted:
                return None
            buf = self._buffer
            if buf is not None and vv.row >= buf.base:
                if not realtime:
                    return None
                src = buf.source(vv.row - buf.base)
                routing = buf.routings[vv.row - buf.base]
            else:
                seg, local = self._sealed(vv.row)
                src = seg.source(local)
                routing = (None if seg.routings is None
                           else seg.routings[local])
            out = {"_version": vv.version, "_seq_no": vv.seq_no,
                   "_primary_term": PRIMARY_TERM, "_source": src}
            if routing is not None:
                out["_routing"] = routing
            return out

    def refresh(self) -> ShardReader:
        """Seal the indexing buffer; make recent writes searchable."""
        with self._lock:
            self._seal_buffer()
            views = [SegmentView(seg, self.deleted_rows.get(seg.seg_id))
                     for seg in self.segments]
            self._reader = ShardReader(views)
            for listener in self._refresh_listeners:
                listener(self._reader)
            return self._reader

    def _seal_buffer(self) -> None:
        """Seal the indexing buffer into a segment (caller holds the
        lock)."""
        if self._buffer is not None and self._buffer.ids:
            dims = {f: m.dims for f, m in
                    self.mapper_service.vector_fields().items()}
            self.segments.append(self._buffer.seal(dims))
            self._seg_bases.append(self._buffer.base)
        self._buffer = None

    def merge(self) -> ShardReader:
        """Compact every sealed segment into one, dropping deleted docs
        (a Lucene force merge), and refresh. Live docs keep their order,
        seq_nos, versions, routings, sources and vectors (the segments'
        own f32 rows, also of vectors given as arrays); their rows are
        new, past every earlier row, so the vector store meets the new
        reader as a segment rewrite and rebuilds."""
        reader = self.refresh()
        with self._lock:
            self._seal_buffer()     # writes since that refresh
            if len(self.segments) <= 1 \
                    and not any(self.deleted_rows.values()):
                return reader
            self._merge_segments()
        return self.refresh()

    def _merge_segments(self) -> None:
        """(caller holds the lock, the buffer is sealed)"""
        mappers = self.mapper_service.vector_fields()
        token_mappers = self.mapper_service.token_fields()
        buf = _Buffer(self._next_seg_id, self._next_row)
        self._next_seg_id += 1
        new_rows: Dict[str, int] = {}
        for seg in self.segments:
            dead = self.deleted_rows.get(seg.seg_id, ())
            keep = [local for local in range(seg.num_docs)
                    if local not in dead
                    and self._is_current(seg.ids[local], seg.base + local)]
            if not keep:
                continue
            at = np.asarray(keep, dtype=np.int64)
            ids = [seg.ids[i] for i in keep]
            sources = [seg.sources[i] for i in keep]
            versions = seg.doc_values["_version"].values
            stamps = [(int(seg.seq_nos[i]), int(versions[i]))
                      for i in keep]
            routings = ([None] * len(keep) if seg.routings is None
                        else [seg.routings[i] for i in keep])
            # every vector and token field from the segment's own rows, so
            # array-given ones (no JSON in the source) come through too
            columns = {}
            for field, (mat, present) in seg.vectors.items():
                mask = present[at]
                if mask.any():
                    columns[field] = (mask, mat[at[mask]])
            tokens = {}
            for field, (toks, offsets, present) in seg.tokens.items():
                mask = present[at]
                if mask.any():
                    docs = at[mask]
                    counts = offsets[docs + 1] - offsets[docs]
                    rows = np.concatenate([np.arange(offsets[d],
                                                     offsets[d + 1])
                                           for d in docs])
                    tokens[field] = (mask, toks[rows], counts)
            parsed = [None if src is None
                      else self.mapper_service.parse_document(src)
                      for src in sources]
            start = self._fill(buf, ids, sources, routings, stamps, parsed,
                               columns, tokens, mappers, token_mappers)
            for j, doc_id in enumerate(ids):
                new_rows[doc_id] = buf.base + start + j
        self._next_row = buf.base + len(buf.ids)
        self.segments, self._seg_bases = [], []
        self._buffer = buf
        self._seal_buffer()
        self.deleted_rows = {}
        for doc_id, row in new_rows.items():
            self.version_map[doc_id] = \
                self.version_map[doc_id]._replace(row=row)

    def _is_current(self, doc_id: str, row: int) -> bool:
        vv = self.version_map.get(doc_id)
        return vv is not None and not vv.deleted and vv.row == row

    def acquire_searcher(self) -> ShardReader:
        with self._lock:
            return self._reader

    def add_refresh_listener(self, listener: Callable[[ShardReader], None]) -> None:
        self._refresh_listeners.append(listener)
