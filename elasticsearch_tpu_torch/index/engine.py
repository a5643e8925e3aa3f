"""In-memory shard engine (port of the kNN and filter slice of
`elasticsearch_tpu/index/engine.py`).

Indexing appends to a buffer; `refresh` seals the buffer into an immutable
segment, tombstones replaced rows, and hands the new reader to refresh
listeners (the vector store syncs there). Vectors travel as numpy blocks:
`index_many` takes a whole batch, optionally with its vectors as one
[n, dims] array per field, which is how a million-document shard loads.
Keyword, numeric and boolean values are parsed from each `_source`; the
seal builds their postings and doc-values columns with numpy. Text values
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
is kept beside its `_id`.

This slice has no translog and no flush: nothing survives the process.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    MapperParsingError, VersionConflictError,
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
    result: str    # "created" | "updated"
    row: int


class _VersionValue(NamedTuple):
    version: int
    seq_no: int
    row: int


class _Buffer:
    """The indexing buffer of the next segment."""

    def __init__(self, seg_id: int, base: int):
        self.seg_id = seg_id
        self.base = base
        self.ids: List[str] = []
        self.sources: List[Optional[dict]] = []
        self.routings: List[Optional[str]] = []
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

    def add(self, ids, sources, routings, vectors, tokens, terms,
            doc_values) -> int:
        """Append a batch. `terms` and `doc_values` map a field to
        (batch positions, values), one entry a term or a doc value."""
        start = len(self.ids)
        self.ids.extend(ids)
        self.sources.extend(sources)
        self.routings.extend(routings)
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
        routings = (self.routings if any(r is not None for r in self.routings)
                    else None)
        return Segment(self.seg_id, self.base, self.ids, self.sources, vectors,
                       self._seal_tokens(n), postings, doc_values, routings,
                       field_lengths)


class Engine:
    def __init__(self, mapper_service: MapperService):
        self.mapper_service = mapper_service
        self._lock = threading.Lock()
        self.segments: List[Segment] = []
        self.deleted_rows: Dict[int, set] = {}    # seg_id -> local rows
        self.version_map: Dict[str, _VersionValue] = {}
        self._next_seq_no = 0
        self._next_row = 0
        self._next_seg_id = 0
        self._buffer: Optional[_Buffer] = None
        self._reader: Optional[ShardReader] = None
        self._refresh_listeners: List[Callable[[ShardReader], None]] = []

    # ---------------------------------------------------------------- writes
    def index(self, doc_id: str, source: dict, op_type: str = "index",
              routing: Optional[str] = None) -> EngineResult:
        return self.index_many([doc_id], [source], op_type=op_type,
                               routings=[routing])[0]

    def index_many(self, ids: List[str], sources: Optional[List[dict]] = None,
                   vectors: Optional[Dict[str, np.ndarray]] = None,
                   token_vectors: Optional[Dict[str, tuple]] = None,
                   op_type: str = "index",
                   routings: Optional[List[Optional[str]]] = None
                   ) -> List[EngineResult]:
        """Index a batch. `sources[i]` is document i's `_source` (dense_vector
        values may be lists or numpy rows, rank_vectors values lists of
        token vectors); `vectors` may instead supply a field's values for
        the whole batch as one [n, dims] array, and `token_vectors` a
        rank_vectors field's as (tokens [T, dims], counts [n]): document i
        owns the next counts[i] rows, and a count of 0 leaves the document
        without the field. `routings[i]` is document i's routing value (or
        None). The batch is validated before any document is applied."""
        n = len(ids)
        sources = [None] * n if sources is None else list(sources)
        routings = [None] * n if routings is None else list(routings)
        if len(sources) != n or len(routings) != n:
            raise ValueError("ids, sources and routings differ in length")
        mappers = self.mapper_service.vector_fields()
        token_mappers = self.mapper_service.token_fields()
        token_columns = {f: self._token_column(f, token_mappers, value, n)
                         for f, value in (token_vectors or {}).items()}
        columns = {}
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
            columns[field] = (None, block)
        stored = []
        per_field: Dict[str, list] = {
            f: [] for f in (*mappers, *token_mappers)
            if f not in columns and f not in token_columns}
        terms: Dict[str, Tuple[list, list]] = {}
        doc_values: Dict[str, Tuple[list, list]] = {}
        text: Dict[str, Tuple[list, list, list, list]] = {}
        features: Dict[str, Tuple[list, list, list]] = {}
        for i, src in enumerate(sources):
            if src is None:
                stored.append(None)
                continue
            parsed = self.mapper_service.parse_document(src)
            for field, vec in parsed.vectors.items():
                if field in per_field:
                    per_field[field].append((i, vec))
            for field, length in parsed.field_lengths.items():
                pos, ts, ps, lens = text.setdefault(field, ([], [], [], []))
                pos.append(i)
                ts.append(parsed.terms.pop(field, []))
                ps.append(parsed.term_positions[field])
                lens.append(length)
            for field, (keys, weights) in parsed.features.items():
                pos, ks, ws = features.setdefault(field, ([], [], []))
                pos.append(i)
                ks.append(keys)
                ws.append(weights)
            for field, ts in parsed.terms.items():
                pos, vals = terms.setdefault(field, ([], []))
                pos.extend([i] * len(ts))
                vals.extend(ts)
            for field, dv in parsed.doc_values.items():
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

        with self._lock:
            if op_type == "create":
                for doc_id in ids:
                    if doc_id in self.version_map:
                        raise VersionConflictError(
                            f"[{doc_id}]: version conflict, document already "
                            f"exists (current version "
                            f"[{self.version_map[doc_id].version}])")
            if self._buffer is None:
                self._buffer = _Buffer(self._next_seg_id, self._next_row)
                self._next_seg_id += 1
            start = self._buffer.add(list(ids), stored, routings, columns,
                                     token_columns, terms, doc_values)
            self._buffer.add_text(start, text)
            self._buffer.add_features(start, features)
            self._next_row += n
            out = []
            for i, doc_id in enumerate(ids):
                row = self._buffer.base + start + i
                existing = self.version_map.get(doc_id)
                if existing is not None:
                    self._tombstone(existing.row)
                version = 1 if existing is None else existing.version + 1
                seq_no = self._next_seq_no
                self._next_seq_no += 1
                self.version_map[doc_id] = _VersionValue(version, seq_no, row)
                out.append(EngineResult(
                    doc_id, seq_no, PRIMARY_TERM, version,
                    "created" if existing is None else "updated", row))
            return out

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

    def _tombstone(self, row: int) -> None:
        for seg in self.segments:
            if seg.base <= row < seg.base + seg.num_docs:
                self.deleted_rows.setdefault(seg.seg_id, set()).add(row - seg.base)
                return
        buf = self._buffer
        self.deleted_rows.setdefault(buf.seg_id, set()).add(row - buf.base)

    # ----------------------------------------------------------------- reads
    def get(self, doc_id: str) -> Optional[dict]:
        """Realtime get: the latest version, sealed or still buffered."""
        with self._lock:
            vv = self.version_map.get(doc_id)
            if vv is None:
                return None
            buf = self._buffer
            if buf is not None and vv.row >= buf.base:
                src = buf.source(vv.row - buf.base)
                routing = buf.routings[vv.row - buf.base]
            else:
                sealed = ShardReader([SegmentView(s) for s in self.segments])
                src = sealed.get_source(vv.row)
                routing = sealed.get_routing(vv.row)
            out = {"_version": vv.version, "_seq_no": vv.seq_no,
                   "_primary_term": PRIMARY_TERM, "_source": src}
            if routing is not None:
                out["_routing"] = routing
            return out

    def refresh(self) -> ShardReader:
        """Seal the indexing buffer; make recent writes searchable."""
        with self._lock:
            if self._buffer is not None and self._buffer.ids:
                dims = {f: m.dims for f, m in
                        self.mapper_service.vector_fields().items()}
                self.segments.append(self._buffer.seal(dims))
                self._buffer = None
            views = [SegmentView(seg, self.deleted_rows.get(seg.seg_id))
                     for seg in self.segments]
            self._reader = ShardReader(views)
            for listener in self._refresh_listeners:
                listener(self._reader)
            return self._reader

    def acquire_searcher(self) -> ShardReader:
        with self._lock:
            reader = self._reader
        return reader if reader is not None else self.refresh()

    def add_refresh_listener(self, listener: Callable[[ShardReader], None]) -> None:
        self._refresh_listeners.append(listener)
