"""Field mappers for the served slices (port of the `dense_vector`,
`rank_vectors`, `text`, `keyword`, numeric and `boolean` subset of
`elasticsearch_tpu/index/mapping.py`).

`text` takes `analyzer` and `search_analyzer` (the built-in, language and
the index's own `index.analysis.*` analyzers, through the index's
`AnalysisRegistry`); its values index analyzed terms with their positions
and the field's length a document, and it keeps no doc values.

`dense_vector` takes dims, similarity, and `index_options` with `type`
(`flat`, `int8_flat`, `int4_flat`, `ivf`, `int8_ivf`, `int4_ivf`), `nlist`,
`nprobe`, `rescore` and `rescore_oversample`; `rank_vectors` (late
interaction) takes dims, similarity and the token-block storage knobs;
`keyword` (with `ignore_above`), `long`, `integer`, `short`, `byte`,
`double`, `float`, `half_float`, `scaled_float` and `boolean` fields give
each value its index terms (the filter queries' postings) and its doc
value (the range queries' column), coerced and rejected as the reference
does; `ignore_malformed` drops a bad value and records the field in
`_ignored`. `rank_feature` (a positive float, `positive_score_impact`)
keeps its value as a doc value; `rank_features` and the legacy
`sparse_vector` keep a feature -> weight map (an object, keys as strings,
weights coerced with `float`), which `parse_document` hands to the engine
as its keys and weights for the segment's feature-map column (a list of
maps stays a plain doc value, as the reference keeps it). `_source.enabled`
is honoured. Every other field type raises
the reference's mapper-parsing error. Unmapped document fields stay in
`_source` and are not indexed (there is no dynamic mapping).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, MapperParsingError,
)
from elasticsearch_tpu_torch.index.analysis import AnalysisRegistry


class FieldMapper:
    type_name = "base"

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = dict(params or {})


    def index_terms(self, value: Any) -> List[str]:
        """The value's terms in the field's postings; none by default."""
        return []

    def doc_value(self, value: Any) -> Any:
        """The value's doc-values form, or None (no column)."""
        return None


class KeywordFieldMapper(FieldMapper):
    type_name = "keyword"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.ignore_above = self.params.get("ignore_above")

    def index_terms(self, value):
        s = str(value)
        if self.ignore_above is not None and len(s) > self.ignore_above:
            return []
        return [s]

    def doc_value(self, value):
        return str(value)


class TextFieldMapper(FieldMapper):
    type_name = "text"

    def __init__(self, name, params=None,
                 registry: Optional[AnalysisRegistry] = None):
        super().__init__(name, params)
        if registry is None:
            from elasticsearch_tpu_torch.index import analysis
            registry = analysis.DEFAULT_REGISTRY
        self.analyzer = registry.get(self.params.get("analyzer", "standard"))
        self.search_analyzer = registry.get(self.params.get(
            "search_analyzer", self.params.get("analyzer", "standard")))

    def analyze(self, value) -> List[str]:
        return self.analyzer.terms(str(value))

    def analyze_positions(self, value):
        return self.analyzer.analyze(str(value))

    def index_terms(self, value):
        return self.analyze(value)


class _NumericMapper(FieldMapper):
    py_type = float

    def coerce(self, value: Any):
        if isinstance(value, bool):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}]: boolean")
        try:
            v = self.py_type(value)
        except (TypeError, ValueError):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type_name}] value [{value}]")
        if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
            raise MapperParsingError(
                f"[{self.name}] non-finite value [{value}]")
        return v

    def index_terms(self, value):
        return [repr(self.coerce(value))]

    def doc_value(self, value):
        return self.coerce(value)


class LongFieldMapper(_NumericMapper):
    type_name = "long"
    py_type = int


class IntegerFieldMapper(LongFieldMapper):
    type_name = "integer"


class ShortFieldMapper(LongFieldMapper):
    type_name = "short"


class ByteFieldMapper(LongFieldMapper):
    type_name = "byte"


class DoubleFieldMapper(_NumericMapper):
    type_name = "double"
    py_type = float


class FloatFieldMapper(DoubleFieldMapper):
    type_name = "float"


class HalfFloatFieldMapper(DoubleFieldMapper):
    type_name = "half_float"


class ScaledFloatFieldMapper(_NumericMapper):
    type_name = "scaled_float"
    py_type = float

    def doc_value(self, value):
        factor = self.params.get("scaling_factor", 100)
        return round(self.coerce(value) * factor) / factor


class BooleanFieldMapper(FieldMapper):
    type_name = "boolean"

    def coerce(self, value):
        if isinstance(value, bool):
            return value
        if value in ("true", "True"):
            return True
        if value in ("false", "False", ""):
            return False
        raise MapperParsingError(
            f"failed to parse boolean field [{self.name}] value [{value}]")

    def index_terms(self, value):
        return ["T" if self.coerce(value) else "F"]

    def doc_value(self, value):
        return self.coerce(value)


class RankFeatureFieldMapper(FieldMapper):
    """`rank_feature`: a positive float consumed by `rank_feature`
    queries; negative values are refused unless `positive_score_impact`
    is false."""

    type_name = "rank_feature"

    def coerce(self, value) -> float:
        v = float(value)
        if v < 0 and self.params.get("positive_score_impact", True) \
                is not False:
            raise MapperParsingError(
                f"[{self.name}] rank_feature fields only support positive "
                f"values, got [{value}]")
        return v

    def doc_value(self, value):
        return self.coerce(value)


class RankFeaturesFieldMapper(FieldMapper):
    """`rank_features`: a sparse map feature -> weight (the learned-sparse
    field `ops/sparse.py` scores)."""

    type_name = "rank_features"

    def coerce(self, value) -> dict:
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"[{self.name}] {self.type_name} value must be an object")
        return {str(k): float(v) for k, v in value.items()}

    def doc_value(self, value):
        return self.coerce(value)


class SparseVectorFieldMapper(RankFeaturesFieldMapper):
    """`sparse_vector` (the legacy map type): a map dimension -> weight,
    stored and scored as `rank_features` is."""

    type_name = "sparse_vector"


class DenseVectorFieldMapper(FieldMapper):
    """`dense_vector`: dims (required), similarity (cosine|dot_product|
    l2_norm|max_inner_product, default cosine), index_options.type — the
    quantization-ladder rung (flat = the store's bf16, int8_flat, int4_flat
    packed nibbles) on the exhaustive engine, or the same rung on the
    partitioned `tpu_ivf` engine (ivf, int8_ivf, int4_ivf), overriding
    `index.knn.engine`; index_options.nlist / nprobe (per-field IVF
    overrides); index_options.rescore (int8: keep the residual level and
    re-rank the kernel's top candidates; int4, on by default: exact f32
    rescore of the coarse window) and rescore_oversample (sizes those
    windows). The binary rungs are not ported."""

    type_name = "dense_vector"

    INDEX_OPTIONS_TYPES = ("flat", "int8_flat", "int4_flat",
                           "ivf", "int8_ivf", "int4_ivf")

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.dims = self.params.get("dims")
        if self.dims is None:
            raise MapperParsingError(f"[{name}] dense_vector requires [dims]")
        self.dims = int(self.dims)
        self.similarity = self.params.get("similarity", "cosine")
        if self.similarity not in ("cosine", "dot_product", "l2_norm",
                                   "max_inner_product"):
            raise MapperParsingError(
                f"[{name}] unknown similarity [{self.similarity}]")
        opts = self.params.get("index_options") or {}
        otype = opts.get("type")
        if otype is not None and otype not in self.INDEX_OPTIONS_TYPES:
            raise MapperParsingError(
                f"[{name}] unknown index_options type [{otype}]; expected "
                f"one of {list(self.INDEX_OPTIONS_TYPES)}")
        # the packed rung's bit layout needs even dims: reject at mapping
        # time, not at first refresh
        if otype in ("int4_flat", "int4_ivf") and self.dims % 2:
            raise MapperParsingError(
                f"[{name}] index_options type [{otype}] requires even "
                f"[dims], got [{self.dims}]")
        for opt_key in ("nlist", "nprobe", "rescore_oversample"):
            v = opts.get(opt_key)
            if v is None or (opt_key == "nprobe" and v == "auto"):
                continue  # "auto" is meaningful only for nprobe
            try:
                ok = int(v) >= 1
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise MapperParsingError(
                    f"[{name}] index_options [{opt_key}] must be an "
                    f"integer >= 1, got [{v}]")

    def coerce(self, value) -> np.ndarray:
        if isinstance(value, np.ndarray):
            arr = value.astype(np.float32, copy=False)
        elif isinstance(value, (list, tuple)):
            arr = np.asarray(value, dtype=np.float32)
        else:
            raise MapperParsingError(
                f"[{self.name}] dense_vector value must be an array")
        if arr.ndim != 1 or arr.shape[0] != self.dims:
            raise MapperParsingError(
                f"[{self.name}] vector has "
                f"[{arr.shape[0] if arr.ndim == 1 else '?'}] "
                f"dimensions, mapping requires [{self.dims}]")
        if not np.isfinite(arr).all():
            raise MapperParsingError(
                f"[{self.name}] vector contains non-finite values")
        return arr


class RankVectorsFieldMapper(FieldMapper):
    """`rank_vectors` (the late-interaction field): each doc holds a ragged
    list of token vectors, scored by MaxSim against a multi-token query.

    params: dims (required), similarity (cosine|dot_product, default
    cosine), index_options.encoding — the token-block storage rung
    (f32|bf16|int8|int4, default int8), index_options.oversample — the
    coarse pooled-centroid window multiplier (default 4),
    index_options.coarse — storage rung of the pooled centroid matrix
    (f32|bf16|int8|int4, default f32; `binary` is not ported). Each is read
    from `index_options` or from the top level."""

    type_name = "rank_vectors"

    ENCODINGS = ("f32", "bf16", "int8", "int4")
    COARSE = ("f32", "bf16", "int8", "int4", "binary")

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.dims = self.params.get("dims")
        if self.dims is None:
            raise MapperParsingError(f"[{name}] rank_vectors requires [dims]")
        self.dims = int(self.dims)
        self.similarity = self.params.get("similarity", "cosine")
        if self.similarity not in ("cosine", "dot_product"):
            raise MapperParsingError(
                f"[{name}] unknown similarity [{self.similarity}] for "
                "rank_vectors; expected cosine or dot_product")
        opts = self.params.get("index_options") or {}
        self.encoding = opts.get("encoding",
                                 self.params.get("encoding", "int8"))
        if self.encoding not in self.ENCODINGS:
            raise MapperParsingError(
                f"[{name}] unknown index_options encoding "
                f"[{self.encoding}]; expected one of {list(self.ENCODINGS)}")
        if self.encoding == "int4" and self.dims % 2:
            raise MapperParsingError(
                f"[{name}] index_options encoding [int4] requires even "
                f"[dims], got [{self.dims}]")
        self.coarse = opts.get("coarse", self.params.get("coarse", "f32"))
        if self.coarse not in self.COARSE:
            raise MapperParsingError(
                f"[{name}] unknown index_options coarse [{self.coarse}]; "
                f"expected one of {list(self.COARSE)}")
        if self.coarse == "binary":
            raise MapperParsingError(
                f"[{name}] index_options coarse [binary] is not supported "
                "by this build: the binary rung is not ported")
        oversample = opts.get("oversample",
                              self.params.get("oversample", 4))
        try:
            ok = int(oversample) >= 1
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise MapperParsingError(
                f"[{name}] index_options [oversample] must be an integer "
                f">= 1, got [{oversample}]")
        self.oversample = int(oversample)

    def coerce(self, value) -> np.ndarray:
        if not isinstance(value, (list, tuple)) or not value:
            raise MapperParsingError(
                f"[{self.name}] rank_vectors value must be a non-empty "
                "array of vectors")
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.ndim != 2 or arr.shape[1] != self.dims:
            raise MapperParsingError(
                f"[{self.name}] rank_vectors rows must have [{self.dims}] "
                "dimensions")
        if not np.isfinite(arr).all():
            raise MapperParsingError(
                f"[{self.name}] rank_vectors contains non-finite values")
        return arr


FIELD_TYPES = {m.type_name: m for m in (
    TextFieldMapper, KeywordFieldMapper, LongFieldMapper, IntegerFieldMapper,
    ShortFieldMapper, ByteFieldMapper, DoubleFieldMapper, FloatFieldMapper,
    HalfFloatFieldMapper, ScaledFloatFieldMapper, BooleanFieldMapper,
    DenseVectorFieldMapper, RankVectorsFieldMapper, RankFeatureFieldMapper,
    RankFeaturesFieldMapper, SparseVectorFieldMapper)}


def build_mapper(name: str, definition: dict,
                 registry: Optional[AnalysisRegistry] = None) -> FieldMapper:
    if name.rpartition(".")[2] == "":
        raise IllegalArgumentError("field name cannot be an empty string")
    t = definition.get("type")
    if t is None:
        raise MapperParsingError(f"no type specified for field [{name}]")
    cls = FIELD_TYPES.get(t)
    if cls is None:
        raise MapperParsingError(
            f"No handler for type [{t}] declared on field [{name}]")
    params = {k: v for k, v in definition.items() if k != "type"}
    if cls is TextFieldMapper:
        return cls(name, params, registry=registry)
    return cls(name, params)


class MapperService:
    """The (additive-only) mapping of one index."""

    def __init__(self, mapping: Optional[dict] = None,
                 registry: Optional[AnalysisRegistry] = None):
        self._mappers: Dict[str, FieldMapper] = {}
        self._meta: dict = {}
        self.source_enabled = True
        # the index's analyzers (`AnalysisRegistry.from_index_settings`)
        self.registry = registry
        if mapping:
            self.merge(mapping)

    def merge(self, mapping: dict) -> None:
        """Add a mapping's fields (`PUT /{index}/_mapping` too): a body of
        `properties`, or a bare field object less its metadata keys. A
        field whose type changes is the reference's 400, and the fields
        before it in the body stay merged, as there."""
        if not isinstance(mapping, dict):
            raise MapperParsingError("mapping must be an object")
        if "properties" in mapping:
            props = mapping["properties"]
        else:
            props = {k: v for k, v in mapping.items()
                     if not k.startswith("_") and k != "dynamic"}
        if "_meta" in mapping:
            self._meta = mapping["_meta"]
        src = mapping.get("_source")
        if isinstance(src, dict) and src.get("enabled") is False:
            # _source disabled: never rendered in hits or GET
            self.source_enabled = False
        for name, definition in props.items():
            if not isinstance(definition, dict):
                raise MapperParsingError(
                    f"invalid mapping definition for [{name}]")
            mapper = build_mapper(name, definition, self.registry)
            existing = self._mappers.get(name)
            if existing is not None and existing.type_name != mapper.type_name:
                raise IllegalArgumentError(
                    f"mapper [{name}] cannot be changed from type "
                    f"[{existing.type_name}] to [{mapper.type_name}]")
            self._mappers[name] = mapper

    def get(self, path: str) -> Optional[FieldMapper]:
        return self._mappers.get(path)

    def to_dict(self) -> dict:
        """The mapping as `GET /_mapping` renders it: each field's type and
        its definition as given, by field name, and `_meta`."""
        out = {"properties": {
            name: {"type": m.type_name, **m.params}
            for name, m in sorted(self._mappers.items())}}
        if self._meta:
            out["_meta"] = self._meta
        return out

    def all_mappers(self):
        return list(self._mappers.items())

    def vector_fields(self) -> Dict[str, DenseVectorFieldMapper]:
        return {p: m for p, m in self._mappers.items()
                if isinstance(m, DenseVectorFieldMapper)}

    def token_fields(self) -> Dict[str, RankVectorsFieldMapper]:
        return {p: m for p, m in self._mappers.items()
                if isinstance(m, RankVectorsFieldMapper)}

    def parse_document(self, source: dict) -> "ParsedFields":
        """The document's mapped values, validated: dense_vector values as
        f32 rows, rank_vectors values as f32 [n_tokens, dims] matrices, and
        text values as analyzed terms with their positions and the field's
        length, a feature map (`rank_features`, `sparse_vector`) as its
        keys and coerced weights, and every other mapped field's index
        terms and doc value (a list holds several values; one value stays a
        scalar), as the reference's `DocumentParser` makes them."""
        if not isinstance(source, dict):
            raise MapperParsingError("document source must be an object")
        parsed = ParsedFields()
        for field, value in source.items():
            mapper = self._mappers.get(field)
            if mapper is None or value is None:
                continue
            if isinstance(mapper, DenseVectorFieldMapper):
                parsed.vectors[field] = mapper.coerce(value)
                continue
            if isinstance(mapper, RankVectorsFieldMapper):
                # multi-valued, as the reference's DocumentParser reads it:
                # each element is one token row ([] indexes no token)
                rows = [mapper.coerce(v) for v in
                        (value if isinstance(value, list) else [value])
                        if v is not None]
                if rows:
                    parsed.vectors[field] = (rows[0] if len(rows) == 1
                                             else np.concatenate(rows))
                continue
            for v in (value if isinstance(value, list) else [value]):
                if v is not None:
                    self._index_one(field, mapper, v, parsed)
            if isinstance(mapper, RankFeaturesFieldMapper) \
                    and isinstance(parsed.doc_values.get(field), dict):
                fmap = parsed.doc_values.pop(field)
                parsed.features[field] = (list(fmap), list(fmap.values()))
        return parsed

    @staticmethod
    def _index_one(field: str, mapper: FieldMapper, v: Any,
                   parsed: "ParsedFields") -> None:
        if isinstance(mapper, TextFieldMapper):
            # a later value of a multi-valued field continues the
            # positions where the one before ended
            tokens = mapper.analyze_positions(v)
            base = parsed.field_lengths.get(field, 0)
            parsed.terms.setdefault(field, []).extend([t[0] for t in tokens])
            parsed.term_positions.setdefault(field, []).extend(
                [base + t[1] for t in tokens])
            parsed.field_lengths[field] = base + len(tokens)
            return
        try:
            terms = mapper.index_terms(v)
            dv = mapper.doc_value(v)
        except MapperParsingError:
            # ignore_malformed: drop the unparseable value, keep the doc;
            # the field lands in the searchable `_ignored` metadata field
            if not mapper.params.get("ignore_malformed"):
                raise
            ignored = parsed.doc_values.setdefault("_ignored", [])
            if field not in ignored:
                ignored.append(field)
                parsed.terms.setdefault("_ignored", []).append(field)
            return
        if terms:
            parsed.terms.setdefault(field, []).extend(terms)
        if dv is not None:
            existing = parsed.doc_values.get(field)
            if existing is None:
                parsed.doc_values[field] = dv
            elif isinstance(existing, list):
                existing.append(dv)
            else:
                parsed.doc_values[field] = [existing, dv]


class ParsedFields:
    """One document's mapped values: field -> vector (or token matrix),
    field -> index terms (duplicates kept, for term frequencies), field ->
    doc value (a scalar, or a list for a multi-valued field); for text
    fields, field -> each term's position (parallel to its terms) and
    field -> token count; for a feature-map field holding one map, field ->
    (its keys, its weights as floats), in the map's order."""

    __slots__ = ("vectors", "terms", "doc_values", "term_positions",
                 "field_lengths", "features")

    def __init__(self):
        self.vectors: Dict[str, np.ndarray] = {}
        self.terms: Dict[str, List[str]] = {}
        self.doc_values: Dict[str, Any] = {}
        self.term_positions: Dict[str, List[int]] = {}
        self.field_lengths: Dict[str, int] = {}
        self.features: Dict[str, tuple] = {}
