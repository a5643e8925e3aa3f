"""The `late_interaction` query's exact host walker (port of
`LateInteractionQuery` in `elasticsearch_tpu/search/queries_ext.py`).

score = sum over query tokens of the max over a doc's tokens of their dot
product (cosine normalizes both sides per token, per the field mapping), in
f32 numpy over the raw stored tokens: no quantization and no coarse
pruning. It serves a plain `_search {query: {late_interaction}}` body, as
the reference's query phase does, and it is the oracle the device path is
recall-gated against. A hybrid `late_interaction` leg never takes it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.index.mapping import RankVectorsFieldMapper

_KEYS = {"field", "query_tokens", "k", "boost"}


class LateInteractionQuery:
    def __init__(self, field: str, query_tokens, boost: float = 1.0):
        self.field = field
        q = np.asarray(query_tokens, dtype=np.float32)
        if q.ndim == 1:
            q = q.reshape(1, -1)
        if q.ndim != 2 or not q.size:
            raise ParsingError(
                "[late_interaction] query_tokens must be a non-empty "
                "array of vectors")
        self.query_tokens = q
        self.boost = float(boost)

    @classmethod
    def parse(cls, spec) -> "LateInteractionQuery":
        if not isinstance(spec, dict) or "field" not in spec \
                or "query_tokens" not in spec:
            raise ParsingError("[late_interaction] requires [field] and "
                               "[query_tokens]")
        for key in spec:
            if key not in _KEYS:
                raise ParsingError(f"[late_interaction] unknown field [{key}]")
        return cls(spec["field"], spec["query_tokens"],
                   boost=spec.get("boost", 1.0))

    def execute(self, reader, mapper_service) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """(rows [m] ascending, f32 scores [m]) of every live doc holding
        the field."""
        mapper = mapper_service.get(self.field)
        if not isinstance(mapper, RankVectorsFieldMapper):
            raise IllegalArgumentError(
                f"[late_interaction] field [{self.field}] is not a "
                f"rank_vectors field")
        cosine = mapper.similarity == "cosine"
        q = self.query_tokens
        if q.shape[1] != mapper.dims:
            raise IllegalArgumentError(
                f"[late_interaction] query tokens have {q.shape[1]} dims, "
                f"field [{self.field}] expects {mapper.dims}")
        if cosine:
            q = q / np.maximum(
                np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
        rows, scores = [], []
        for view in reader.views:
            seg = view.segment
            entry = seg.tokens.get(self.field)
            if entry is None:
                continue
            toks, offsets, present = entry
            for loc in np.nonzero(view.live & present)[0]:
                t = toks[offsets[loc]:offsets[loc + 1]]
                if cosine:
                    t = t / np.maximum(
                        np.linalg.norm(t, axis=-1, keepdims=True), 1e-30)
                dots = q @ t.T                           # [Tq, Td] f32
                rows.append(seg.base + int(loc))
                scores.append(float(dots.max(axis=1).sum()) * self.boost)
        return (np.asarray(rows, dtype=np.int64),
                np.asarray(scores, dtype=np.float32))
