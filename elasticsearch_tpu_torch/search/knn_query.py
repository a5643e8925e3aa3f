"""kNN query: the `_search { "knn": ... }` device path (port of
`elasticsearch_tpu/search/knn_query.py`).

The query dispatches to the shard's device vector store and converts raw
similarities to the `_search` knn `_score` convention. An optional filter
query runs first on the host; its rows go to the store, which masks
everything else out of the exact route. There is no host fallback:
without a store attached it raises. A context with `knn_exact` set (the
`_explain` API's) sends an unfiltered clause to the store's exact route,
every live row its filter. The context's `deadline_at` rides
into the store's batcher, and the store's phases of the search become the
context's `knn_phases`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index.mapping import DenseVectorFieldMapper
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.search.queries import DocSet, Query


class KnnQuery(Query):
    def __init__(self, field: str, query_vector, k: int = 10,
                 num_candidates: int = 10,
                 filter_query: Optional[Query] = None, boost: float = 1.0):
        self.field = field
        self.query_vector = np.asarray(query_vector, dtype=np.float32)
        self.k = k
        self.num_candidates = max(num_candidates, k)
        self.filter_query = filter_query
        self.boost = boost

    def _metric(self, ctx) -> str:
        mapper = ctx.mapper_service.get(self.field)
        if not isinstance(mapper, DenseVectorFieldMapper):
            raise IllegalArgumentError(
                f"[knn] field [{self.field}] is not a dense_vector field")
        if self.query_vector.ndim != 1 \
                or self.query_vector.shape[0] != mapper.dims:
            raise IllegalArgumentError(
                f"[knn] query vector has {self.query_vector.shape[-1]} dims, "
                f"field [{self.field}] expects {mapper.dims}")
        from elasticsearch_tpu_torch.vectors.store import _METRIC_MAP
        return _METRIC_MAP[mapper.similarity]

    def execute(self, ctx) -> DocSet:
        """The top-k hits (among the filter's rows), rows ascending."""
        metric = self._metric(ctx)
        filter_rows = None
        if self.filter_query is not None:
            filter_rows = self.filter_query.execute(ctx).rows
        elif ctx.knn_exact:
            # every live row as the filter: the store's exact route
            filter_rows = ctx.all_rows()
        store = ctx.vector_store
        if store is None:
            raise IllegalArgumentError(
                f"[knn] no vector store attached for field [{self.field}]")
        # the store serves the snapshot of the reader the filter ran on;
        # `deadline_at` sheds the request in the batcher's queue
        rows, raw = store.search(self.field, self.query_vector, self.k,
                                 filter_rows=filter_rows,
                                 num_candidates=self.num_candidates,
                                 reader=ctx.reader,
                                 deadline_at=getattr(ctx, "deadline_at",
                                                     None))
        # the engine's phases of this search (IVF route / score / merge,
        # fallback reason, rescore window) and the field's last refresh
        # composition, for `profile.knn`
        phases = getattr(store, "last_knn_phases", None)
        col = getattr(store, "columnar_refresh", None)
        if col and self.field in col:
            phases = dict(phases or {})
            phases.setdefault("columnar", col[self.field])
        if phases:
            ctx.knn_phases = phases
        scores = np.asarray(sim.to_es_score(raw, metric)) * self.boost
        order = np.argsort(rows, kind="stable")
        return DocSet(rows[order].astype(np.int64),
                      scores[order].astype(np.float32))

    def to_dict(self):
        d = {"field": self.field, "query_vector": self.query_vector.tolist(),
             "k": self.k, "num_candidates": self.num_candidates}
        if self.filter_query is not None:
            d["filter"] = self.filter_query.to_dict()
        return {"knn": d}

    def key_is_exact(self) -> bool:
        return self.filter_query is None or self.filter_query.key_is_exact()
