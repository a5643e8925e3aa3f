"""Generational device segments: writes while searching, without rebuilds
(port of `elasticsearch_tpu/segments/`, less the mesh and the host mirror).

* `generation.Generation`: one immutable device slice of a field's corpus,
  padded to the row ladder (`ops/dispatch.bucket_gen_rows`); deletes set
  its tombstones instead of triggering a rebuild;
* `policy.TieredMergePolicy`: the tier math (a tier of `tier_size`
  generations, the L0 overflow, tombstone GC);
* `generational.GenerationalCorpus`: the copy-on-write generation set the
  vector store serves from, the O(delta) refresh classifier, the search of
  every generation merged by `ops/topk.merge_top_k`, and the budgeted
  background merge thread, which owns the IVF retrain.
"""

from elasticsearch_tpu_torch.segments.generation import (  # noqa: F401
    Generation, build_generation, generation_tier, row_index_of)
from elasticsearch_tpu_torch.segments.generational import (  # noqa: F401
    GenerationalCorpus, GenerationSet)
from elasticsearch_tpu_torch.segments.policy import (  # noqa: F401
    MergeSpec, TieredMergePolicy)
