"""Partitioned ANN engine (`index.knn.engine: tpu_ivf`), port of
`elasticsearch_tpu/ann/`.

IVF in the style of Faiss IVF-Flat: a small centroid matmul routes each
query to `nprobe` of `nlist` k-means partitions, then only those
partitions are scored — trading a small, measured recall budget for a
large cut in bytes read over the exhaustive scan in `ops/knn.py`.

  kmeans.py     mini-batch k-means on the device (k-means++ seeding, soft
                balance penalty) that trains the `nlist` centroids
  ivf_index.py  the partition layout: capped bucketed build, incremental
                add with displacement/spill accounting and a retrain
                threshold, f32/bf16/int8/int4 tiles
  router.py     query-time engine: centroid routing, nprobe selection
                (`"auto"` tunes to a recall target), the fused or scan
                probe scorer, per-phase timings, the exhaustive fallback

The probe scorers live in `ops/knn_ivf.py` (scan) and `ops/ivf_fused.py`
(the hand-written fused kernels).
"""

from elasticsearch_tpu_torch.ann.ivf_index import IVFIndex, build_ivf_index
from elasticsearch_tpu_torch.ann.router import IVFRouter

__all__ = ["IVFIndex", "IVFRouter", "build_ivf_index"]
