"""Query serving layer: the combining batcher (port of
`elasticsearch_tpu/serving/`)."""

from elasticsearch_tpu_torch.serving.batcher import (
    BoundedBatcher, CombiningBatcher,
)

__all__ = ["BoundedBatcher", "CombiningBatcher"]
