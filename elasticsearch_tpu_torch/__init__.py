"""PyTorch / CUDA port of `elasticsearch_tpu`, for an NVIDIA H100.

The JAX package beside this one is the reference; module names here mirror
it (`ops/knn.py`, `vectors/store.py`, `search/knn_query.py`, ...) so each
counterpart is found at the same relative path. The port imports `torch`
and numpy, never `jax` and never `elasticsearch_tpu`: where it needs code of
the reference it keeps its own copy.

The slices served here, end to end from the REST server:
- `_search { "knn": ... }`: engine → vector store → `ops.knn.knn_search_auto`,
  whose accelerator route is the hand-written binned kernel
  (`csrc/knn_binned.cu`);
- the `tpu_ivf` engine (`ivf`, `int8_ivf`, `int4_ivf`): the IVF router and
  the fused probe kernels (`csrc/ivf_fused.cu`);
- late interaction: `rank_vectors` fields searched by a `late_interaction`
  sub-search inside a hybrid `rank: {rrf}` `_search` beside a `knn` leg
  (`search/hybrid_plan.py` → `vectors/late_interaction.py`: a coarse search
  over pooled centroids, then the MaxSim kernels of `csrc/maxsim.cu`), and
  a plain `query: {late_interaction}` through the exact host walker;
- BM25 text search: `text` fields (`index/analysis.py`) and the text
  queries of `search/queries.py` on the host (`native/`), and hybrid
  `rank: {rrf}` bodies whose `match` / `term` legs score in one BM25 board
  a batch on the card (`ops/bm25.py` → `csrc/bm25.cu`), beside a kNN leg.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (the default) and no GPU is
    present — the port never carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device [{device}]: use cuda or cpu")
    return dev
