"""The binned kernels' launch plan (`ops/knn_binned.py::launch_plan`), which
the CUDA entry points take as given: which variant a shape takes, how the
queries are grouped, how each tile's 64 chunks are split, whether the
query group fits in shared memory, and that the grid fills the card at
the served shapes. Also the per-corpus row weight the kernels read, made
once per corpus. All of it runs on the CPU; the kernels themselves are
held against their plain version on the card by `tests/test_torch_gpu.py`
and `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.ops import knn_binned as kb
from elasticsearch_tpu_torch.ops import similarity as sim

H100_SMS = 132
BF16, INT8 = 2, 1

# (Q, N_pad, D, bytes an element) of the served paths: sift (bf16 1M x 128)
# at batch 1 and at the kernel phase's Q=256, cohere (int8 1M x 768), the
# hybrid index's knn leg (bf16 131,072 x 768 at Q=1) and the dot index
# (bf16 16,384 x 128, Q=16 in chip_smoke.py)
SERVED = [(1, 1 << 20, 128, BF16), (256, 1 << 20, 128, BF16),
          (1, 1 << 20, 768, INT8), (256, 1 << 20, 768, INT8),
          (1, 1 << 17, 768, BF16), (16, 1 << 14, 128, BF16)]


def _blocks(plan):
    groups, tiles, split = plan.grid
    return groups * tiles * split


@pytest.mark.parametrize("nq,n_pad,d,itemsize", SERVED)
def test_served_shapes_fill_the_card(nq, n_pad, d, itemsize):
    """About two blocks per SM (256 of the H100's 132 SMs) at every served
    shape, on the tma variant, with the query group staged once."""
    plan = kb.launch_plan(nq, n_pad, d, itemsize)
    assert plan.variant == kb.VARIANT_TMA
    assert _blocks(plan) >= kb.MIN_BLOCKS >= 1.9 * H100_SMS
    assert plan.staged


@pytest.mark.parametrize("nq", [1, 2, 7, 8, 9, 16, 17, 63, 64, 65, 127, 128,
                                129, 255, 256, 257, 300, 1000])
@pytest.mark.parametrize("tiles", [1, 2, 16, 128])
def test_query_groups_cover_the_batch_exactly(nq, tiles):
    """Every query row lies in exactly one group; no group is empty."""
    plan = kb.launch_plan(nq, tiles * kb.BLOCK_N, 128, BF16)
    assert plan.qn in kb.TMA_QN
    assert plan.groups * plan.qn >= nq > (plan.groups - 1) * plan.qn
    assert plan.grid == (plan.groups, tiles, plan.split)


@pytest.mark.parametrize("nq", [1, 9, 129, 256])
@pytest.mark.parametrize("tiles", [1, 2, 3, 16, 128, 512])
def test_split_divides_the_chunks(nq, tiles):
    """S divides 64, and is the least such that gives MIN_BLOCKS blocks
    (or 64, when the corpus is too small for that)."""
    plan = kb.launch_plan(nq, tiles * kb.BLOCK_N, 768, INT8)
    assert kb.CHUNKS % plan.split == 0
    widest_groups = -(-nq // kb.TMA_QN[-1])
    if plan.split > 1:
        assert widest_groups * tiles * (plan.split // 2) < kb.MIN_BLOCKS
    if _blocks(plan) < kb.MIN_BLOCKS:
        assert plan.split == kb.CHUNKS and plan.qn == kb.TMA_QN[0]


def test_small_corpus_narrows_the_query_groups():
    """At 16,384 rows even S = 64 gives 128 blocks a query group, so a
    batch of 16 splits into two groups of 8."""
    plan = kb.launch_plan(16, 2 * kb.BLOCK_N, 128, BF16)
    assert (plan.qn, plan.groups, plan.split) == (8, 2, 64)


@pytest.mark.parametrize("d,itemsize,variant", [
    (100, BF16, kb.VARIANT_WMMA), (100, INT8, kb.VARIANT_WMMA),
    (4, BF16, kb.VARIANT_WMMA), (24, INT8, kb.VARIANT_WMMA),
    (8, BF16, kb.VARIANT_TMA), (16, INT8, kb.VARIANT_TMA),
    (32, BF16, kb.VARIANT_TMA), (48, INT8, kb.VARIANT_TMA),
    (128, BF16, kb.VARIANT_TMA), (768, INT8, kb.VARIANT_TMA),
    (960, BF16, kb.VARIANT_TMA), (1024, BF16, kb.VARIANT_TMA),
    (4096, INT8, kb.VARIANT_TMA)])
def test_variant_follows_the_row_width(d, itemsize, variant):
    """TMA needs 16-byte strides: a ragged row width takes the wmma
    variant (64 query rows a block, one block a tile), every other the
    tma one."""
    for nq in (1, 70, 300):
        plan = kb.launch_plan(nq, 2 * kb.BLOCK_N, d, itemsize)
        assert plan.variant == variant
        if variant == kb.VARIANT_WMMA:
            assert plan.qn == kb.WMMA_QB and plan.split == 1
            assert plan.groups == -(-nq // kb.WMMA_QB)


@pytest.mark.parametrize("nq,d,itemsize,staged", [
    (256, 128, BF16, True), (256, 768, INT8, True), (1, 768, BF16, True),
    (1, 4096, BF16, True), (128, 768, BF16, False), (129, 960, BF16, False),
    (128, 1024, INT8, True), (64, 1024, BF16, True), (128, 4096, INT8, False)])
def test_query_group_staged_when_it_fits(nq, d, itemsize, staged):
    """The query group sits in shared memory once when all its slabs fit
    beside the ring (32 KB at Q=256 D=128 bf16, 96 KB at D=768 int8), else
    one slab rides each stage; both fit the 227 KB a block may use."""
    plan = kb.launch_plan(nq, 1 << 20, d, itemsize)
    assert plan.staged is staged
    ks = -(-d * itemsize // kb.SLAB_BYTES)
    assert kb._tma_smem_bytes(plan.qn, ks, plan.staged) <= kb.MAX_SMEM


def test_row_weight_made_once_per_corpus():
    """The validity vector (bf16) and row scale x validity (int8) are made
    at the first binned search of a corpus and reused after; the packed
    result equals the one from a freshly made weight."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((9000, 32)).astype(np.float32)
    qs = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    for dtype in ("bf16", "int8"):
        corpus = knn.build_corpus(vecs, dtype=dtype, device="cpu",
                                  pad_to=2 * kb.BLOCK_N)
        assert corpus.row_weight is None
        first, _ = kb._binned_packed(qs, corpus, sim.COSINE)
        w = corpus.row_weight
        assert w is not None and w.shape == (1, 2 * kb.BLOCK_N)
        second, _ = kb._binned_packed(qs, corpus, sim.COSINE)
        assert corpus.row_weight is w
        assert torch.equal(first, second)
        valid = (torch.arange(2 * kb.BLOCK_N) < 9000).to(torch.float32)
        want = valid * corpus.scales if dtype == "int8" else valid
        assert torch.equal(w[0], want)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain version and count no
    launch of either variant."""
    dispatch.reset_launches()
    q = torch.randn(2, 32).to(torch.bfloat16)
    c = torch.randn(kb.BLOCK_N, 32).to(torch.bfloat16)
    valid = torch.ones(1, kb.BLOCK_N)
    kb.binned_packed_bf16(q, c, valid, clamp=False)
    assert dispatch.launches() == {} and dispatch.variant_launches() == {}
