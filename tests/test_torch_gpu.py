"""The hand-written CUDA kernels (binned kNN, fused IVF probes, MaxSim, the
BM25 board)
against their plain PyTorch versions, and the `aggs.*` torch ops against
numpy, on a CUDA card; also the served paths on the card (a profiled
request's launches against its unprofiled twin's, the device waits of
sampled-out and traced requests). Every test here is marked `gpu` and skips without a card. This
file imports neither `jax` nor the JAX package, so on a machine without
JAX it runs alone:

    python -m pytest tests/test_torch_gpu.py -q -p no:cacheprovider --noconftest
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import ivf_fused as fused
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.ops import knn_binned as kb
from elasticsearch_tpu_torch.ops import maxsim
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions

QUANTUM = 2.0 ** -15   # one packing quantum at shifted scores in [4, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _decoded(p):
    return (p & kb.MASK).view(torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [1, 2, 16])
@pytest.mark.parametrize("nq", [1, 8, 9, 64, 70, 129, 256, 300])
@pytest.mark.parametrize("d", [32, 48, 100, 128, 768, 960])
def test_kernels_match_plain_version(cuda, tiles, nq, d):
    """Every query count around the group widths (8, 64, 128), one to 16
    tiles (so every chunk split from 1 to 64), served widths and ragged
    ones (d = 100 takes the wmma variant, the rest the tma one), and a
    padded tail of invalid rows. int8 is bit-identical to the plain
    version, bf16 within one packing quantum."""
    g = torch.Generator(device=cuda).manual_seed(d + nq + tiles)
    n_pad = tiles * kb.BLOCK_N
    valid, tpat = kb._tile_patterns(n_pad, n_pad - 300, cuda)
    q = torch.randn(nq, d, generator=g, device=cuda)
    c = torch.randn(n_pad, d, generator=g, device=cuda)
    # unit rows keep cosine scores in [-1, 1] (shifted into [3, 5]); the
    # clamped variant gets rows scaled past the ±3 clamp
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    c = c / c.norm(dim=1, keepdim=True)
    for clamp, c in ((False, c.to(torch.bfloat16)),
                     (True, (c * 8).to(torch.bfloat16))):
        variant = kb.launch_plan(nq, n_pad, d, 2).variant
        assert variant == (kb.VARIANT_WMMA if d == 100 else kb.VARIANT_TMA)
        key = f"{kb.KERNEL_BF16}/{variant}"
        before = dispatch.variant_launches().get(key, 0)
        got = kb.binned_packed_bf16(q, c, valid, clamp)
        assert dispatch.variant_launches().get(key, 0) == before + 1
        want = kb.binned_packed_reference(q, c, valid, tpat, clamp=clamp)
        err = float((_decoded(got) - _decoded(want)).abs().max())
        assert err <= QUANTUM, (clamp, err)
    q8 = torch.randint(-127, 128, (nq, d), generator=g, device=cuda,
                       dtype=torch.int32).to(torch.int8)
    c8 = torch.randint(-127, 128, (n_pad, d), generator=g, device=cuda,
                       dtype=torch.int32).to(torch.int8)
    qs = torch.rand(nq, 1, generator=g, device=cuda) / 127 / 3
    rsv = torch.rand(1, n_pad, generator=g, device=cuda) / 127 / 3 * valid
    variant = kb.launch_plan(nq, n_pad, d, 1).variant
    assert variant == (kb.VARIANT_WMMA if d == 100 else kb.VARIANT_TMA)
    key = f"{kb.KERNEL_INT8}/{variant}"
    before = dispatch.variant_launches().get(key, 0)
    got = kb.binned_packed_int8(q8, c8, qs, rsv)
    assert dispatch.variant_launches().get(key, 0) == before + 1
    want = kb.binned_packed_reference(q8, c8, rsv, tpat, qscale=qs)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_search_auto_on_cuda_launches_kernel_and_matches_cpu(cuda, dtype):
    """The same corpus searched on the card (kernel) and on the CPU (plain
    version) gives the same rows where scores are clear of ties."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((20000, 64)).astype(np.float32)
    qs = torch.from_numpy(rng.standard_normal((9, 64)).astype(np.float32))
    on_gpu = knn.build_corpus(vecs, dtype=dtype, device=cuda)
    assert on_gpu.matrix.shape[0] % kb.BLOCK_N == 0      # the CUDA pad rule
    on_cpu = knn.build_corpus(vecs, dtype=dtype, device="cpu",
                              pad_to=on_gpu.matrix.shape[0])
    before = dispatch.launches()
    s, i = knn.knn_search_auto(qs.to(cuda), on_gpu, 10, metric=sim.COSINE)
    name = kb.KERNEL_INT8 if dtype == "int8" else kb.KERNEL_BF16
    assert dispatch.launches().get(name, 0) == before.get(name, 0) + 1
    s2, i2 = knn.knn_search_auto(qs, on_cpu, 10, metric=sim.COSINE)
    np.testing.assert_allclose(s.cpu().numpy(), s2.numpy(), atol=1e-4)
    assert (i.cpu() == i2).float().mean() > 0.9


def _random_partitions(g, dev, dtype, nlist, cap, d):
    """Random tiles of `dtype` with about a third of each partition's tail
    slots empty (scale 0, row -1)."""
    w = d // 2 if dtype == torch.uint8 else d
    if dtype in (torch.int8, torch.uint8):
        lo, hi = (-127, 128) if dtype == torch.int8 else (0, 256)
        parts = torch.randint(lo, hi, (nlist, cap, w), generator=g,
                              device=dev, dtype=torch.int32).to(dtype)
        scales = torch.rand(nlist, cap, generator=g, device=dev) / 50 + 1e-3
    else:
        parts = torch.randn(nlist, cap, w, generator=g, device=dev).to(dtype)
        scales = torch.ones(nlist, cap, device=dev)
    fill = torch.randint(2 * cap // 3, cap + 1, (nlist, 1), generator=g,
                         device=dev)
    valid = torch.arange(cap, device=dev)[None, :] < fill
    rows = torch.where(valid, torch.arange(nlist * cap, device=dev,
                                           dtype=torch.int32).view(nlist, cap),
                       torch.full((nlist, cap), -1, dtype=torch.int32,
                                  device=dev))
    zeros = torch.zeros(nlist, cap, device=dev)
    return IVFPartitions(
        centroids=torch.zeros(nlist, d, device=dev),
        centroid_sq=torch.zeros(nlist, device=dev), parts=parts,
        part_scales=torch.where(valid, scales, zeros), part_sq=zeros,
        part_rows=rows)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.uint8])
@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("nq", [1, 9])
def test_ivf_fused_kernels_match_plain_version(cuda, dtype, d, nq):
    """Both fused kernels on every tile type: NEG_INF at the same slots,
    the rest within 1e-5 of the largest |score| (f32 sum order). d = 100
    gives rows whose bytes are not a multiple of 16 (the scalar path) for
    every tile type but f32."""
    g = torch.Generator(device=cuda).manual_seed(d + nq)
    nlist, cap = 12, 150
    ivf = _random_partitions(g, cuda, dtype, nlist, cap, d)
    q = torch.randn(nq, d, generator=g, device=cuda)
    ids = torch.randint(0, nlist, (nq, 4), generator=g, device=cuda,
                        dtype=torch.int32)
    name = fused.KERNEL_INT4 if dtype == torch.uint8 else fused.KERNEL_DENSE
    before = dispatch.launches().get(name, 0)
    got = fused.probe_board(q, ivf, ids)
    torch.cuda.synchronize()
    assert dispatch.launches().get(name, 0) == before + 1
    want = fused.probe_board_reference(q, ivf, ids)
    neg = want <= -1e37
    assert neg.any() and torch.equal(got <= -1e37, neg)
    assert (got[neg] == want[neg]).all()
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    assert float((got[~neg] - want[~neg]).abs().max()) <= tol


def _expected_board(q, ivf, ids):
    """The plain version over the in-range probe ids, NEG_INF across the
    rows of out-of-range ones (the kernels' rule)."""
    nlist = ivf.parts.shape[0]
    bad = (ids < 0) | (ids >= nlist)
    want = fused.probe_board_reference(q, ivf, ids.clamp(0, nlist - 1))
    return torch.where(bad[:, :, None], torch.full_like(want, -3.0e38), want)


def _check_board(got, want):
    neg = want <= -1e37
    assert torch.equal(got <= -1e37, neg)
    assert (got[neg] == want[neg]).all()
    if not bool(neg.all()):
        tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
        assert float((got[~neg] - want[~neg]).abs().max()) <= tol


def _kernel(dtype):
    return fused.KERNEL_INT4 if dtype == torch.uint8 else fused.KERNEL_DENSE


def _grouped_launch(q, ivf, ids):
    """probe_board, asserting it took the grouped variant once."""
    key = f"{_kernel(ivf.parts.dtype)}/{fused.VARIANT_GROUPED}"
    before = dispatch.variant_launches().get(key, 0)
    got = fused.probe_board(q, ivf, ids)
    torch.cuda.synchronize()
    assert dispatch.variant_launches().get(key, 0) == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [
    *[(dt, d) for dt in (torch.bfloat16, torch.int8) for d in (64, 768, 960)],
    *[(torch.uint8, d) for d in (32, 64, 96, 288, 768)]])
@pytest.mark.parametrize("nprobe", [1, 4, 32])
@pytest.mark.parametrize("nq", [1, 9, 300])
def test_ivf_grouped_matches_plain_version(cuda, dtype, d, nprobe, nq):
    """The grouped variants of ivf_fused_dense and ivf_fused_int4 at cap
    300 (two full 128-row chunks and a ragged one): NEG_INF at the same
    slots, the rest within 1e-5 of the largest |score|; at Q=300, nprobe 32
    each of the 40 partitions is probed ~240 times (8 items of at most 32
    entries). int4 D=32, 64, 96 and 288 (16-144 bytes) end in a partial
    128-byte step, whose zero-filled bytes widen to level -8."""
    g = torch.Generator(device=cuda).manual_seed(d + nq + nprobe)
    nlist, cap = 40, 300
    ivf = _random_partitions(g, cuda, dtype, nlist, cap, d)
    q = torch.randn(nq, d, generator=g, device=cuda)
    ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=cuda,
                        dtype=torch.int32)
    _check_board(_grouped_launch(q, ivf, ids), _expected_board(q, ivf, ids))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.uint8])
@pytest.mark.parametrize("case", ["skewed", "duplicates", "out_of_range",
                                  "all_out_of_range"])
@pytest.mark.parametrize("nq", [1, 70])
def test_ivf_grouped_hard_probe_ids(cuda, dtype, case, nq):
    """Every query probing the same partitions (one partition with 70
    entries: three items), one partition named several times by one
    query, and ids outside [0, nlist) (-1, nlist, 2^30; their rows all
    NEG_INF, on the plan path and the direct one)."""
    g = torch.Generator(device=cuda).manual_seed(len(case) + nq)
    nlist, cap, nprobe, d = 12, 200, 8, 96
    ivf = _random_partitions(g, cuda, dtype, nlist, cap, d)
    q = torch.randn(nq, d, generator=g, device=cuda)
    ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=cuda,
                        dtype=torch.int32)
    if case == "skewed":
        ids[:, :3] = torch.tensor([2, 5, 11], dtype=torch.int32)
    elif case == "duplicates":
        ids[:, 1:5] = ids[:, :1]
    else:
        bad = torch.tensor([-1, nlist, 1 << 30], dtype=torch.int32,
                           device=cuda)
        pick = torch.arange(nq * nprobe, device=cuda).view(nq, nprobe) % 3
        if case == "all_out_of_range":
            ids = bad[pick]
        else:
            ids[:, ::3] = bad[pick[:, ::3]]
    _check_board(_grouped_launch(q, ivf, ids), _expected_board(q, ivf, ids))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 64, "grouped"), (torch.int8, 64, "grouped"),
    (torch.float32, 64, "simt"), (torch.bfloat16, 100, "simt"),
    (torch.int8, 100, "simt"), (torch.float32, 100, "simt"),
    (torch.uint8, 64, "grouped"), (torch.uint8, 100, "simt")])
@pytest.mark.parametrize("nq", [1, 9])
def test_ivf_dense_counts_its_variant(cuda, dtype, d, variant, nq):
    """Each ivf_fused_dense and ivf_fused_int4 launch counts once, under
    the variant its plan names (int4 D=100: 50-byte rows, simt)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    ivf = _random_partitions(g, cuda, dtype, 12, 150, d)
    ids = torch.randint(0, 12, (nq, 4), generator=g, device=cuda,
                        dtype=torch.int32)
    dispatch.reset_launches()
    fused.probe_board(torch.randn(nq, d, device=cuda), ivf, ids)
    assert dispatch.launches() == {_kernel(dtype): 1}
    assert dispatch.variant_launches() == {f"{_kernel(dtype)}/{variant}": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nprobe,nlist,hot", [
    (1, 1, 1, False), (9, 4, 12, False), (70, 8, 12, True),
    (256, 32, 1024, False), (256, 32, 1024, True), (300, 7, 32768, False),
    (3000, 64, 100, True)])
def test_ivf_probe_plan_matches_plain_version(cuda, nq, nprobe, nlist, hot):
    """The plan kernel against probe_plan_reference: the same items, and
    the same entries within each partition (as sets: the kernel scatters
    with atomics); out-of-range ids set apart."""
    g = torch.Generator(device=cuda).manual_seed(nq + nlist)
    ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=cuda,
                        dtype=torch.int32)
    if hot:
        ids[:, 0] = nlist // 2
        ids[::5, -1] = -1
    entries, items = fused.probe_plan(ids, nlist)
    want_e, want_i, _ = fused.probe_plan_reference(ids.cpu(), nlist)
    assert torch.equal(items.cpu(), want_i)
    flat, n = ids.reshape(-1).long().cpu(), ids.numel()

    def by_partition(e):
        e = e.long().cpu()
        return torch.sort(flat[e] * n + e).values

    assert torch.equal(by_partition(entries), by_partition(want_e))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8])
def test_ivf_grouped_rejected_plan_raises(cuda, monkeypatch, dtype):
    """A CUDA launch whose plan does not cover the shape raises: the C
    entry rejects it, and nothing falls back to simt or the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    ivf = _random_partitions(g, cuda, dtype, 12, 150, 64)
    ids = torch.randint(0, 12, (9, 4), generator=g, device=cuda,
                        dtype=torch.int32)
    plan = fused.launch_plan(9, 4, 12, 150, 64, dtype)
    short = plan._replace(item_bound=plan.item_bound - 1)
    monkeypatch.setattr(fused, "launch_plan", lambda *a: short)
    with pytest.raises(RuntimeError,
                       match=f"{_kernel(dtype)} launch failed"):
        fused.probe_board(torch.randn(9, 64, device=cuda), ivf, ids)


@pytest.mark.gpu
@pytest.mark.parametrize("options", [{"type": "ivf"}, {"type": "int8_ivf"},
                                     {"type": "int4_ivf"}])
def test_ivf_store_on_cuda_launches_kernel_and_matches_cpu(cuda, options):
    """One layout (exported by the CPU store, restored into the CUDA one)
    searched on both: the same rows where scores are clear of ties, and one
    fused launch per search on the card."""
    from elasticsearch_tpu_torch.index import mapping, segment
    from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((4000, 64)).astype(np.float32)
    seg = segment.Segment(0, 0, [str(i) for i in range(4000)], [None] * 4000,
                          {"v": (vecs, np.ones(4000, dtype=bool))})
    reader = segment.ShardReader([segment.SegmentView(seg)])
    fields = mapping.MapperService({"properties": {"v": {
        "type": "dense_vector", "dims": 64,
        "index_options": dict(options, nlist=32, nprobe=8)}}}).vector_fields()
    on_cpu = VectorStoreShard(device="cpu")
    on_cpu.sync(reader, fields)
    on_gpu = VectorStoreShard(device=cuda)
    on_gpu.restore_ivf_layout(on_cpu.export_ivf_layout())
    on_gpu.sync(reader, fields)
    name = (fused.KERNEL_INT4 if options["type"] == "int4_ivf"
            else fused.KERNEL_DENSE)
    agree = []
    for q in rng.standard_normal((5, 64)).astype(np.float32):
        before = dispatch.launches().get(name, 0)
        rows, raw = on_gpu.search("v", q, 10)
        assert dispatch.launches().get(name, 0) == before + 1
        want_rows, want_raw = on_cpu.search("v", q, 10)
        np.testing.assert_allclose(raw, want_raw, atol=1e-4)
        agree.append(np.mean(rows == want_rows))
    assert np.mean(agree) > 0.9
    assert on_gpu.knn_stats["fused_probe_searches"] == 5


@pytest.mark.gpu
@pytest.mark.parametrize("options", [{"type": "flat"}, {"type": "int8_ivf"}])
def test_sharded_index_on_cuda_launches_each_shard_and_matches_cpu(
        cuda, options, monkeypatch):
    """A 3-shard index loaded alike on a CPU node and a CUDA node (each
    shard's IVF layout carried from the CPU): every search launches its
    kernel once a shard on the card, and the merged hits match the CPU's
    where scores are clear of ties. Every corpus pads to the binned tile,
    as one of 8,192 rows or more does on the card, so the flat shards of
    both nodes take the binned route (its plain version on the CPU)."""
    from elasticsearch_tpu_torch.node import Node

    monkeypatch.setattr(knn, "preferred_pad_multiple",
                        lambda n, metric, device: knn.BINNED_TILE)

    rng = np.random.default_rng(5)
    n = 6000
    vecs = rng.standard_normal((n, 64)).astype(np.float32)
    body = {"settings": {"number_of_shards": 3, "index.knn.nlist": 16,
                         "index.knn.nprobe": 4},
            "mappings": {"properties": {"v": {
                "type": "dense_vector", "dims": 64, "similarity": "cosine",
                "index_options": options}}}}
    nodes = []
    for device in ("cpu", cuda):
        node = Node(device=device)
        node.create_index("s", body)
        if nodes:
            for cpu_shard, shard in zip(nodes[0].index("s").shards,
                                        node.index("s").shards):
                shard.vector_store.restore_ivf_layout(
                    cpu_shard.vector_store.export_ivf_layout())
        node.index("s").index_many([str(i) for i in range(n)],
                                   vectors={"v": vecs})
        node.refresh("s")
        nodes.append(node)
    name = (kb.KERNEL_BF16 if options["type"] == "flat"
            else fused.KERNEL_DENSE)
    agree = []
    for q in rng.standard_normal((5, 64)).astype(np.float32):
        body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10,
                        "num_candidates": 50}, "size": 10}
        before = dispatch.launches().get(name, 0)
        got = nodes[1].search("s", body)["hits"]["hits"]
        assert dispatch.launches().get(name, 0) == before + 3
        want = nodes[0].search("s", body)["hits"]["hits"]
        np.testing.assert_allclose([h["_score"] for h in got],
                                   [h["_score"] for h in want], atol=1e-3)
        agree.append(np.mean([a["_id"] == b["_id"]
                              for a, b in zip(got, want)]))
    assert np.mean(agree) > 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("options", [None, {"type": "int8_flat",
                                            "rescore": True},
                                     {"type": "int4_flat"}])
def test_store_pipelined_route_on_cuda(cuda, options):
    """The exhaustive route's dispatch stage leaves its boards in flight:
    pinned host copies behind an event, landed by `finalize_many` as
    `search_many` lands them; 8 threads through the combining batcher get
    the batch's answers (the same rows where scores are clear of ties)."""
    import threading
    from elasticsearch_tpu_torch.index import mapping, segment
    from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

    rng = np.random.default_rng(11)
    n, d = 20000, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    seg = segment.Segment(0, 0, [str(i) for i in range(n)], [None] * n,
                          {"v": (vecs, np.ones(n, dtype=bool))})
    reader = segment.ShardReader([segment.SegmentView(seg)])
    field = {"type": "dense_vector", "dims": d}
    if options:
        field["index_options"] = options
    store = VectorStoreShard(device=cuda)
    store.sync(reader, mapping.MapperService(
        {"properties": {"v": field}}).vector_fields())
    queries = list(rng.standard_normal((8, d)).astype(np.float32))
    handle = store.search_many_async("v", queries, 10)
    kind, payload, _phases = handle[:3]
    assert kind == "pending"
    assert payload[1].is_pinned() and payload[2].is_pinned()
    assert isinstance(payload[3], torch.cuda.Event)
    got = store.finalize_many(handle)
    want = store.search_many("v", queries, 10)
    for (gr, gs), (wr, ws) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gs, ws)
    results = [None] * 8
    barrier = threading.Barrier(8)

    def run(i):
        barrier.wait(10)
        results[i] = store.search("v", queries[i], 10)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for (rows, raw), (wr, ws) in zip(results, want):
        np.testing.assert_allclose(raw, ws, atol=1e-4)
        clear = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                           np.abs(np.diff(ws, append=-np.inf))) > 1e-4
        np.testing.assert_array_equal(rows[clear], wr[clear])
    sched = store.scheduler_stats()
    assert sched["requests"] == 8 and sched["pipelined_batches"] >= 1
    assert store.queued_requests() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("block_size", [None, 4096])
def test_exact_route_with_a_per_query_mask_on_cuda(cuda, block_size):
    """`knn_search` with a [Q, N] mask on the card, single-block and
    blocked, against the same call on the CPU."""
    from elasticsearch_tpu_torch.ops import knn as knn_ops
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((16384, 64)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    mask = torch.from_numpy(rng.random((5, 16384)) < 0.05)
    mask[3] = False
    got = knn_ops.knn_search(
        q.to(cuda), knn_ops.build_corpus(vecs, device=cuda), 10,
        filter_mask=mask.to(cuda), block_size=block_size)
    want = knn_ops.knn_search(q, knn_ops.build_corpus(vecs, device="cpu"),
                              10, filter_mask=mask, block_size=block_size)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               atol=2e-5)
    ids = got[1].cpu().numpy()
    ok = got[0].cpu().numpy() > -1e37
    assert not ok[3].any()
    assert all(mask[i, ids[i][ok[i]]].all() for i in range(5))


@pytest.mark.gpu
@pytest.mark.parametrize("options", [None, {"type": "int8_flat",
                                            "rescore": True},
                                     {"type": "int4_flat"}])
def test_filtered_batch_through_the_store_on_cuda(cuda, options):
    """A batch mixing filtered and unfiltered requests on the card: the
    mask goes up from pinned memory, no binned kernel launches, and the
    hits equal the CPU store's (same rows where scores are clear of ties),
    every filtered hit inside its filter."""
    from elasticsearch_tpu_torch.index import mapping, segment
    from elasticsearch_tpu_torch.vectors.store import VectorStoreShard

    rng = np.random.default_rng(17)
    n, d = 20000, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    seg = segment.Segment(0, 0, [str(i) for i in range(n)], [None] * n,
                          {"v": (vecs, np.ones(n, dtype=bool))})
    reader = segment.ShardReader([segment.SegmentView(seg)])
    field = {"type": "dense_vector", "dims": d}
    if options:
        field["index_options"] = options
    fields = mapping.MapperService({"properties": {"v": field}}) \
        .vector_fields()
    on_cpu, on_gpu = VectorStoreShard(device="cpu"), \
        VectorStoreShard(device=cuda)
    on_cpu.sync(reader, fields)
    on_gpu.sync(reader, fields)
    queries = list(rng.standard_normal((6, d)).astype(np.float32))
    filters = [None, np.sort(rng.choice(n, 900, replace=False)),
               np.sort(rng.choice(n, 4, replace=False)), None,
               np.zeros(0, dtype=np.int64),
               np.arange(0, n, 3, dtype=np.int64)]
    dispatch.reset_launches()
    handle = on_gpu.search_many_async("v", queries, 10, filter_rows=filters)
    assert handle[0] == "pending" and handle[1][1].is_pinned()
    got = on_gpu.finalize_many(handle)
    assert not any(dispatch.launches().values())
    want = on_cpu.search_many("v", queries, 10, filter_rows=filters)
    for fr, (rows, raw), (wr, ws) in zip(filters, got, want):
        assert len(rows) == len(wr) == (10 if fr is None
                                        else min(10, len(fr)))
        np.testing.assert_allclose(raw, ws, atol=1e-4)
        clear = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                           np.abs(np.diff(ws, append=-np.inf))) > 1e-4
        np.testing.assert_array_equal(rows[clear], wr[clear])
        if fr is not None:
            assert np.isin(rows, fr).all()


def _random_token_tile(g, dev, dtype, n, n_pad, cap, w):
    """A [n_pad, cap, w] tile of n ragged docs (1..cap valid slots each,
    scale 0 on the rest and on rows n..n_pad, the padding rows)."""
    counts = torch.randint(1, cap + 1, (n,), generator=g, device=dev)
    valid = torch.zeros(n_pad, cap, dtype=torch.bool, device=dev)
    valid[:n] = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    if dtype in (torch.int8, torch.uint8):
        lo, hi = (-127, 128) if dtype == torch.int8 else (0, 256)
        toks = torch.randint(lo, hi, (n_pad, cap, w), generator=g,
                             device=dev, dtype=torch.int32).to(dtype)
        scales = torch.rand(n_pad, cap, generator=g, device=dev) / 100 + 1e-3
    else:
        toks = (torch.randn(n_pad, cap, w, generator=g, device=dev)
                / w ** 0.5).to(dtype)
        scales = torch.ones(n_pad, cap, device=dev)
    return toks, torch.where(valid, scales, torch.zeros_like(scales))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.uint8])
@pytest.mark.parametrize("tq,cap", [(8, 8), (32, 256), (128, 100)])
@pytest.mark.parametrize("nq", [1, 19])
def test_maxsim_kernels_match_plain_version(cuda, dtype, tq, cap, nq):
    """Both MaxSim kernels on every tile type: candidates on the padding
    row score <= -1e38 in both, the rest agree within 1e-5 of the largest
    |score| (bf16 x bf16 products are exact; f32 sum order differs)."""
    g = torch.Generator(device=cuda).manual_seed(tq + cap + nq)
    n, n_pad, d = 300, 512, 128
    w = d // 2 if dtype == torch.uint8 else d
    toks, scales = _random_token_tile(g, cuda, dtype, n, n_pad, cap, w)
    q = torch.randn(nq, tq, d, generator=g, device=cuda)
    q[:, tq // 2 + 1:] = 0                 # zero-padded query token rows
    ids = torch.randint(0, n, (nq, 40), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[:, -3:] = n                        # the padding row
    name = maxsim.KERNEL_INT4 if dtype == torch.uint8 else maxsim.KERNEL_DENSE
    before = dispatch.launches().get(name, 0)
    got = maxsim.maxsim_rescore(ids, q, toks, scales)
    torch.cuda.synchronize()
    assert dispatch.launches().get(name, 0) == before + 1
    want = maxsim.maxsim_reference(ids, q, toks, scales)
    neg = want <= -1e38
    assert torch.equal(got <= -1e38, neg) and bool(neg[:, -3:].all())
    assert int(neg.sum()) == 3 * nq
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    assert float((got[~neg] - want[~neg]).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.uint8])
@pytest.mark.parametrize("tq,d", [(128, 768), (128, 1024), (300, 128),
                                  (256, 768)])
def test_maxsim_kernels_wide_queries_and_dims(cuda, dtype, tq, d):
    """Query and width beyond one staged block: more than 128 query rows
    (row groups) and 768-1024 dims (feature slabs) launch and agree with
    the plain version within 1e-5 of the largest |score|."""
    g = torch.Generator(device=cuda).manual_seed(tq + d)
    n, n_pad, cap = 200, 256, 100
    w = d // 2 if dtype == torch.uint8 else d
    toks, scales = _random_token_tile(g, cuda, dtype, n, n_pad, cap, w)
    q = torch.randn(3, tq, d, generator=g, device=cuda)
    q[:, tq - 5:] = 0                      # zero-padded query token rows
    ids = torch.randint(0, n, (3, 24), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[:, -2:] = n                        # the padding row
    name = maxsim.KERNEL_INT4 if dtype == torch.uint8 else maxsim.KERNEL_DENSE
    before = dispatch.launches().get(name, 0)
    got = maxsim.maxsim_rescore(ids, q, toks, scales)
    torch.cuda.synchronize()
    assert dispatch.launches().get(name, 0) == before + 1
    want = maxsim.maxsim_reference(ids, q, toks, scales)
    neg = want <= -1e38
    assert torch.equal(got <= -1e38, neg) and int(neg.sum()) == 6
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    assert float((got[~neg] - want[~neg]).abs().max()) <= tol


def _maxsim_kernel(dtype):
    return maxsim.KERNEL_INT4 if dtype == torch.uint8 else maxsim.KERNEL_DENSE


def _check_maxsim(got, want):
    neg = want <= -1e38
    assert torch.equal(got <= -1e38, neg)
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    assert float((got[~neg] - want[~neg]).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.uint8])
@pytest.mark.parametrize("tq", [1, 8, 20, 32, 33, 128])
def test_maxsim_counts_its_variant(cuda, dtype, tq):
    """Each launch counts once, under the variant its plan names: warp for
    bf16, int8 and int4 tiles at Tq <= 32, wmma for f32 tiles and wider
    queries; both agree with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(tq)
    w = 64 if dtype == torch.uint8 else 128
    toks, scales = _random_token_tile(g, cuda, dtype, 200, 256, 64, w)
    q = torch.randn(5, tq, 128, generator=g, device=cuda)
    ids = torch.randint(0, 201, (5, 24), generator=g, device=cuda,
                        dtype=torch.int32)
    dispatch.reset_launches()
    got = maxsim.maxsim_rescore(ids, q, toks, scales)
    torch.cuda.synchronize()
    variant = maxsim.VARIANT_WARP if dtype != torch.float32 and tq <= 32 \
        else maxsim.VARIANT_WMMA
    assert maxsim.launch_plan(5, 24, tq, 64, w, dtype).variant == variant
    assert dispatch.launches() == {_maxsim_kernel(dtype): 1}
    assert dispatch.variant_launches() == {
        f"{_maxsim_kernel(dtype)}/{variant}": 1}
    _check_maxsim(got, maxsim.maxsim_reference(ids, q, toks, scales))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.uint8])
@pytest.mark.parametrize("cap", [20, 100, 256, 300])
@pytest.mark.parametrize("nq", [1, 19, 300])
def test_maxsim_warp_hard_spans(cuda, dtype, cap, nq):
    """The warp variant's span: docs with a zero-scale slot inside their
    span (still masked), docs with no valid slot, and ids outside [0,
    N_pad) score as the padding row (<= -1e38; the plain version gets the
    padding row in their place); caps that are not a multiple of 16, and
    past the 256 scales a warp prefetches."""
    g = torch.Generator(device=cuda).manual_seed(cap + nq)
    n, n_pad = 300, 512
    w = 64 if dtype == torch.uint8 else 128
    toks, scales = _random_token_tile(g, cuda, dtype, n, n_pad, cap, w)
    counts = (scales > 0).sum(1)
    holes = torch.nonzero(counts[:100] > 1).flatten()
    slot = (torch.rand(len(holes), generator=g, device=cuda)
            * (counts[holes] - 1).float()).long()
    scales[holes, slot] = 0.0
    scales[100:120] = 0.0
    q = torch.randn(nq, 32, 128, generator=g, device=cuda)
    q[:, 20:] = 0                          # zero-padded query token rows
    ids = torch.randint(0, n, (nq, 40), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[:, 1] = 100 + torch.arange(nq, device=cuda) % 20
    ids[0, 2:7] = torch.tensor([-1, n_pad, n_pad + 3, 2 ** 31 - 1, -2 ** 31],
                               dtype=torch.int32, device=cuda)
    oob = (ids < 0) | (ids >= n_pad)
    dispatch.reset_launches()
    got = maxsim.maxsim_rescore(ids, q, toks, scales)
    torch.cuda.synchronize()
    assert dispatch.variant_launches() == {
        f"{_maxsim_kernel(dtype)}/{maxsim.VARIANT_WARP}": 1}
    want = maxsim.maxsim_reference(
        torch.where(oob, torch.full_like(ids, n), ids), q, toks, scales)
    assert bool((got[oob] <= -1e38).all()) and bool((got[:, 1] <= -1e38).all())
    _check_maxsim(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.uint8])
@pytest.mark.parametrize("d", [32, 64, 96, 160, 256, 768, 1024])
def test_maxsim_warp_row_widths(cuda, dtype, d):
    """The warp variant on every row width it takes: rows of a partial
    128-byte step (int8 D=32: 32 bytes; int4 D=96: 48, D=160: 80), whole
    steps and many of them, up to 64 KB of query fragments."""
    g = torch.Generator(device=cuda).manual_seed(d)
    w = d // 2 if dtype == torch.uint8 else d
    toks, scales = _random_token_tile(g, cuda, dtype, 150, 256, 40, w)
    q = torch.randn(7, 32, d, generator=g, device=cuda)
    ids = torch.randint(0, 151, (7, 30), generator=g, device=cuda,
                        dtype=torch.int32)
    dispatch.reset_launches()
    got = maxsim.maxsim_rescore(ids, q, toks, scales)
    torch.cuda.synchronize()
    assert dispatch.variant_launches() == {
        f"{_maxsim_kernel(dtype)}/{maxsim.VARIANT_WARP}": 1}
    _check_maxsim(got, maxsim.maxsim_reference(ids, q, toks, scales))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.float32])
def test_maxsim_rejected_plan_raises(cuda, monkeypatch, dtype):
    """A CUDA launch whose plan does not cover the shape raises: the C
    entry rejects shared memory other than its variant's own, and a warp
    plan for f32 tiles; nothing falls back."""
    g = torch.Generator(device=cuda).manual_seed(4)
    w = 64 if dtype == torch.uint8 else 128
    toks, scales = _random_token_tile(g, cuda, dtype, 50, 64, 32, w)
    ids = torch.randint(0, 50, (3, 8), generator=g, device=cuda,
                        dtype=torch.int32)
    plan = maxsim.launch_plan(3, 8, 32, 32, w, dtype)
    bad = (plan._replace(variant=maxsim.VARIANT_WARP, smem_bytes=8192)
           if dtype == torch.float32 else
           plan._replace(smem_bytes=plan.smem_bytes - 8))
    monkeypatch.setattr(maxsim, "launch_plan", lambda *a: bad)
    with pytest.raises(RuntimeError,
                       match=f"{_maxsim_kernel(dtype)} launch failed"):
        maxsim.maxsim_rescore(ids, torch.randn(3, 32, 128, device=cuda),
                              toks, scales)


@pytest.mark.gpu
@pytest.mark.parametrize("encoding", ["bf16", "int8", "int4"])
def test_late_interaction_on_cuda_launches_kernel_and_matches_cpu(
        cuda, encoding):
    """One reader synced into a CUDA and a CPU late-interaction store: the
    same tile bytes, the same rows where scores are clear of ties, and one
    MaxSim launch per search on the card."""
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.vectors.late_interaction import (
        LateInteractionShard)

    rng = np.random.default_rng(9)
    ms = MapperService({"properties": {"c": {
        "type": "rank_vectors", "dims": 96, "encoding": encoding}}})
    eng = Engine(ms)
    counts = rng.integers(3, 40, 3000)
    eng.index_many([str(i) for i in range(3000)], token_vectors={"c": (
        rng.standard_normal((int(counts.sum()), 96)).astype(np.float32),
        counts)})
    reader = eng.refresh()
    on_gpu = LateInteractionShard(device=cuda)
    on_cpu = LateInteractionShard(device="cpu")
    lf = on_gpu.field(reader, ms.get("c"))
    lf_cpu = on_cpu.field(reader, ms.get("c"))
    assert torch.equal(lf.tile.cpu(), lf_cpu.tile)
    name = maxsim.KERNEL_INT4 if encoding == "int4" else maxsim.KERNEL_DENSE
    for _ in range(3):
        qt = rng.standard_normal((32, 96)).astype(np.float32)
        before = dispatch.launches().get(name, 0)
        (rows, scores), = on_gpu.search_batch(reader, ms.get("c"),
                                              [(qt, 1.0)], 10)
        assert dispatch.launches().get(name, 0) == before + 1
        (want_rows, want_scores), = on_cpu.search_batch(
            reader, ms.get("c"), [(qt, 1.0)], 10)
        np.testing.assert_allclose(scores, want_scores, rtol=1e-5)
        assert np.mean(rows == want_rows) > 0.9


def _bm25_field(device, dtype, n_docs, seed):
    """A LexicalField over an engine of `n_docs` Zipf-worded text docs
    (two segments, a tombstone), on `device`."""
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.ops import bm25
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 401)
    p /= p.sum()
    docs = [{"body": " ".join(f"w{r}" for r in rng.choice(
        400, int(rng.integers(1, 60)), p=p))} for _ in range(n_docs)]
    engine = Engine(MapperService({"properties": {"body": {"type": "text"}}}))
    half = n_docs // 2
    engine.index_many([str(i) for i in range(half)], docs[:half])
    engine.refresh()
    engine.index_many([str(i) for i in range(half, n_docs)], docs[half:])
    engine.index("3", docs[4])
    lf = bm25.LexicalField("body", dtype, device=device)
    lf.sync(engine.refresh())
    return lf


def _board_args(field, queries, required, dev):
    """`bm25_board`'s arguments up to k for a batch, on `dev`."""
    pos_starts, runs = field.plan_positions(queries)
    return (torch.from_numpy(pos_starts).to(dev),
            torch.from_numpy(runs).to(dev),
            torch.as_tensor(np.asarray(required, dtype=np.int32), device=dev),
            field._device_tile_first(), *field._device_arrays())


def _same_window(got, want):
    """f32 bits and slots: the finite prefix, then -inf / -1."""
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool(((got[1] == -1) == (got[0] == -float("inf"))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq", [1, 9, 40])
def test_bm25_board_matches_plain_version(cuda, dtype, nq):
    """bm25_board on the card against its plain version on the same CUDA
    tensors, windows bit for bit at k = 1, 50 and every slot, with
    repeated and out-of-vocabulary words, a query with no tile, boosts and
    required 1-3; one call (two launches) a batch; then the whole board
    route against the CPU's, rows and f32 bits."""
    from elasticsearch_tpu_torch.ops import bm25
    lf = _bm25_field(cuda, dtype, 3000, nq)
    cpu = _bm25_field("cpu", dtype, 3000, nq)
    rng = np.random.default_rng(nq)
    queries = [([f"w{r}" for r in rng.integers(0, 60, 5)], 1.0 + i % 3)
               for i in range(nq)]
    queries[0][0].append(queries[0][0][0])
    if nq > 2:
        queries[1][0].append("oov")
        queries[2] = (["oov"], 1.0)
    required = [1 + i % 3 for i in range(nq)]
    args = _board_args(lf, queries, required, cuda)
    for k in (1, 50, lf.n_slots):
        before = dispatch.launches().get(bm25.KERNEL, 0)
        got = bm25.bm25_board(*args, k, lf.n_slots)
        assert dispatch.launches().get(bm25.KERNEL, 0) == before + 1
        _same_window(got, bm25.bm25_board_reference(*args, k, lf.n_slots))
    got = lf.search_batch(queries, 50, required=required)
    want = cpu.search_batch(queries, 50, required=required)
    for (gr, gs), (wr, ws) in zip(got, want):
        assert np.array_equal(gr, wr)
        assert np.array_equal(gs.view(np.int32), ws.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("range_slots", [32, 256, 1024])
def test_bm25_board_small_ranges_match_plain_version(cuda, dtype,
                                                     range_slots):
    """Forced small ranges on a small field: terms span many ranges, k runs
    past a range (so a range's select keeps every match and the merge
    sorts past shared memory at k = every slot), many tied impacts, and a
    query of 700 words (past the kernel's 512 positions held at once):
    the plain version's and the ranged plain version's window."""
    from elasticsearch_tpu_torch.ops import bm25
    lf = _bm25_field(cuda, dtype, 3000, 5)
    rng = np.random.default_rng(range_slots)
    queries = [([f"w{r}" for r in rng.integers(0, 80, 6)], 1.5),
               (["w0"], 1.0), (["w1", "w0", "w2"], 0.5),
               ([f"w{r}" for r in rng.integers(0, 300, 700)], 1.0)]
    for required in ([1, 1, 1, 1], [2, 1, 3, 40]):
        args = _board_args(lf, queries, required, cuda)
        for k in (7, range_slots + 3, lf.n_slots):
            got = bm25.bm25_board(*args, k, lf.n_slots,
                                  range_slots=range_slots)
            want = bm25.bm25_board_reference(*args, k, lf.n_slots)
            _same_window(got, want)
            if k < lf.n_slots and range_slots == 1024:
                _same_window(got, bm25.bm25_board_ranged_reference(
                    *args, k, lf.n_slots, range_slots=range_slots))


@pytest.mark.gpu
def test_bm25_board_raises_on_bad_inputs(cuda):
    """On CUDA tensors the wrapper launches or raises: it never runs the
    plain version there."""
    from elasticsearch_tpu_torch.ops import bm25
    lf = _bm25_field(cuda, "int8", 500, 3)
    ps, runs, req, first, slots, imp, scales = _board_args(
        lf, [(["w1", "w2"], 1.0)], [1], cuda)
    with pytest.raises(ValueError, match="tile scales"):
        bm25.bm25_board(ps, runs, req, first, slots, imp, None, 10,
                        lf.n_slots)
    with pytest.raises(ValueError, match="one CUDA device"):
        bm25.bm25_board(ps, runs.cpu(), req, first, slots, imp, scales, 10,
                        lf.n_slots)
    with pytest.raises(ValueError, match="shape"):
        bm25.bm25_board(ps, runs[:2], req, first, slots, imp, scales, 10,
                        lf.n_slots)
    with pytest.raises(ValueError, match="k"):
        bm25.bm25_board(ps, runs, req, first, slots, imp, scales,
                        lf.n_slots + 1, lf.n_slots)
    with pytest.raises(ValueError, match="range_slots"):
        bm25.bm25_board(ps, runs, req, first, slots, imp, scales, 10,
                        lf.n_slots, range_slots=48)
    # a plan the kernels would read out of bounds is refused on its host
    # copy, before the upload
    host_ps, host_runs = ps.cpu().numpy(), runs.cpu().numpy()
    bm25.check_plan(host_ps, host_runs, len(lf.tile_slots))
    for bad_ps, bad_runs in ((host_ps[::-1].copy(), host_runs),
                             (host_ps + 1, host_runs),
                             (host_ps, host_runs + [[len(lf.tile_slots)],
                                                    [0], [0]])):
        with pytest.raises(ValueError, match="plan|pos_starts"):
            bm25.check_plan(bad_ps, bad_runs, len(lf.tile_slots))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_bm25_window_zero_is_empty_on_the_card(cuda, dtype):
    """`rank_window_size: 0` gives every query an empty window on the card
    as on the host route, and calls no kernel."""
    from elasticsearch_tpu_torch.ops import bm25, dispatch
    lf = _bm25_field(cuda, dtype, 500, 3)
    queries = [(["w1", "w2"], 1.0), (["w0"], 2.0)]
    before = dispatch.launches().get(bm25.KERNEL, 0)
    for route in ("device", "host"):
        out = lf.search_batch(queries, 0, route=route)
        assert [(len(r), len(s)) for r, s in out] == [(0, 0), (0, 0)]
    assert dispatch.launches().get(bm25.KERNEL, 0) == before


def _sparse_field(device, dtype, n_docs, seed):
    """A SparseField over an engine of `n_docs` learned-sparse maps (30-120
    Zipf-drawn tokens of 3,000, weights in (0, 3]; two segments, a
    tombstone), on `device`."""
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.ops import sparse
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 3001)
    p /= p.sum()
    docs = []
    for _ in range(n_docs):
        toks = rng.choice(3000, int(rng.integers(30, 121)), replace=False,
                          p=p)
        w = np.maximum(rng.uniform(0, 3, len(toks)).astype(np.float32), 1e-3)
        docs.append({"tokens": {f"t{t}": float(x) for t, x in zip(toks, w)}})
    engine = Engine(MapperService({"properties": {
        "tokens": {"type": "rank_features"}}}))
    half = n_docs // 2
    engine.index_many([str(i) for i in range(half)], docs[:half])
    engine.refresh()
    engine.index_many([str(i) for i in range(half, n_docs)], docs[half:])
    engine.index("3", docs[4])
    sf = sparse.SparseField("tokens", dtype, device=device)
    sf.sync(engine.refresh())
    return sf


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq", [1, 9, 40])
def test_bm25_board_sparse_layout_matches_plain_version(cuda, dtype, nq):
    """bm25_board on the learned-sparse layout (20-120 tokens a query and
    one of 300, every entry its token's own boost) against its plain
    version on the same CUDA tensors, windows bit for bit, one call a
    batch counted under the `sparse` variant; then the whole board route
    against the CPU's."""
    from elasticsearch_tpu_torch.ops import bm25, sparse
    sf = _sparse_field(cuda, dtype, 4000, nq)
    cpu = _sparse_field("cpu", dtype, 4000, nq)
    rng = np.random.default_rng(nq)
    queries = [({f"t{t}": float(rng.uniform(0.1, 2.0)) for t in
                 rng.choice(3200, int(rng.integers(20, 121)),
                            replace=False)}, 1.0 + 0.5 * (i % 3))
               for i in range(nq)]
    queries[-1] = ({f"t{t}": 1.0 for t in range(300)}, 0.75)
    args = _board_args(sf, queries, [1] * nq, cuda)
    key = f"{bm25.KERNEL}/{sparse.VARIANT}"
    for k in (100, 1000):
        before = dispatch.variant_launches().get(key, 0)
        got = bm25.bm25_board(*args, k, sf.n_slots, variant=sparse.VARIANT)
        assert dispatch.variant_launches().get(key, 0) == before + 1
        _same_window(got, bm25.bm25_board_reference(*args, k, sf.n_slots))
    before = dispatch.variant_launches().get(key, 0)
    got = sf.search_batch(queries, 100)
    assert dispatch.variant_launches().get(key, 0) == before + 1
    for (gr, gs), (wr, ws) in zip(got, cpu.search_batch(queries, 100)):
        assert np.array_equal(gr, wr)
        assert np.array_equal(gs.view(np.int32), ws.view(np.int32))


@pytest.mark.gpu
def test_sparse_hybrid_body_on_cuda_launches_the_board(cuda):
    """`rank: {rrf}` bodies with `sparse_vector` and `weighted_tokens`
    sub-searches (40, 120 and 300 tokens), on a CUDA node and a CPU node
    loaded alike: one sparse board call a request on the card (the two
    legs of a body share it), and the CPU node's hits; beside a `knn` leg,
    one call too."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import bm25, sparse
    rng = np.random.default_rng(9)
    n, d = 3000, 32
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    docs = [{"tokens": {f"t{t}": float(rng.uniform(0.01, 3.0))
                        for t in rng.choice(800, 60, replace=False)},
             "emb": vecs[i].tolist()} for i in range(n)]
    body = {"mappings": {"properties": {
        "tokens": {"type": "rank_features"},
        "emb": {"type": "dense_vector", "dims": d}}}}
    nodes = []
    for device in ("cpu", cuda):
        node = Node(device=device)
        node.create_index("s", body)
        node.index("s").index_many([str(i) for i in range(n)], docs)
        node.refresh("s")
        nodes.append(node)
    key = f"{bm25.KERNEL}/{sparse.VARIANT}"

    def tokens(width):
        return {f"t{t}": float(rng.uniform(0.1, 2.0))
                for t in rng.choice(900, width, replace=False)}

    for width in (40, 120, 300):
        req = {"sub_searches": [
            {"query": {"sparse_vector": {"field": "tokens",
                                         "query_vector": tokens(width)}}},
            {"query": {"weighted_tokens": {"tokens": {
                "tokens": tokens(width), "boost": 1.5}}}}],
            "rank": {"rrf": {}}, "size": 10}
        before = dispatch.variant_launches().get(key, 0)
        got = nodes[1].search("s", req)["hits"]["hits"]
        assert dispatch.variant_launches().get(key, 0) == before + 1
        want = nodes[0].search("s", req)["hits"]["hits"]
        assert [h["_id"] for h in got] == [h["_id"] for h in want]
        assert [h["_score"] for h in got] == [h["_score"] for h in want]
    req = {"sub_searches": [
        {"query": {"sparse_vector": {"field": "tokens",
                                     "query_vector": tokens(80)}}},
        {"query": {"knn": {"field": "emb", "query_vector": vecs[0].tolist(),
                           "k": 10, "num_candidates": 50}}}],
        "rank": {"rrf": {}}, "size": 10}
    before = dispatch.variant_launches().get(key, 0)
    nodes[1].search("s", req)
    assert dispatch.variant_launches().get(key, 0) == before + 1


def _cache_node(cuda, monkeypatch):
    """A 3-shard CUDA node: `emb` (bf16 flat, padded to the binned tile so
    unfiltered requests take the binned kernel), `tag` and `body` text."""
    from elasticsearch_tpu_torch.node import Node

    monkeypatch.setattr(knn, "preferred_pad_multiple",
                        lambda n, metric, device: knn.BINNED_TILE)
    rng = np.random.default_rng(41)
    n = 3000
    vecs = rng.standard_normal((n, 64)).astype(np.float32)
    words = np.array(["alpha", "beta", "gamma", "delta", "eps", "zeta"])
    node = Node(device=cuda)
    node.create_index("c", {
        "settings": {"number_of_shards": 3},
        "mappings": {"properties": {
            "emb": {"type": "dense_vector", "dims": 64,
                    "similarity": "cosine", "index_options": {"type": "flat"}},
            "tag": {"type": "keyword"}, "body": {"type": "text"}}}})
    node.index("c").index_many(
        [str(i) for i in range(n)],
        [{"tag": ["red", "blue"][i % 2],
          "body": " ".join(rng.choice(words, 4))} for i in range(n)],
        vectors={"emb": vecs})
    node.refresh("c")
    return node, rng


def _device_counts(node):
    from elasticsearch_tpu_torch.ops import bm25
    return (dict(dispatch.launches()), bm25.kernel_launches(),
            sum(s.vector_store.knn_stats["searches"]
                for s in node.index("c").shards))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unfiltered", "filtered", "hybrid"])
def test_request_cache_hit_launches_nothing_on_cuda(cuda, monkeypatch, case):
    """A repeated body is served by the device rung of the request cache:
    its answer is the uncached one and it launches no kernel (the launch
    counters, the BM25 library's kernel count and the stores' searches
    unchanged); after a refresh that changed a shard it runs again."""
    node, rng = _cache_node(cuda, monkeypatch)
    knn_spec = {"field": "emb", "query_vector": rng.standard_normal(64)
                .tolist(), "k": 10, "num_candidates": 50}
    if case == "filtered":
        knn_spec["filter"] = {"bool": {"filter": [{"term": {"tag": "red"}}]}}
    body = {"knn": knn_spec, "size": 10}
    if case == "hybrid":
        body.update(query={"match": {"body": "alpha gamma"}},
                    rank={"rrf": {}})

    def strip(resp):
        return {k: v for k, v in resp.items() if k != "took"}

    first = node.search("c", dict(body))
    counts = _device_counts(node)
    hits0 = node.caches.device_request.hits
    second = node.search("c", dict(body))
    assert node.caches.device_request.hits == hits0 + 1
    assert _device_counts(node) == counts
    uncached = node.search("c", dict(body, request_cache=False))
    assert strip(second) == strip(first) == strip(uncached)
    launched = _device_counts(node)
    assert launched != counts   # the opted-out request ran on the card
    node.index("c").index_many(["7"], [{"tag": "red", "body": "alpha"}],
                               vectors={"emb": rng.standard_normal(
                                   (1, 64)).astype(np.float32)})
    node.refresh("c")
    misses0 = node.caches.device_request.misses
    third = node.search("c", dict(body))
    assert node.caches.device_request.misses == misses0 + 1
    assert _device_counts(node) != launched
    assert strip(third) == strip(node.search(
        "c", dict(body, request_cache=False)))


def _doc_pair(cuda, monkeypatch):
    """A CUDA node and a CPU node behind their REST controllers, the bf16
    flat corpora padded to the binned tile so an unfiltered request takes
    the binned kernel, and the request cache's device rung off."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.actions import register_all
    from elasticsearch_tpu_torch.rest.controller import RestController

    monkeypatch.setattr(knn, "preferred_pad_multiple",
                        lambda n, metric, device: knn.BINNED_TILE)
    out = []
    for device in (cuda, "cpu"):
        # the device rung off: a body sent to `a` and then to `a,b` must
        # reach the card for both indices
        node = Node(device=device, settings={
            "search.request_cache.device_paths": "false"})
        rc = RestController()
        register_all(rc, node)
        out.append((node, rc))
    return out


def _req(rc, method, path, body=None, ndjson=False):
    import json
    raw = b"" if body is None else (
        b"\n".join(json.dumps(x).encode() for x in body) + b"\n" if ndjson
        else json.dumps(body).encode())
    return rc.dispatch(method, path, {}, raw)


def _same_hits(got, want, tol):
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert len(gh) == len(wh)
    ws = np.array([h["_score"] for h in wh])
    np.testing.assert_allclose([h["_score"] for h in gh], ws, atol=tol)
    gap = np.minimum(np.abs(np.diff(ws, prepend=np.inf)),
                     np.abs(np.diff(ws, append=-np.inf)))
    for j in np.nonzero(gap > tol)[0]:
        assert (gh[j]["_index"], gh[j]["_id"]) == \
            (wh[j]["_index"], wh[j]["_id"])


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_deletes_updates_and_union_on_cuda(cuda, monkeypatch, shards):
    """Bulk deletes and vector updates, a refresh, then kNN over one index
    and over `a,b`: the CUDA node answers as the CPU node does (scores
    within 1e-3, as the sharded case holds them), launches the binned kernel once a request
    and shard, never returns a deleted id, and `DELETE /{index}` frees the
    corpora's device memory."""
    import gc
    pair = _doc_pair(cuda, monkeypatch)
    rng = np.random.default_rng(43 + shards)
    vecs = {name: rng.standard_normal((3000, 64)).astype(np.float32)
            for name in ("a", "b")}
    for node, rc in pair:
        for name, v in vecs.items():
            assert _req(rc, "PUT", f"/{name}", {
                "settings": {"number_of_shards": shards},
                "mappings": {"properties": {"emb": {
                    "type": "dense_vector", "dims": 64,
                    "similarity": "cosine"}}}})[0] == 200
            node.index(name).index_many([str(i) for i in range(3000)],
                                        vectors={"emb": v})
        ops = [{"delete": {"_id": str(i)}} for i in range(0, 3000, 7)]
        for i in range(1, 3000, 101):
            if i % 7 == 0:
                continue        # deleted above
            ops += [{"update": {"_id": str(i)}},
                    {"doc": {"emb": vecs["a"][i - 1].tolist()}}]
        status, resp = _req(rc, "POST", "/a/_bulk", ops, ndjson=True)
        assert status == 200 and not resp["errors"]
        assert _req(rc, "POST", "/_refresh")[0] == 200
    gone = {str(i) for i in range(0, 3000, 7)}
    (gnode, grc), (_, crc) = pair
    for qi, q in enumerate(rng.standard_normal((8, 64)).astype(np.float32)):
        body = {"knn": {"field": "emb", "query_vector": q.tolist(),
                        "k": 10, "num_candidates": 50}, "size": 10}
        for path, n_idx in (("/a/_search", 1), ("/a,b/_search", 2)):
            dispatch.reset_launches()
            status, got = _req(grc, "POST", path, body)
            assert status == 200
            assert dispatch.launches().get(kb.KERNEL_BF16, 0) == \
                n_idx * shards
            _, want = _req(crc, "POST", path, body)
            _same_hits(got, want, 1e-3)
            assert not {h["_id"] for h in got["hits"]["hits"]
                        if h["_index"] == "a"} & gone
    gc.collect()
    before = torch.cuda.memory_allocated(cuda)
    corpus = sum(s.vector_store.field("emb").corpus.matrix.nbytes
                 for name in ("a", "b") for s in gnode.index(name).shards)
    for name in ("a", "b"):
        assert _req(grc, "DELETE", f"/{name}")[0] == 200
    gc.collect()
    assert before - torch.cuda.memory_allocated(cuda) >= 0.9 * corpus
    assert _req(grc, "POST", "/a/_search", body)[0] == 404


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_by_query_writes_on_cuda(cuda, monkeypatch, shards):
    """`_delete_by_query` and `_update_by_query` on a CUDA index answer as
    on a CPU node (counts, then kNN hits within 1e-3 and `_count`), the
    refresh they end with takes the generational path (no full rebuild),
    and a later kNN returns no deleted id: on the exact legs of the
    tombstoned generations, then, after `_forcemerge`, on the binned
    kernel once a shard."""
    pair = _doc_pair(cuda, monkeypatch)
    rng = np.random.default_rng(61 + shards)
    vecs = rng.standard_normal((3000, 64)).astype(np.float32)
    for node, rc in pair:
        assert _req(rc, "PUT", "/a", {
            "settings": {"number_of_shards": shards},
            "mappings": {"properties": {
                "emb": {"type": "dense_vector", "dims": 64,
                        "similarity": "cosine"},
                "tag": {"type": "keyword"}}}})[0] == 200
        node.index("a").index_many([str(i) for i in range(3000)],
                                   vectors={"emb": vecs})
        assert _req(rc, "POST", "/a/_refresh")[0] == 200
    (gnode, grc), (_, crc) = pair
    gone = [str(i) for i in range(0, 3000, 3)]
    bodies = [("/a/_delete_by_query", {"query": {"ids": {"values": gone}}}),
              ("/a/_update_by_query", {
                  "query": {"ids": {"values": [str(i) for i in
                                               range(1, 3000, 7)]}},
                  "script": {"source": "ctx._source.tag = 'seen'"}})]
    for path, body in bodies:
        before = [s.vector_store.segment_stats()["full_rebuilds"]
                  for s in gnode.index("a").shards]
        status, got = _req(grc, "POST", path, body)
        assert status == 200
        _, want = _req(crc, "POST", path, body)
        assert {k: v for k, v in got.items() if k != "took"} == \
            {k: v for k, v in want.items() if k != "took"}
        after = [s.vector_store.segment_stats()["full_rebuilds"]
                 for s in gnode.index("a").shards]
        assert after == before, (path, before, after)
    queries = rng.standard_normal((8, 64)).astype(np.float32)
    for merged in (False, True):
        if merged:
            for _, rc in pair:
                assert _req(rc, "POST", "/a/_forcemerge")[0] == 200
        for q in queries:
            body = {"knn": {"field": "emb", "query_vector": q.tolist(),
                            "k": 10, "num_candidates": 50}, "size": 10}
            dispatch.reset_launches()
            status, got = _req(grc, "POST", "/a/_search", body)
            assert status == 200
            # tombstoned generations take the exact legs; merged, the
            # binned kernel once a shard
            assert dispatch.launches().get(kb.KERNEL_BF16, 0) == \
                (shards if merged else 0)
            _, want = _req(crc, "POST", "/a/_search", body)
            _same_hits(got, want, 1e-3)
            assert not {h["_id"] for h in got["hits"]["hits"]} & set(gone)
    for body in (None, {"query": {"term": {"tag": "seen"}}}):
        assert _req(grc, "POST", "/a/_count", body)[1]["count"] == \
            _req(crc, "POST", "/a/_count", body)[1]["count"]


def _mixed_pair(cuda, monkeypatch, shards: int, names=("a", "b")):
    """`_doc_pair` with the search-body tests' mixed indices
    (`tests/torch_mixed.py`, imported by its module name: pytest puts
    `tests/` on the path, and another installed package may own the name
    `tests`) loaded in both nodes."""
    from torch_mixed import mixed_bulks, mixed_mapping
    pair = _doc_pair(cuda, monkeypatch)
    for _, rc in pair:
        for seed, name in enumerate(names):
            assert _req(rc, "PUT", f"/{name}",
                        mixed_mapping(shards))[0] == 200
            for ops in mixed_bulks(name, 200, np.random.default_rng(seed)):
                # an update of an id deleted earlier in the same `_bulk`
                # fails its item, on both nodes alike
                assert _req(rc, "POST", f"/{name}/_bulk", ops,
                            ndjson=True)[0] == 200
                assert _req(rc, "POST", f"/{name}/_refresh")[0] == 200
    return pair


_HOST_BODIES = [
    {"sort": [{"n": "desc"}, {"f": "asc"}], "size": 30},
    {"sort": [{"tag": {"order": "desc", "missing": "_first"}}, "_doc"],
     "query": {"match": {"t": "alpha beta"}}, "size": 20,
     "search_after": ["green", 0]},
    {"query": {"match": {"t": "alpha"}}, "post_filter": {"term": {"b": True}},
     "min_score": 0.3, "version": True, "seq_no_primary_term": True,
     "docvalue_fields": ["n", {"field": "f", "format": "#.0"}],
     "explain": True, "stored_fields": ["s", "_source"]},
    {"query": {"match": {"t": "gamma delta"}}, "rescore": {
        "window_size": 6, "query": {"rescore_query": {"range": {
            "n": {"gte": 10}}}, "score_mode": "multiply",
            "rescore_query_weight": 2.0}}},
    {"query": {"match": {"t": "eta"}}, "collapse": {
        "field": "tag", "inner_hits": [
            {"name": "top", "size": 2},
            {"name": "by_b", "size": 2, "collapse": {"field": "b"}}]}},
    {"query": {"bool": {"must": [{"match": {"t": "theta kappa"}}],
                        "should": [{"term": {"tag": "red"}}]}},
     "highlight": {"fields": {"t": {}, "tag": {}},
                   "pre_tags": ["<b>"], "post_tags": ["</b>"]}},
]


def _difference(a, b, where=""):
    """The path and values of the first place two responses differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{where}.{k}", a.get(k), b.get(k)
            d = _difference(a[k], b[k], f"{where}.{k}")
            if d is not None:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for j, (x, y) in enumerate(zip(a, b)):
            d = _difference(x, y, f"{where}[{j}]")
            if d is not None:
                return d
        return None
    return None if a == b else (where, a, b)


def _separated_vectors(crc, paths, n: int, k: int = 10) -> list:
    """`n` query vectors (seeded) whose k-th and (k+1)-th kNN scores on
    the CPU node lie more than 1e-3 apart over every path: the bf16
    kernel on the card may swap candidates closer than that at the cut,
    the score-gap rule `_same_hits` applies within the list."""
    out = []
    for seed in range(500, 560):
        q = np.random.default_rng(seed).standard_normal(16).round(4)
        ok = True
        for path in paths:
            _, resp = _req(crc, "POST", path, {"knn": {
                "field": "v", "query_vector": q.tolist(), "k": k + 1,
                "num_candidates": 60}, "size": k + 1, "_source": False})
            scores = [h["_score"] for h in resp["hits"]["hits"]]
            ok &= len(scores) == k + 1 and scores[k - 1] - scores[k] > 1e-3
        if ok:
            out.append(q.tolist())
        if len(out) == n:
            return out
    raise AssertionError(f"only {len(out)} separated query vectors")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_search_body_on_cuda_matches_cpu(cuda, monkeypatch, shards):
    """The search-body bodies of the CPU parity tests on a CUDA node and a
    CPU node: host-only bodies (sort, search_after, post_filter,
    min_score, rescore, collapse with inner_hits, the fetch keys,
    highlight) answer byte for byte alike over one index and `a,b` with no
    launch; kNN bodies (a `knn` clause alone and as a `rescore_query`,
    `post_filter` with `collapse`, `sort`) and `rank: {rrf}` with
    `highlight` over `a` and `a,b` hold their hits to the CPU node's
    (scores within 1e-3; query vectors whose top 10 is separated from
    the 11th by more than that) and launch the binned kernel once an
    index and shard a leg. The fixture's deletes and updates leave
    tombstoned bases and sealed generations (served on the exact route),
    so both nodes `_forcemerge` first: each shard then serves one clean
    generation."""
    pair = _mixed_pair(cuda, monkeypatch, shards)
    for node, rc in pair:
        assert _req(rc, "POST", "/a,b/_forcemerge")[0] == 200
        assert all(s.vector_store.field("v").snap.simple
                   for name in ("a", "b") for s in node.index(name).shards)
    (_, grc), (_, crc) = pair
    paths = (("/a/_search", 1), ("/a,b/_search", 2))
    for path, _ in paths:
        for bi, body in enumerate(_HOST_BODIES):
            dispatch.reset_launches()
            s1, got = _req(grc, "POST", path, body)
            s2, want = _req(crc, "POST", path, body)
            assert s1 == s2 == 200, (path, bi, got, want)
            got.pop("took"), want.pop("took")
            assert got == want, (path, bi, _difference(got, want))
            assert not dispatch.launches().get(kb.KERNEL_BF16), (path, bi)
    for qv in _separated_vectors(crc, [p for p, _ in paths], 4):
        knn_spec = {"field": "v", "query_vector": qv, "k": 10,
                    "num_candidates": 60}
        bodies = [
            {"query": {"knn": knn_spec}},
            {"knn": knn_spec, "post_filter": {"term": {"tag": "red"}},
             "collapse": {"field": "b"}},
            {"query": {"match": {"t": "alpha"}}, "rescore": {
                "window_size": 10, "query": {
                    "rescore_query": {"knn": knn_spec}}}},
            {"query": {"match": {"t": "beta"}}, "knn": knn_spec,
             "rank": {"rrf": {}}, "highlight": {"fields": {"t": {}}}},
        ]
        for path, n_idx in paths:
            for bi, body in enumerate(bodies):
                dispatch.reset_launches()
                s1, got = _req(grc, "POST", path, body)
                assert s1 == 200, (path, bi, got)
                assert dispatch.launches().get(kb.KERNEL_BF16, 0) == \
                    n_idx * shards, (path, bi, dispatch.launches())
                _, want = _req(crc, "POST", path, body)
                _same_hits(got, want, 1e-3)
            body = {"knn": knn_spec, "sort": [{"n": "asc"}, "_doc"]}
            dispatch.reset_launches()
            _, got = _req(grc, "POST", path, body)
            assert dispatch.launches().get(kb.KERNEL_BF16, 0) == \
                n_idx * shards
            _, want = _req(crc, "POST", path, body)
            assert [h["_id"] for h in got["hits"]["hits"]] == \
                [h["_id"] for h in want["hits"]["hits"]], path


_DSL_BODIES = [
    {"query": {"prefix": {"t": "al"}}, "size": 20},
    {"query": {"fuzzy": {"t": "alpah"}}, "size": 20},
    {"query": {"match": {"t": {"query": "gamam zeat", "fuzziness": 2}}}},
    {"query": {"match_phrase_prefix": {"t": "alpha be"}}},
    {"query": {"query_string": {"query": "alpha AND beta OR t:ka*"}}},
    {"query": {"dis_max": {"queries": [{"match": {"t": "eta"}},
                                       {"wildcard": {"tag": "?ed"}}],
                           "tie_breaker": 0.2}}},
    {"query": {"boosting": {"positive": {"match": {"t": "iota"}},
                            "negative": {"regexp": {"tag": "gr.*"}},
                            "negative_boost": 0.3}}},
    {"query": {"function_score": {
        "query": {"match": {"t": "theta"}},
        "field_value_factor": {"field": "f", "modifier": "log1p"},
        "boost_mode": "sum"}}},
    {"query": {"script_score": {"query": {"exists": {"field": "v"}},
                                "script": {
        "source": "cosineSimilarity(params.q, 'v') + doc['n'].value",
        "params": {"q": [0.25] * 16}}}}, "size": 15},
    {"query": {"script_score": {"query": {"match": {"t": "alpha"}},
                                "script": "def s = _score; for (int i = 0;"
                                          " i < 3; i++) { s += i; } s"}},
     "script_fields": {"twice": {"script": "doc['n'].value * 2"}}},
    {"suggest": {"s": {"text": "alpah bta", "term": {"field": "t"}}},
     "size": 0},
]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_query_dsl_and_scripts_on_cuda_match_cpu(cuda, monkeypatch, shards):
    """The query DSL, scripts and suggesters of the CPU parity tests on a
    CUDA node and a CPU node: the host bodies (multi-term kinds,
    `query_string`, `dis_max`, `boosting`, `function_score`,
    `script_score` with a vector function and a statement,
    `script_fields`, a term suggest) byte for byte alike with no launch;
    `script_score` over a `knn` clause launches the binned kernel once a
    shard and holds its hits to the CPU node's; then `_update` scripts
    that delete and rewrite documents: no deleted id in a kNN answer on
    either node."""
    pair = _mixed_pair(cuda, monkeypatch, shards, names=("a",))
    for node, rc in pair:
        assert _req(rc, "POST", "/a/_forcemerge")[0] == 200
    (_, grc), (_, crc) = pair
    for bi, body in enumerate(_DSL_BODIES):
        dispatch.reset_launches()
        s1, got = _req(grc, "POST", "/a/_search", body)
        s2, want = _req(crc, "POST", "/a/_search", body)
        assert s1 == s2 == 200, (bi, got, want)
        got.pop("took"), want.pop("took")
        assert got == want, (bi, _difference(got, want))
        assert not dispatch.launches().get(kb.KERNEL_BF16), bi
    for qv in _separated_vectors(crc, ["/a/_search"], 2):
        body = {"query": {"script_score": {
            "query": {"knn": {"field": "v", "query_vector": qv, "k": 10,
                              "num_candidates": 60}},
            "script": "_score * 2 + doc['f'].value"}}}
        dispatch.reset_launches()
        s1, got = _req(grc, "POST", "/a/_search", body)
        assert s1 == 200, got
        assert dispatch.launches().get(kb.KERNEL_BF16, 0) == shards
        _same_hits(got, _req(crc, "POST", "/a/_search", body)[1], 2e-3)
    victims = [f"a{i}" for i in range(2, 200, 9)][:8]
    for _, rc in pair:
        for vid in victims:
            s, r = _req(rc, "POST", f"/a/_update/{vid}", {"script": {
                "source": "ctx.op = 'delete'"}})
            assert s in (200, 404), r
        s, r = _req(rc, "POST", "/a/_update/a5", {"script": {
            "source": "ctx._source.v = params.v",
            "params": {"v": [1.0] + [0.0] * 15}}})
        assert s == 200, r
        assert _req(rc, "POST", "/a/_refresh")[0] == 200
    for rc in (grc, crc):
        _, resp = _req(rc, "POST", "/a/_search", {"knn": {
            "field": "v", "query_vector": [1.0] + [0.0] * 15, "k": 10,
            "num_candidates": 100}, "size": 10})
        ids = [h["_id"] for h in resp["hits"]["hits"]]
        assert ids[0] == "a5" and not set(ids) & set(victims), ids


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_date_and_ip_filtered_knn_on_cuda_matches_cpu(cuda, monkeypatch,
                                                       shards):
    """kNN bodies filtered by a `date` range (ISO bounds, date math with
    rounding), an `ip` range, a date range with `exists` on an object and
    a dynamic date field through a CUDA node and a CPU node: the mask the
    new filters build takes the exact route on the card (no binned
    launch), every hit inside its filter, and the hits equal the CPU
    node's (scores within 1e-3 and ids where the scores are clear of
    ties, as the other node-pair cases hold them)."""
    pair = _doc_pair(cuda, monkeypatch)
    rng = np.random.default_rng(61 + shards)
    n, d = 3000, 32
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    day0 = 893_894_400                      # 1998-04-30T00:00:00Z
    ts = day0 + np.sort(rng.integers(0, 30 * 86_400, n))
    ips = rng.integers(0, 1 << 32, n)
    mapping = {"properties": {
        "v": {"type": "dense_vector", "dims": d, "similarity": "cosine"},
        "@timestamp": {"type": "date",
                       "format": "strict_date_optional_time||epoch_second"},
        "clientip": {"type": "ip"},
        "geo": {"properties": {"city": {"type": "keyword"}}}}}

    def ipv4(v):
        v = int(v)
        return f"{v >> 24}.{v >> 16 & 255}.{v >> 8 & 255}.{v & 255}"

    for node, rc in pair:
        assert _req(rc, "PUT", "/logs", {
            "settings": {"number_of_shards": shards},
            "mappings": mapping})[0] == 200
        sources = [{"@timestamp": int(ts[i]), "clientip": ipv4(ips[i]),
                    **({"geo": {"city": "Paris"}} if i % 3 else {}),
                    "seen": f"1998-05-{1 + i % 28:02d}"} for i in range(n)]
        node.index("logs").index_many([str(i) for i in range(n)], sources,
                                      vectors={"v": vecs})
        assert _req(rc, "POST", "/logs/_refresh")[0] == 200
    (_, grc), (_, crc) = pair
    lo_ip = int(np.quantile(ips, 0.3))
    cases = [
        ({"range": {"@timestamp": {"gte": "1998-05-03T00:00:00Z",
                                   "lt": "1998-05-10T00:00:00Z"}}},
         (ts >= day0 + 3 * 86_400) & (ts < day0 + 10 * 86_400)),
        ({"range": {"@timestamp": {"gt": "1998-05-03||/d",
                                   "lte": "1998-05-04||+1d/d"}}},
         (ts >= day0 + 4 * 86_400) & (ts < day0 + 6 * 86_400)),
        ({"range": {"clientip": {"gte": ipv4(lo_ip),
                                 "lt": ipv4(lo_ip + (1 << 29))}}},
         (ips >= lo_ip) & (ips < lo_ip + (1 << 29))),
        ({"bool": {"filter": [
            {"exists": {"field": "geo"}},
            {"range": {"seen": {"gte": "1998-05-10", "lte": "1998-05-20"}}},
            {"range": {"@timestamp": {"gte": "1998-05-02T00:00:00Z"}}}]}},
         (np.arange(n) % 3 != 0) & np.isin(np.arange(n) % 28 + 1,
                                           np.arange(10, 21))
         & (ts >= day0 + 86_400)),
    ]
    for filt, passing in cases:
        assert passing.sum() > 10
        for q in rng.standard_normal((4, d)).astype(np.float32):
            body = {"knn": {"field": "v", "query_vector": q.tolist(),
                            "k": 10, "num_candidates": 50, "filter": filt},
                    "size": 10, "_source": False}
            dispatch.reset_launches()
            s1, got = _req(grc, "POST", "/logs/_search", body)
            assert s1 == 200, got
            assert not dispatch.launches().get(kb.KERNEL_BF16), filt
            _, want = _req(crc, "POST", "/logs/_search", body)
            _same_hits(got, want, 1e-3)
            ids = [int(h["_id"]) for h in got["hits"]["hits"]]
            assert len(ids) == 10 and passing[ids].all(), filt


# ------------------------------------------------------------ aggregations

def _agg_cols(dev, n=1 << 18, seed=0):
    """An integral f64 column with absent rows, a mask and int32 ordinals,
    on the host and on `dev`."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-5000, 50_000, n).astype(np.float64)
    present = rng.random(n) > 0.1
    vals[~present] = np.nan
    mask = rng.random(n) > 0.3
    ords = np.where(present, rng.integers(0, 900, n), -1).astype(np.int32)
    host = dict(vals=vals, present=present, mask=mask, ords=ords)
    return host, {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def _np_boards(lanes, ok, v, n_lanes):
    cnt = np.bincount(lanes[ok], minlength=n_lanes)
    s = np.bincount(lanes[ok], weights=v[ok], minlength=n_lanes)
    mn = np.full(n_lanes, np.inf)
    mx = np.full(n_lanes, -np.inf)
    np.minimum.at(mn, lanes[ok], v[ok])
    np.maximum.at(mx, lanes[ok], v[ok])
    return cnt, s, mn, mx


def _board_eq(got, want):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["ord", "hist", "range", "cal", "tree",
                                "hll"])
def test_aggs_ops_on_cuda_match_numpy(cuda, op):
    """Each `aggs.*` torch op on CUDA tensors of 2^18 rows equals numpy
    exactly (counts, integral sums, minima, maxima, registers), and counts
    one launch a call."""
    from elasticsearch_tpu_torch.ops import aggs as ops
    h, t = _agg_cols(cuda, seed=len(op))
    vals, present, mask, ords = h["vals"], h["present"], h["mask"], \
        h["ords"]
    before = dispatch.launches()
    names = []
    if op == "ord":
        lanes = np.where(ords >= 0, ords, 1024)
        _board_eq(ops.ord_counts(t["ords"], t["mask"], 1024),
                  np.bincount(lanes[mask], minlength=1025))
        _board_eq(ops.ord_metric(t["ords"], t["mask"], 7.0, t["vals"],
                                 t["present"], 1024),
                  _np_boards(lanes, mask, np.where(present, vals, 7.0),
                             1025))
        names = ["ord_counts", "ord_metric"]
    elif op == "hist":
        hp = (1000.0, 250.0, -6.0, 1.0, None)
        ids = np.floor((np.where(present, vals, 0) - 250.0) / 1000.0) + 6
        ok = present & (ids >= 0) & (ids < 64)
        lanes = np.where(ok, ids, 64).astype(np.int64)
        _board_eq(ops.hist_counts(t["vals"], t["present"], t["mask"], hp,
                                  64),
                  np.bincount(lanes[mask & ok], minlength=65))
        _board_eq(ops.hist_metric(t["vals"], t["present"], t["mask"], hp,
                                  None, t["vals"], t["present"], 64),
                  _np_boards(lanes, mask & ok, vals, 65))
        names = ["hist_counts", "hist_metric"]
    elif op == "range":
        bounds = np.asarray([[-np.inf, 0], [0, 20_000], [10_000, np.inf],
                             [np.inf, np.inf]] + [[np.inf, np.inf]] * 4)
        m = (vals[None] >= bounds[:, :1]) & (vals[None] < bounds[:, 1:]) \
            & (mask & present)[None]
        bt = torch.from_numpy(bounds).to(cuda)
        _board_eq(ops.range_counts(t["vals"], t["present"], t["mask"], bt,
                                   None), m.sum(axis=1))
        got = ops.range_metric(t["vals"], t["present"], t["mask"], bt, None,
                               None, t["vals"], t["present"])
        _board_eq(got, (m.sum(axis=1),
                        np.where(m, vals[None], 0).sum(axis=1),
                        np.where(m, vals[None], np.inf).min(axis=1),
                        np.where(m, vals[None], -np.inf).max(axis=1)))
        names = ["range_counts", "range_metric"]
    elif op == "cal":
        cb = np.full(64, np.inf)
        cb[:40] = np.sort(np.random.default_rng(3).choice(
            np.arange(-6000, 50_000), 40, replace=False)).astype(np.float64)
        cal = np.searchsorted(cb, np.trunc(vals - 5.0), side="right") - 1
        ok = present & (cal >= 0) & (cal < 64)
        lanes = np.where(ok, cal, 64)
        cbt = torch.from_numpy(cb).to(cuda)
        _board_eq(ops.cal_counts(t["vals"], t["present"], t["mask"], cbt,
                                 (1.0, 5.0), 64),
                  np.bincount(lanes[mask & ok], minlength=65))
        _board_eq(ops.cal_metric(t["vals"], t["present"], t["mask"], cbt,
                                 (1.0, 5.0), None, t["vals"], t["present"],
                                 64),
                  _np_boards(lanes, mask & ok, vals, 65))
        names = ["cal_counts", "cal_metric"]
    else:
        hp = (8000.0, 0.0, -1.0, 1.0, None)
        levels = [("ord", 1024, (t["ords"], True)),
                  ("hist", 8, (t["vals"], t["present"], hp))]
        o = np.where(ords >= 0, ords, 1023)
        hid = np.floor(np.where(present, vals, 0) / 8000.0) + 1
        hok = present & (hid >= 0) & (hid < 8)
        sel = mask & hok
        cid = np.where(sel, o * 8 + np.where(hok, hid, 0), 8192) \
            .astype(np.int64)
        if op == "tree":
            _board_eq(ops.tree_counts(t["mask"], levels),
                      np.bincount(cid[sel], minlength=8193))
            _board_eq(ops.tree_metric(t["mask"], None, t["vals"],
                                      t["present"], levels),
                      _np_boards(cid, sel & present, vals, 8193))
            names = ["tree_counts", "tree_metric"]
        else:
            levels = levels[1:]
            cid = np.where(mask & hok, hid, 8).astype(np.int64)
            rng = np.random.default_rng(4)
            hidx = rng.integers(0, ops.HLL_M, len(vals)).astype(np.int32)
            hrho = np.where(present, rng.integers(1, 30, len(vals)), 0) \
                .astype(np.int32)
            want = np.zeros((9, ops.HLL_M), dtype=np.int32)
            np.maximum.at(want, (cid[mask & hok], hidx[mask & hok]),
                          hrho[mask & hok])
            _board_eq(ops.hll_board(t["mask"],
                                    torch.from_numpy(hidx).to(cuda),
                                    torch.from_numpy(hrho).to(cuda), levels),
                      want)
            names = ["hll_board"]
    after = dispatch.launches()
    for name in names:
        key = "aggs." + name
        assert after.get(key, 0) - before.get(key, 0) == 1, key


@pytest.mark.gpu
def _aggs_node_pair(cuda) -> list:
    """[(CUDA node with the device rung forced, its controller), (CPU node
    on the host path, its controller)], each holding indices `a` and `b`
    of 20,000 log-like documents."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.actions import register_all
    from elasticsearch_tpu_torch.rest.controller import RestController

    pair = []
    for device, on in ((cuda, "true"), ("cpu", "false")):
        node = Node(device=device, settings={
            "search.aggs.device_enabled": on,
            "search.aggs.cost_router": "false"})
        rc = RestController()
        register_all(rc, node)
        pair.append((node, rc))
    rng = np.random.default_rng(8)
    n = 20_000
    ts = 893_894_400_000 + np.sort(rng.integers(0, 40 * 86_400_000, n))
    mapping = {"properties": {"ts": {"type": "date"},
                              "status": {"type": "integer"},
                              "size": {"type": "long"},
                              "ip": {"type": "ip"},
                              "tag": {"type": "keyword"}}}
    for name in ("a", "b"):
        status = rng.choice([200, 304, 404], n)
        srcs = [{"ts": int(ts[i]),
                 "status": int(status[i]) if i % 50 else None,
                 "size": int(i * 37 % 100_000),
                 "ip": f"10.0.{i % 7}.{i % 251}", "tag": f"t{i % 11}"}
                for i in range(n)]
        for node, rc in pair:
            assert _req(rc, "PUT", f"/{name}", {"mappings": mapping})[0] \
                == 200
            node.index(name).index_many([str(i) for i in range(n)], srcs)
            assert _req(rc, "POST", f"/{name}/_refresh")[0] == 200
    return pair


def test_aggs_on_cuda_node_match_cpu_host_path(cuda):
    """A CUDA node with the device rung forced (router off) and a CPU node
    on the host path answer the same aggregation bodies with equal JSON;
    the CUDA node's eligible nodes ran on the card."""
    pair = _aggs_node_pair(cuda)
    bodies = [
        {"h": {"date_histogram": {"field": "ts", "calendar_interval": "hour"}}},
        {"t": {"terms": {"field": "status"},
               "aggs": {"s": {"stats": {"field": "size"}}}}},
        {"d": {"date_histogram": {"field": "ts", "calendar_interval": "day"},
               "aggs": {"t": {"terms": {"field": "status", "missing": 0}},
                        "c": {"cardinality": {"field": "ip"}}}}},
        {"r": {"range": {"field": "size", "ranges": [
            {"to": 1000}, {"from": 1000, "to": 50_000}, {"from": 50_000}]},
            "aggs": {"a": {"avg": {"field": "size"}}}}},
        {"c": {"cardinality": {"field": "ip"}},
         "x": {"histogram": {"field": "size", "interval": 5000,
                             "min_doc_count": 0},
               "aggs": {"m": {"max": {"field": "status"}}}}},
    ]
    (gnode, grc), (_, crc) = pair
    for aggs in bodies:
        for path in ("/a/_search", "/a,b/_search"):
            body = {"size": 0, "aggs": aggs, "request_cache": False}
            d0 = gnode.aggs_stats()["device_nodes"]
            s1, got = _req(grc, "POST", path, body)
            s2, want = _req(crc, "POST", path, body)
            assert s1 == s2 == 200, got
            assert got["aggregations"] == want["aggregations"], (path, aggs)
            assert gnode.aggs_stats()["device_nodes"] - d0 \
                == len(aggs) * (2 if "," in path else 1)


def test_aggs_pipelines_and_kinds_on_cuda_node(cuda):
    """Top-level pipelines over a daily histogram the card serves (one
    device node an index), parent pipelines under it (a host node) and
    the host kinds beside it answer as the CPU node's host path."""
    (gnode, grc), (_, crc) = _aggs_node_pair(cuda)
    daily = {"date_histogram": {"field": "ts", "calendar_interval": "day"},
             "aggs": {"a": {"avg": {"field": "size"}}}}
    bodies = [
        ({"d": daily, "ab": {"avg_bucket": {"buckets_path": "d>a"}},
          "mb": {"max_bucket": {"buckets_path": "d>_count"}},
          "pb": {"percentiles_bucket": {"buckets_path": "d>a"}},
          "top": {"bucket_sort": {"buckets_path": {"a": "d>a"},
                                  "sort": [{"a": "desc"}], "size": 5}}}, 1),
        ({"d": {**daily, "aggs": {**daily["aggs"], "cs": {
            "cumulative_sum": {"buckets_path": "a"}}}}}, 0),
        ({"c": {"composite": {"sources": [
            {"t": {"terms": {"field": "tag"}}},
            {"s": {"terms": {"field": "status"}}}]}},
          "r": {"rare_terms": {"field": "ip"}},
          "p": {"percentile_ranks": {"field": "size",
                                     "values": [1000, 50_000]}},
          "s": {"terms": {"field": "status"}}}, 1),
    ]
    for aggs, n_dev in bodies:
        for path in ("/a/_search", "/a,b/_search"):
            body = {"size": 0, "aggs": aggs, "request_cache": False}
            d0 = gnode.aggs_stats()["device_nodes"]
            s1, got = _req(grc, "POST", path, body)
            s2, want = _req(crc, "POST", path, body)
            assert s1 == s2 == 200, got
            assert got["aggregations"] == want["aggregations"], (path, aggs)
            assert gnode.aggs_stats()["device_nodes"] - d0 \
                == n_dev * (2 if "," in path else 1)


# ------------------------------------------------- generational segments

def _gen_segments(rng, sizes, d):
    from elasticsearch_tpu_torch.index import segment
    segs, base = [], 0
    for i, n in enumerate(sizes):
        mat = rng.standard_normal((n, d)).astype(np.float32)
        segs.append(segment.Segment(i, base, [f"d{base + j}" for j in
                                              range(n)], [None] * n,
                                    {"v": (mat, np.ones(n, dtype=bool))}))
        base += n
    return segs


def _gen_reader(segs, upto, deleted=None):
    from elasticsearch_tpu_torch.index import segment
    return segment.ShardReader([segment.SegmentView(s, (deleted or {})
                                                    .get(i))
                                for i, s in enumerate(segs[:upto])])


@pytest.mark.gpu
@pytest.mark.parametrize("options", [None, {"type": "int8_flat",
                                            "rescore": True},
                                     {"type": "int4_flat"}])
def test_generational_store_on_cuda_matches_cpu(cuda, options):
    """Appends seal L0 generations, deletes set tombstones, a batch mixes
    filtered and unfiltered requests, merges run: a CUDA store answers as
    a CPU store does (raw scores within 1e-3); an unfiltered batch
    launches the binned kernel (bf16, int8) for a clean full-build base,
    and none once the base has tombstones (every leg exact, L0 seals
    always), until a force merge leaves one clean generation."""
    from elasticsearch_tpu_torch.index import mapping
    from elasticsearch_tpu_torch.vectors.store import VectorStoreShard
    d = 64
    rng = np.random.default_rng(71)
    segs = _gen_segments(rng, [kb.BLOCK_N * 2, 900, 300, 40], d)
    field = {"type": "dense_vector", "dims": d}
    if options:
        field["index_options"] = options
    props = mapping.MapperService({"properties": {"v": field}}
                                  ).vector_fields()
    stores = [VectorStoreShard(device=dev, segments_background_merge=False,
                               segments_tier_size=2)
              for dev in (cuda, "cpu")]
    queries = list(rng.standard_normal((9, d)).astype(np.float32))
    filters = [None, np.arange(0, 17000, 3, dtype=np.int64)] * 4 + [None]

    def check(kernel_route: bool):
        dispatch.reset_launches()
        got = stores[0].search_many("v", queries, 10, filter_rows=filters)
        launched = dispatch.launches()
        want = stores[1].search_many("v", queries, 10, filter_rows=filters)
        for (gr, gs), (wr, ws) in zip(got, want):
            np.testing.assert_allclose(gs, ws, atol=1e-3)
            assert len(set(gr) & set(wr)) >= 8
        dispatch.reset_launches()
        stores[0].search_many("v", queries, 10)
        kernels = {k for k, c in dispatch.launches().items() if c}
        packed = options and options["type"] == "int4_flat"
        assert kernels == ({kb.KERNEL_INT8 if options else kb.KERNEL_BF16}
                           if kernel_route and not packed else set()), \
            kernels
        assert not launched.get(kb.KERNEL_BF16)      # a filter: exact

    for upto, deleted in ((1, {}), (2, {}), (3, {}), (4, {0: {3, 9999}})):
        for store in stores:
            store.sync(_gen_reader(segs, upto, deleted), props)
        check(not deleted)
    for store in stores:
        store._gens["v"].run_merges()
        assert store._gens["v"].force_merge()
    check(True)


@pytest.mark.gpu
def test_generational_handle_holds_its_set_across_a_merge_on_cuda(cuda):
    """A batch launched against a set of L0 generations lands right after
    a merge installed and freed them (the handle holds its set), while the
    merge thread runs under concurrent searches."""
    import threading
    from elasticsearch_tpu_torch.index import mapping
    from elasticsearch_tpu_torch.vectors.store import VectorStoreShard
    d = 128
    rng = np.random.default_rng(72)
    segs = _gen_segments(rng, [20000] + [100] * 9, d)
    # l2_norm: every leg exact (the binned kernel's approximation aside)
    props = mapping.MapperService({"properties": {"v": {
        "type": "dense_vector", "dims": d, "similarity": "l2_norm"}}}
    ).vector_fields()
    gpu = VectorStoreShard(device=cuda, segments_background_merge=False)
    cpu = VectorStoreShard(device="cpu", segments_background_merge=False)
    for upto in range(1, 11):
        for store in (gpu, cpu):
            store.sync(_gen_reader(segs, upto), props)
    queries = list(rng.standard_normal((16, d)).astype(np.float32))
    want = cpu.search_many("v", queries, 10)
    handle = gpu.search_many_async("v", queries, 10)
    assert gpu._gens["v"].run_merges() >= 1
    torch.cuda.empty_cache()
    for (gr, gs), (wr, ws) in zip(gpu.finalize_many(handle), want):
        np.testing.assert_allclose(gs, ws, atol=1e-3)
    bg = VectorStoreShard(device=cuda, segments_tier_size=2,
                          segments_merge_budget_ms=2.0)
    errors = []

    def search():
        try:
            for _ in range(20):
                for (gr, gs), (wr, ws) in zip(
                        bg.search_many("v", queries, 10), want):
                    np.testing.assert_allclose(gs, ws, atol=1e-3)
        except Exception as e:      # noqa: BLE001 - surfaced below
            errors.append(e)

    for upto in range(1, 11):
        bg.sync(_gen_reader(segs, upto), props)
    # the merge thread started at the seals; the searches run beside it
    threads = [threading.Thread(target=search) for _ in range(2)]
    for t in threads:
        t.start()
    bg._gens["v"].drain()
    for t in threads:
        t.join(120)
    assert not errors, errors[0]
    assert bg.segment_stats()["merges"] >= 1


@pytest.mark.gpu
def test_forcemerge_and_ivf_compaction_on_cuda(cuda, monkeypatch):
    """`_forcemerge` after deletes on the CUDA node: the store rebuilds
    one clean generation and launches the binned kernel again, as the CPU
    node answers; an `int8_ivf` index loses its router at a delete (no
    fused launch), and after the merge thread's compaction launches
    `ivf_fused_dense` again; `DELETE` frees every generation's bytes."""
    import gc
    import threading
    pair = _doc_pair(cuda, monkeypatch)
    rng = np.random.default_rng(73)
    held = threading.Event()
    vecs = rng.standard_normal((9000, 64)).astype(np.float32)
    for node, rc in pair:
        for name, options in (("a", {"type": "flat"}),
                              ("c", {"type": "int8_ivf", "nlist": 16,
                                     "nprobe": 4})):
            assert _req(rc, "PUT", f"/{name}", {
                "settings": {"number_of_shards": 1},
                "mappings": {"properties": {"emb": {
                    "type": "dense_vector", "dims": 64,
                    "index_options": options}}}})[0] == 200
            node.index(name).index_many([str(i) for i in range(9000)],
                                        vectors={"emb": vecs})
            assert _req(rc, "POST", f"/{name}/_refresh")[0] == 200
            # hold the merge thread until the masked route was seen
            gens = node.index(name).store._gens["emb"]
            gens._execute = (lambda spec, victims, _run=gens._execute:
                             held.wait(60) and _run(spec, victims))
            ops = [{"delete": {"_id": str(i)}} for i in range(0, 9000, 97)]
            assert not _req(rc, "POST", f"/{name}/_bulk", ops,
                            ndjson=True)[1]["errors"]
            assert _req(rc, "POST", f"/{name}/_refresh")[0] == 200
    (gnode, grc), (_, crc) = pair
    body = {"knn": {"field": "emb", "query_vector": vecs[5].tolist(),
                    "k": 10, "num_candidates": 50}, "size": 10}
    for name, kernel in (("a", kb.KERNEL_BF16), ("c", fused.KERNEL_DENSE)):
        dispatch.reset_launches()
        _, got = _req(grc, "POST", f"/{name}/_search", body)
        assert not dispatch.launches().get(kernel)
        _, want = _req(crc, "POST", f"/{name}/_search", body)
        _same_hits(got, want, 1e-3)
    held.set()
    for node, _ in pair:
        node.index("c").store._gens["emb"].drain()
    assert _req(grc, "POST", "/a/_forcemerge")[0] == 200
    assert _req(crc, "POST", "/a/_forcemerge")[0] == 200
    store = gnode.index("c").store
    assert store.field("emb").router is not None
    assert store.segment_stats()["ivf_background_builds"] == 1
    _req(grc, "POST", "/c/_search", body)       # the nprobe tuner
    for name, kernel in (("a", kb.KERNEL_BF16), ("c", fused.KERNEL_DENSE)):
        dispatch.reset_launches()
        _, got = _req(grc, "POST", f"/{name}/_search", body)
        assert dispatch.launches().get(kernel) == 1, name
        assert "0" not in {h["_id"] for h in got["hits"]["hits"]}
    _, got = _req(grc, "POST", "/a/_search", body)
    _, want = _req(crc, "POST", "/a/_search", body)
    _same_hits(got, want, 1e-3)
    gc.collect()
    before = torch.cuda.memory_allocated(cuda)
    corpus = sum(g.nbytes for name in ("a", "c") for g in
                 gnode.index(name).store._gens["emb"].snapshot().generations)
    del store
    for name in ("a", "c"):
        assert _req(grc, "DELETE", f"/{name}")[0] == 200
    gc.collect()
    assert before - torch.cuda.memory_allocated(cuda) >= 0.9 * corpus


def _telemetry_node(cuda, monkeypatch, options):
    """A one-shard CUDA node behind its REST layer (the request cache
    off): `emb` (64 dims, `options`) padded to the binned tile, and `body`
    text, 4,096 docs."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.actions import register_all
    from elasticsearch_tpu_torch.rest.controller import RestController

    monkeypatch.setattr(knn, "preferred_pad_multiple",
                        lambda n, metric, device: knn.BINNED_TILE)
    rng = np.random.default_rng(43)
    n = 4096
    centers = rng.standard_normal((32, 64)).astype(np.float32)
    vecs = (centers[rng.integers(0, 32, n)]
            + 0.3 * rng.standard_normal((n, 64))).astype(np.float32)
    words = np.array(["alpha", "beta", "gamma", "delta", "eps", "zeta"])
    node = Node(device=cuda,
                settings={"search.request_cache.device_paths": "false"})
    emb = {"type": "dense_vector", "dims": 64, "similarity": "cosine"}
    if options:
        emb["index_options"] = options
    node.create_index("t", {
        "settings": {"number_of_shards": 1, "index.knn.nlist": 32,
                     "index.knn.nprobe": 8},
        "mappings": {"properties": {"emb": emb, "body": {"type": "text"}}}})
    node.index("t").index_many(
        [str(i) for i in range(n)],
        [{"body": " ".join(rng.choice(words, 4))} for i in range(n)],
        vectors={"emb": vecs})
    node.refresh("t")
    rc = RestController()
    register_all(rc, node)
    return node, rc, rng


@pytest.mark.gpu
@pytest.mark.parametrize("case,program", [
    ("flat", "knn.binned"), ("int8_flat", "knn.binned"),
    ("int8_ivf", "ivf.fused_probe"), ("hybrid", "bm25.topk")])
def test_profiled_request_launches_the_same_kernels_on_cuda(
        cuda, monkeypatch, case, program):
    """A profiled request launches the hand kernels an unprofiled one
    launches (the same `LAUNCHES` delta), answers the same hits, and its
    profile's launch events name them: one event a launch."""
    options = None if case in ("flat", "hybrid") else {"type": case}
    node, rc, rng = _telemetry_node(cuda, monkeypatch, options)
    for _ in range(3):
        body = {"knn": {"field": "emb", "query_vector":
                        rng.standard_normal(64).tolist(), "k": 10,
                        "num_candidates": 50}, "size": 10}
        if case == "hybrid":
            body.update(query={"match": {"body": "alpha gamma"}},
                        rank={"rrf": {}})
        dispatch.reset_launches()
        s1, plain = _req(rc, "POST", "/t/_search", body)
        plain_launches = dispatch.launches()
        dispatch.reset_launches()
        s2, prof = _req(rc, "POST", "/t/_search", dict(body, profile=True))
        assert s1 == s2 == 200
        assert dispatch.launches() == plain_launches and plain_launches
        assert [h["_id"] for h in prof["hits"]["hits"]] == \
            [h["_id"] for h in plain["hits"]["hits"]]
        events = (prof["profile"]["hybrid"]["dispatch"] if case == "hybrid"
                  else prof["profile"]["shards"][0]["dispatch"])
        assert len(events) == sum(plain_launches.values())
        assert program in {e["kernel"] for e in events}
        assert {e["launch"].split("/")[0] for e in events} == \
            set(plain_launches)
        assert prof["profile"]["trace"]["top_spans"]


@pytest.mark.gpu
def test_sampled_out_request_adds_no_device_sync_on_cuda(cuda, monkeypatch):
    """Sequential kNN requests through the REST layer wait on the card
    exactly once a batch, on the batch's event, and never through
    `torch.cuda.synchronize`: at sample rate 0 (every request sampled
    out) and at 1.0 (every request traced) alike."""
    from elasticsearch_tpu_torch import telemetry

    node, rc, rng = _telemetry_node(cuda, monkeypatch, None)
    calls = {"device": 0, "event": 0}
    real_sync, real_event = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def device_sync(*a, **kw):
        calls["device"] += 1
        return real_sync(*a, **kw)

    def event_sync(self):
        calls["event"] += 1
        return real_event(self)

    bodies = [{"knn": {"field": "emb", "query_vector":
                       rng.standard_normal(64).tolist(), "k": 10,
                       "num_candidates": 50}} for _ in range(16)]
    for body in bodies[:2]:                      # warm the kernel library
        assert _req(rc, "POST", "/t/_search", body)[0] == 200
    before = telemetry.TRACER.sample_rate
    monkeypatch.setattr(torch.cuda, "synchronize", device_sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_sync)
    try:
        for rate in (0.0, 1.0):
            telemetry.TRACER.configure(sample_rate=rate)
            sched0 = dict(node.index("t").vector_store.scheduler_stats())
            calls.update(device=0, event=0)
            for body in bodies:
                assert _req(rc, "POST", "/t/_search", body)[0] == 200
            sched = node.index("t").vector_store.scheduler_stats()
            batches = sched["batches"] - sched0["batches"]
            assert batches == len(bodies)
            assert calls == {"device": 0, "event": batches}, (rate, calls)
    finally:
        telemetry.TRACER.configure(sample_rate=before)


def _scroll_hits(rc, path, body) -> list:
    """Every hit of a scroll over `path`, page by page."""
    import json
    status, resp = rc.dispatch("POST", path, {"scroll": "1m"},
                               json.dumps(body).encode())
    assert status == 200, resp
    hits, sid = list(resp["hits"]["hits"]), resp["_scroll_id"]
    while resp["hits"]["hits"]:
        status, resp = _req(rc, "POST", "/_search/scroll", {"scroll_id": sid})
        assert status == 200, resp
        hits += resp["hits"]["hits"]
    return hits


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_search_api_on_cuda_matches_cpu(cuda, monkeypatch, shards):
    """`indices_boost` over a `knn` body on two indices, `pinned` around a
    `knn` clause, and a scroll over a `knn` body on a CUDA node and a CPU
    node: each launches the binned kernel once a shard an index on the
    card (the scroll only at its start), and its hits equal the CPU
    node's (scores within 2e-3, ids where the scores are clear of each
    other; the pinned ids first, in their order)."""
    pair = _mixed_pair(cuda, monkeypatch, shards)
    for _, rc in pair:
        # one clean generation an index: an unfiltered leg is one launch
        assert _req(rc, "POST", "/a,b/_forcemerge")[0] == 200
    (_, grc), (_, crc) = pair
    for qv in _separated_vectors(crc, ["/a/_search", "/b/_search"], 2):
        knn = {"field": "v", "query_vector": qv, "k": 10,
               "num_candidates": 60}
        for path, body, indices in (
                ("/a,b/_search", {"knn": knn, "size": 10, "_source": False,
                                  "indices_boost": [{"b": 2.0}]}, 2),
                ("/a/_search", {"query": {"pinned": {
                    "ids": ["a3", "a150", "a8"],
                    "organic": {"knn": knn}}}, "size": 12}, 1)):
            dispatch.reset_launches()
            s1, got = _req(grc, "POST", path, body)
            assert s1 == 200, got
            assert dispatch.launches().get(kb.KERNEL_BF16, 0) \
                == shards * indices
            s2, want = _req(crc, "POST", path, body)
            assert s2 == 200, want
            _same_hits(got, want, 2e-3)
            if "query" in body:
                assert [h["_id"] for h in got["hits"]["hits"][:3]] \
                    == ["a3", "a150", "a8"]
        body = {"knn": dict(knn, k=20), "size": 7}
        dispatch.reset_launches()
        got = _scroll_hits(grc, "/a/_search", body)
        assert dispatch.launches().get(kb.KERNEL_BF16, 0) == shards
        want = _scroll_hits(crc, "/a/_search", body)
        assert len(got) == len(want) == 20
        _same_hits({"hits": {"hits": got}}, {"hits": {"hits": want}}, 2e-3)


def _join_pair(cuda, monkeypatch, shards: int):
    """`_doc_pair` with a `join` index in both nodes: 40 questions and 240
    answers (16-d vectors, `nested` entities), each answer routed by its
    question's id, one generation a shard."""
    pair = _doc_pair(cuda, monkeypatch)
    rng = np.random.default_rng(71)
    ops = []
    for p in range(40):
        ops += [{"index": {"_id": f"q{p}"}},
                {"rel": "question", "tag": f"t{p % 4}"}]
    for c in range(240):
        ops += [{"index": {"_id": f"a{c}", "routing": f"q{c % 40}"}},
                {"rel": {"name": "answer", "parent": f"q{c % 40}"},
                 "v": rng.standard_normal(16).round(4).tolist(),
                 "entities": [{"name": f"e{int(x)}"}
                              for x in rng.integers(0, 6, 2)]}]
    for _, rc in pair:
        assert _req(rc, "PUT", "/j", {
            "settings": {"number_of_shards": shards},
            "mappings": {"properties": {
                "rel": {"type": "join",
                        "relations": {"question": "answer"}},
                "tag": {"type": "keyword"},
                "v": {"type": "dense_vector", "dims": 16,
                      "similarity": "cosine"},
                "entities": {"type": "nested", "properties": {
                    "name": {"type": "keyword"}}}}}})[0] == 200
        assert _req(rc, "POST", "/j/_bulk", ops, ndjson=True)[0] == 200
        assert _req(rc, "POST", "/j/_forcemerge")[0] == 200
    return pair


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_nested_and_join_on_cuda_match_cpu(cuda, monkeypatch, shards):
    """A `knn` filtered by `has_parent` and by `nested` (the exact route
    with a mask: no binned launch) and `has_child` around a `knn` clause
    (the binned kernel, once a shard) on a CUDA node answer as a CPU node
    does."""
    (_, grc), (_, crc) = _join_pair(cuda, monkeypatch, shards)
    for qv in _separated_vectors(crc, ["/j/_search"], 2):
        knn = {"field": "v", "query_vector": qv, "k": 10,
               "num_candidates": 60}
        for filt in ({"has_parent": {"parent_type": "question", "query": {
                        "term": {"tag": "t1"}}}},
                     {"nested": {"path": "entities", "query": {
                         "term": {"entities.name": "e2"}}}}):
            body = {"knn": dict(knn, filter=filt), "_source": False}
            dispatch.reset_launches()
            s1, got = _req(grc, "POST", "/j/_search", body)
            assert s1 == 200, got
            assert dispatch.launches().get(kb.KERNEL_BF16, 0) == 0
            s2, want = _req(crc, "POST", "/j/_search", body)
            assert s2 == 200, want
            _same_hits(got, want, 2e-3)
        body = {"query": {"has_child": {"type": "answer", "query": {
            "knn": knn}}}, "size": 40, "_source": False}
        dispatch.reset_launches()
        s1, got = _req(grc, "POST", "/j/_search", body)
        assert s1 == 200, got
        assert dispatch.launches().get(kb.KERNEL_BF16, 0) == shards
        s2, want = _req(crc, "POST", "/j/_search", body)
        assert s2 == 200, want
        assert {h["_id"] for h in got["hits"]["hits"]} \
            == {h["_id"] for h in want["hits"]["hits"]}
        assert got["hits"]["total"] == want["hits"]["total"]
