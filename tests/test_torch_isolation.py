"""The port stands alone: every module of `elasticsearch_tpu_torch` and
`chip_smoke.py` import with `jax` and `elasticsearch_tpu` blocked; entry
points refuse to run on the CPU unless asked; and a kernel wrapper given
CUDA tensors (the binned kNN kernels, the fused IVF probe kernels, the
MaxSim kernels, the BM25 board, also on the learned-sparse layout) launches
its kernel or raises, never the plain version."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import elasticsearch_tpu_torch
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import ivf_fused
from elasticsearch_tpu_torch.ops import knn_binned as kb
from elasticsearch_tpu_torch.ops import maxsim
from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["elasticsearch_tpu_torch"]
    for info in pkgutil.walk_packages(elasticsearch_tpu_torch.__path__,
                                      "elasticsearch_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_port_imports_without_jax_or_reference():
    names = _modules() + ["chip_smoke"]
    assert "elasticsearch_tpu_torch.ops.knn_binned" in names
    assert "elasticsearch_tpu_torch.ops.ivf_fused" in names
    assert "elasticsearch_tpu_torch.ann.router" in names
    for name in ("ops.maxsim", "quant.tokens", "columnar.blocks",
                 "vectors.late_interaction", "search.queries_ext",
                 "search.hybrid_plan", "serving.batcher", "search.queries",
                 "search.knn_query", "search.service", "index.mapping",
                 "index.segment", "index.engine", "vectors.store",
                 "cluster.routing", "indices.service", "native", "ops.bm25",
                 "index.analysis", "index.analysis_lang", "ops.sparse",
                 "search.caches", "node", "rest.actions", "rest.controller",
                 "common.errors", "common.settings", "search.aggregations",
                 "search.agg_partials", "search.agg_plan", "ops.aggs",
                 "segments", "segments.policy", "segments.generation",
                 "segments.generational", "columnar.store", "telemetry",
                 "telemetry.metrics", "telemetry.trace", "node_admin",
                 "search.profile", "script", "script.painless",
                 "script.service", "script.mustache", "search.script_score",
                 "search.extras", "rest.actions_script",
                 "search.agg_pipelines", "rest.cat", "rest.actions_extra"):
        assert f"elasticsearch_tpu_torch.{name}" in names
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'elasticsearch_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'elasticsearch_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_documents_within_documents_stand_alone():
    """The mappers, queries, inner hits and aggregations of documents
    within documents live in the port's own modules (its source matcher,
    its murmur3) and import with `jax` and the JAX package blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'elasticsearch_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from elasticsearch_tpu_torch.index import mapping\n"
        "from elasticsearch_tpu_torch.search import queries_ext, service\n"
        "from elasticsearch_tpu_torch.search import aggregations\n"
        "for t in ('nested', 'join', 'percolator', 'binary', "
        "'search_as_you_type', 'token_count', 'wildcard', "
        "'constant_keyword', 'murmur3', 'histogram', 'flattened', "
        "'annotated_text', 'alias'):\n"
        "    assert mapping.FIELD_TYPES[t].__module__ == mapping.__name__\n"
        "for c in ('NestedQuery', 'HasChildQuery', 'HasParentQuery', "
        "'ParentIdQuery', 'PercolateQuery', 'source_matches'):\n"
        "    assert getattr(queries_ext, c).__module__ == "
        "queries_ext.__name__\n"
        "assert service.nested_inner_hits_specs.__module__ == "
        "service.__name__\n"
        "assert queries_ext.source_matches({'term': {'a': 1}}, {'a': 1})\n"
        "assert {'nested', 'reverse_nested'} <= aggregations.BUCKET_AGGS\n"
        "m = mapping.Murmur3FieldMapper('m').doc_value('hello')\n"
        "assert m == 613153351, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'elasticsearch_tpu') and sys.modules[m] is not "
        "None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_gpu(monkeypatch):
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import knn
    from elasticsearch_tpu_torch.server import build_server
    from elasticsearch_tpu_torch.vectors.store import VectorStoreShard
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Node, VectorStoreShard, build_server,
                 lambda: elasticsearch_tpu_torch.resolve_device()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError):
        elasticsearch_tpu_torch.resolve_device("mps")
    assert Node(device="cpu").device.type == "cpu"
    c = knn.build_corpus(np.ones((3, 4), np.float32), device="cpu")
    assert c.matrix.device.type == "cpu"


def test_chip_smoke_exits_nonzero_without_gpu():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.main([]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096

    def element_size(self):
        return self.dtype.itemsize

    def __getitem__(self, key):
        # the int4 query planes: [:, 0::2] and [:, 1::2]
        return _FakeCuda((self.shape[0], self.shape[1] // 2), self.dtype)

    def to(self, *args, **kwargs):
        return self

    def contiguous(self):
        return self


class _FakeLib:
    def __init__(self, code):
        self.code, self.calls, self.last = code, 0, None

    def _launch(self, *args):
        self.calls += 1
        self.last = args
        return self.code

    def _arity(n, launch=_launch):
        """An entry that takes exactly the C signature's n arguments."""
        def entry(self, *args):
            assert len(args) == n, f"{len(args)} arguments, the C entry {n}"
            return launch(self, *args)
        return entry

    knn_binned_bf16 = knn_binned_int8 = _launch
    ivf_fused_dense = ivf_fused_dense_grouped = _launch
    ivf_fused_int4 = ivf_fused_int4_grouped = _launch
    # (ids, q, toks, scales, out, nq, nw, tq, n_pad, cap, w, [dtype,]
    # variant, cpb, smem, stream)
    maxsim_dense = _arity(16)
    maxsim_int4 = _arity(15)
    # (pos_starts, runs, n_runs, required, nq, tile_first, tile_slots,
    # tile_impacts, tile_scales, dtype, n_slots, range_slots, k, cand,
    # sort_in_smem, sort_scratch, vals, slots, stream)
    bm25_board = _arity(19)

    def cuda_error_string(self, code):
        return b"an injected launch failure"


@pytest.mark.parametrize("code", [0, 1])
def test_cuda_wrappers_launch_or_raise_never_plain(monkeypatch, code):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    lib = _FakeLib(code)
    monkeypatch.setattr(kb, "binned_packed_reference", no_plain)
    monkeypatch.setattr(kb, "_lib", lambda: lib)
    monkeypatch.setattr(kb.torch, "empty",
                        lambda shape, dtype, device: _FakeCuda(shape, dtype))
    monkeypatch.setattr(kb.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    n = kb.BLOCK_N
    calls = [
        (kb.KERNEL_BF16, lambda: kb.binned_packed_bf16(
            _FakeCuda((8, 32), torch.bfloat16),
            _FakeCuda((n, 32), torch.bfloat16),
            _FakeCuda((1, n), torch.float32), clamp=True)),
        (kb.KERNEL_INT8, lambda: kb.binned_packed_int8(
            _FakeCuda((8, 32), torch.int8), _FakeCuda((n, 32), torch.int8),
            _FakeCuda((8, 1), torch.float32),
            _FakeCuda((1, n), torch.float32))),
    ]
    for name, call in calls:
        before = dispatch.launches().get(name, 0)
        if code:
            with pytest.raises(RuntimeError, match="injected launch failure"):
                call()
            assert dispatch.launches().get(name, 0) == before
        else:
            out = call()
            assert out.shape == (8, n // kb.BIN_SIZE)
            assert dispatch.launches().get(name, 0) == before + 1
    assert lib.calls == 2


@pytest.mark.parametrize("code", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_bm25_board_launches_or_raises_never_plain(monkeypatch, code, dtype):
    """On CUDA tensors `bm25_board` calls its C entry once a batch (its two
    kernels, counted once) with `launch_plan`'s ranges, or raises its
    error, and never runs a plain version; bad inputs raise before any
    launch."""
    from elasticsearch_tpu_torch.ops import bm25

    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    lib = _FakeLib(code)
    monkeypatch.setattr(bm25, "bm25_board_reference", no_plain)
    monkeypatch.setattr(bm25, "bm25_board_ranged_reference", no_plain)
    monkeypatch.setattr(bm25, "_lib", lambda: lib)
    monkeypatch.setattr(bm25.torch, "empty",
                        lambda shape, dtype, device: _FakeCuda(shape, dtype))
    monkeypatch.setattr(bm25.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    sms = {0: 132}       # the card's SM count, as the wrapper reads it
    monkeypatch.setattr(bm25, "_sm_count", lambda index: sms[index])
    plan = (_FakeCuda((9,), torch.int32), _FakeCuda((3, 40), torch.int32),
            _FakeCuda((8,), torch.int32))
    tiles = (_FakeCuda((12,), torch.int32), _FakeCuda((12, 128), torch.int32),
             _FakeCuda((12, 128), dtype))
    scales = _FakeCuda((12,), torch.float32) if dtype == torch.int8 \
        else None
    before = dispatch.launches().get(bm25.KERNEL, 0)
    if code:
        with pytest.raises(RuntimeError, match="injected launch failure"):
            bm25.bm25_board(*plan, *tiles, scales, 100, 5000)
        assert dispatch.launches().get(bm25.KERNEL, 0) == before
    else:
        vals, slots = bm25.bm25_board(*plan, *tiles, scales, 100, 5000)
        assert (vals.shape, vals.dtype, slots.shape, slots.dtype) \
            == ((8, 100), torch.float32, (8, 100), torch.int32)
        assert dispatch.launches().get(bm25.KERNEL, 0) == before + 1
        # (.., n_runs, .., nq, .., n_slots, range_slots, k, ..)
        assert (lib.last[2], lib.last[4], lib.last[10], lib.last[11],
                lib.last[12]) == (40, 8, 5000, 1024, 100)
    # the learned-sparse layout's call, counted under its variant too
    key = f"{bm25.KERNEL}/sparse"
    sparse_before = dispatch.variant_launches().get(key, 0)
    if code:
        with pytest.raises(RuntimeError, match="injected launch failure"):
            bm25.bm25_board(*plan, *tiles, scales, 100, 5000,
                            variant="sparse", range_slots=256)
    else:
        bm25.bm25_board(*plan, *tiles, scales, 100, 5000, variant="sparse",
                        range_slots=256)
        assert dispatch.launches().get(bm25.KERNEL, 0) == before + 2
        assert lib.last[11] == 256
    assert dispatch.variant_launches().get(key, 0) \
        == sparse_before + (0 if code else 1)
    assert lib.calls == 2
    for bad, match in (
            ((plan[0], plan[1], torch.ones(8, dtype=torch.int32)),
             "one CUDA device"),
            ((plan[0], _FakeCuda((3, 40), torch.int64), plan[2]), "int32"),
            ((plan[0], plan[1], _FakeCuda((7,), torch.int32)), "shape")):
        with pytest.raises((ValueError, TypeError), match=match):
            bm25.bm25_board(*bad, *tiles, scales, 100, 5000)
    with pytest.raises(ValueError, match="k"):
        bm25.bm25_board(*plan, *tiles, scales, 5001, 5000)
    with pytest.raises(ValueError, match="scales"):
        bm25.bm25_board(*plan, *tiles,
                        None if scales is not None
                        else _FakeCuda((12,), torch.float32), 100, 5000)
    with pytest.raises(ValueError, match="range_slots"):
        bm25.bm25_board(*plan, *tiles, scales, 100, 5000, range_slots=100)
    assert lib.calls == 2
    if not code:
        # R follows the card's SM count: 8 SMs are filled by one range a
        # query, so R covers the field
        sms[0] = 8
        bm25.bm25_board(*plan, *tiles, scales, 100, 5000)
        assert lib.last[11] == 5024


def test_cuda_wrapper_rejects_bad_shapes_and_mixed_devices():
    q = _FakeCuda((8, 32), torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        kb.binned_packed_bf16(q, _FakeCuda((100, 32), torch.bfloat16),
                              _FakeCuda((1, 100), torch.float32), False)
    with pytest.raises(ValueError, match="one CUDA device"):
        kb.binned_packed_bf16(q, torch.zeros(kb.BLOCK_N, 32,
                                             dtype=torch.bfloat16),
                              torch.zeros(1, kb.BLOCK_N), False)
    f32 = torch.float32
    with pytest.raises(TypeError):
        kb.binned_packed_int8(q, _FakeCuda((kb.BLOCK_N, 32), torch.bfloat16),
                              _FakeCuda((8, 1), f32),
                              _FakeCuda((1, kb.BLOCK_N), f32))
    q8 = _FakeCuda((8, 32), torch.int8)
    c8 = _FakeCuda((kb.BLOCK_N, 32), torch.int8)
    with pytest.raises(ValueError, match="per-query/per-row"):
        kb.binned_packed_int8(q8, c8, _FakeCuda((7, 1), f32),
                              _FakeCuda((1, kb.BLOCK_N), f32))
    with pytest.raises(ValueError, match="per-query/per-row"):
        kb.binned_packed_bf16(q, _FakeCuda((kb.BLOCK_N, 32), torch.bfloat16),
                              _FakeCuda((1, 100), f32), False)


def _fake_ivf(dtype, nlist=8, cap=24, w=32):
    f32 = torch.float32
    return IVFPartitions(
        centroids=_FakeCuda((nlist, w), f32), centroid_sq=_FakeCuda((nlist,), f32),
        parts=_FakeCuda((nlist, cap, w), dtype),
        part_scales=_FakeCuda((nlist, cap), f32),
        part_sq=_FakeCuda((nlist, cap), f32),
        part_rows=_FakeCuda((nlist, cap), torch.int32))


@pytest.mark.parametrize("code", [0, 1])
def test_ivf_fused_wrappers_launch_or_raise_never_plain(monkeypatch, code):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    lib = _FakeLib(code)
    monkeypatch.setattr(ivf_fused, "probe_board_reference", no_plain)
    monkeypatch.setattr(ivf_fused, "_lib", lambda: lib)
    monkeypatch.setattr(ivf_fused.torch, "empty",
                        lambda shape, dtype, device: _FakeCuda(shape, dtype))
    monkeypatch.setattr(ivf_fused.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    simt, grouped = ivf_fused.VARIANT_SIMT, ivf_fused.VARIANT_GROUPED
    # (kernel, tiles, row width, query dims, the variant counted): f32
    # tiles keep the simt kernel, bf16, int8 and int4 rows of a multiple of
    # 16 bytes go grouped, ragged int4 rows (50 bytes) stay simt
    cases = [(ivf_fused.KERNEL_DENSE, torch.float32, 32, 32, simt),
             (ivf_fused.KERNEL_DENSE, torch.bfloat16, 32, 32, grouped),
             (ivf_fused.KERNEL_DENSE, torch.int8, 32, 32, grouped),
             (ivf_fused.KERNEL_INT4, torch.uint8, 16, 32, grouped),
             (ivf_fused.KERNEL_INT4, torch.uint8, 50, 100, simt)]
    for name, dtype, w, d, variant in cases:
        ivf = _fake_ivf(dtype, w=w)
        q = _FakeCuda((5, d), torch.float32)
        ids = _FakeCuda((5, 4), torch.int32)
        before = dispatch.launches().get(name, 0)
        if code:
            with pytest.raises(RuntimeError, match="injected launch failure"):
                ivf_fused.probe_board(q, ivf, ids)
            assert dispatch.launches().get(name, 0) == before
        else:
            variants = dispatch.variant_launches()
            out = ivf_fused.probe_board(q, ivf, ids)
            assert out.shape == (5, 4, 24)
            assert dispatch.launches().get(name, 0) == before + 1
            key = f"{name}/{variant}"
            assert dispatch.variant_launches().get(key, 0) \
                == variants.get(key, 0) + 1
    assert lib.calls == len(cases)


def test_ivf_fused_wrapper_rejects_bad_inputs():
    q = _FakeCuda((5, 32), torch.float32)
    ids = _FakeCuda((5, 4), torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ivf_fused.probe_board(torch.zeros(5, 32), _fake_ivf(torch.bfloat16),
                              ids)
    with pytest.raises(TypeError):
        ivf_fused.probe_board(q, _fake_ivf(torch.bfloat16),
                              _FakeCuda((5, 4), torch.int64))
    with pytest.raises(ValueError, match="shape mismatch"):
        ivf_fused.probe_board(q, _fake_ivf(torch.bfloat16, w=48), ids)
    with pytest.raises(TypeError, match="no fused kernel"):
        ivf_fused.probe_board(q, _fake_ivf(torch.float16), ids)


def _fake_maxsim(dtype, nq=5, nw=4, tq=8, w=32, n_pad=64, cap=16):
    """(ids, query tokens, token tile, scales) standing in on a card."""
    qw = 2 * w if dtype == torch.uint8 else w
    return (_FakeCuda((nq, nw), torch.int32),
            _FakeCuda((nq, tq, qw), torch.float32),
            _FakeCuda((n_pad, cap, w), dtype),
            _FakeCuda((n_pad, cap), torch.float32))


@pytest.mark.parametrize("code", [0, 1])
def test_maxsim_wrappers_launch_or_raise_never_plain(monkeypatch, code):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    lib = _FakeLib(code)
    monkeypatch.setattr(maxsim, "maxsim_reference", no_plain)
    monkeypatch.setattr(maxsim, "_lib", lambda: lib)
    monkeypatch.setattr(maxsim.torch, "empty",
                        lambda shape, dtype, device: _FakeCuda(shape, dtype))
    monkeypatch.setattr(maxsim.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    # f32 tiles keep the wmma kernel; bf16, int8 and int4 tiles at Tq 8
    # take warp, and the entry gets the plan's variant code, candidates a
    # block and shared memory
    warp, wmma = maxsim.VARIANT_WARP, maxsim.VARIANT_WMMA
    cases = [(maxsim.KERNEL_DENSE, torch.float32, wmma, 0),
             (maxsim.KERNEL_DENSE, torch.bfloat16, warp, 1),
             (maxsim.KERNEL_DENSE, torch.int8, warp, 1),
             (maxsim.KERNEL_INT4, torch.uint8, warp, 1)]
    for name, dtype, variant, vcode in cases:
        before = dispatch.launches().get(name, 0)
        key = f"{name}/{variant}"
        variants = dispatch.variant_launches()
        if code:
            with pytest.raises(RuntimeError, match="injected launch failure"):
                maxsim.maxsim_rescore(*_fake_maxsim(dtype))
            assert dispatch.launches().get(name, 0) == before
        else:
            out = maxsim.maxsim_rescore(*_fake_maxsim(dtype))
            assert out.shape == (5, 4)
            assert dispatch.launches().get(name, 0) == before + 1
            assert dispatch.variant_launches().get(key, 0) \
                == variants.get(key, 0) + 1
        plan = maxsim.launch_plan(5, 4, 8, 16, 32, dtype)
        assert plan.variant == variant
        assert lib.last[-4:-1] == (vcode, plan.cpb, plan.smem_bytes)
    assert lib.calls == len(cases)


def test_maxsim_wrapper_rejects_bad_inputs():
    ids, q, toks, scales = _fake_maxsim(torch.int8)
    with pytest.raises(ValueError, match="one CUDA device"):
        maxsim.maxsim_rescore(ids, torch.zeros(5, 8, 32), toks, scales)
    with pytest.raises(TypeError):
        maxsim.maxsim_rescore(_FakeCuda((5, 4), torch.int64), q, toks, scales)
    with pytest.raises(TypeError, match="no MaxSim kernel"):
        maxsim.maxsim_rescore(*_fake_maxsim(torch.float16))
    for bad in (_fake_maxsim(torch.int8, w=24),
                (ids, _FakeCuda((5, 8, 64), torch.float32), toks, scales),
                (ids, q, toks, _FakeCuda((64, 8), torch.float32)),
                (_FakeCuda((4, 4), torch.int32), q, toks, scales),
                (ids, _FakeCuda((5, 8, 32), torch.float32),
                 _FakeCuda((64, 16, 32), torch.uint8), scales)):
        with pytest.raises(ValueError, match="shape mismatch"):
            maxsim.maxsim_rescore(*bad)
