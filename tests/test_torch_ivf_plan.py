"""The fused IVF kernels' launch plan and probe plan
(`ops/ivf_fused.py::launch_plan`, `probe_plan_reference`), which the CUDA
entry points take as given: which variant a shape takes, how many work
items the grid must hold, how a tile's rows are cut into spans, and how
the (query, probe) entries are grouped by partition into items of at most
N_MAX; and the grouped int4 kernel's fragment layout (`int4_k_order`)
against an emulation of its nibble widening. All of it runs on the CPU;
the kernels themselves (the plan kernel among them) are held against
their plain versions on the card by `tests/test_torch_gpu.py` and
`chip_smoke.py`."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import ivf_fused as fused
from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec

BF16, INT8, F32, UINT8 = torch.bfloat16, torch.int8, torch.float32, \
    torch.uint8

# (Q, nprobe, nlist, cap, D, tiles) of the served paths: gist `ivf` (bf16
# 960), cohere `int8_ivf` and `int4_ivf` (768; uint8 tiles of 384 packed
# bytes) at batch 1 with the tuned nprobe, the batched store call (64
# queries) and the kernel phase's Q=256, nprobe 32
SERVED = [(1, 8, 1024, 1472, 960, BF16), (1, 32, 1024, 1472, 960, BF16),
          (64, 8, 1024, 1472, 960, BF16), (256, 32, 1024, 1472, 960, BF16),
          (1, 16, 1024, 1472, 768, INT8), (64, 16, 1024, 1472, 768, INT8),
          (256, 32, 1024, 1472, 768, INT8), (1, 16, 1024, 1472, 768, UINT8),
          (64, 16, 1024, 1472, 768, UINT8),
          (256, 32, 1024, 1472, 768, UINT8)]


def _chunks(cap):
    return -(-cap // fused.CHUNK_ROWS)


@pytest.mark.parametrize("nq,nprobe,nlist,cap,d,dtype", SERVED)
def test_served_shapes_take_grouped(nq, nprobe, nlist, cap, d, dtype):
    """Every served layout takes the grouped variant; one query needs no
    probe plan; the grid's x is the item bound and its y the row spans."""
    plan = fused.launch_plan(nq, nprobe, nlist, cap, d, dtype)
    assert plan.variant == fused.VARIANT_GROUPED
    assert plan.direct is (nq == 1)
    assert plan.grid == (plan.item_bound, plan.split)
    assert plan.smem_bytes <= fused.MAX_SMEM
    want = nq * nprobe if nq == 1 else fused.item_bound(nq, nprobe, nlist)
    assert plan.item_bound == want


def test_q256_cuts_tiles_into_four_spans():
    """At Q=256, nprobe 32 the grid surely holds 256 items (8192 entries
    of at most 32): 4 spans of 3 chunks give 1,024 blocks; each block
    stages 4 column tiles of the 960-d query fragments (60 KB), so 3
    blocks fit on an SM."""
    plan = fused.launch_plan(256, 32, 1024, 1472, 960, BF16)
    assert (plan.split, plan.span_chunks, plan.item_bound) == (4, 3, 1280)
    assert plan.smem_bytes == 32 * 4 + 4 * 60 * 32 * 8
    assert 3 * plan.smem_bytes <= 228 * 1024


def test_int4_stages_as_many_fragments_as_int8():
    """D=768 int4 rows (384 bytes, 3 steps of 16 k16 slices) stage the same
    query fragments as D=768 int8 rows (768 bytes, 6 steps of 8): 49,280
    bytes at four column tiles, the same grid."""
    int4 = fused.launch_plan(256, 32, 1024, 1472, 768, UINT8)
    int8 = fused.launch_plan(256, 32, 1024, 1472, 768, INT8)
    assert int4.smem_bytes == 32 * 4 + 4 * 3 * 16 * 32 * 8 == 49280
    assert int4 == int8
    assert fused.row_bytes(768, UINT8) == 384


@pytest.mark.parametrize("d,dtype,variant", [
    (8, BF16, "grouped"), (48, BF16, "grouped"), (64, BF16, "grouped"),
    (768, BF16, "grouped"), (960, BF16, "grouped"), (100, BF16, "simt"),
    (4, BF16, "simt"), (16, INT8, "grouped"), (48, INT8, "grouped"),
    (768, INT8, "grouped"), (100, INT8, "simt"), (24, INT8, "simt"),
    (64, F32, "simt"), (960, F32, "simt"), (32, UINT8, "grouped"),
    (64, UINT8, "grouped"), (96, UINT8, "grouped"), (288, UINT8, "grouped"),
    (768, UINT8, "grouped"), (100, UINT8, "simt"), (4, UINT8, "simt")])
@pytest.mark.parametrize("nq", [1, 9, 300])
def test_variant_follows_dtype_and_row_width(d, dtype, variant, nq):
    """bf16, int8 and int4 rows of a multiple of 16 bytes take grouped (d
    counts dims: an int4 row holds d / 2 bytes); ragged rows and f32 tiles
    keep the first port's simt kernels."""
    plan = fused.launch_plan(nq, 4, 12, 150, d, dtype)
    assert plan.variant == variant
    if variant == fused.VARIANT_SIMT:
        assert plan.grid == (-(-150 // fused.SIMT_ROWS), 4, nq)
        assert plan.smem_bytes == d * 4


def test_oversized_layouts_take_simt_past_one_query():
    """Query fragments past 227 KB (d = 4096 bf16 at four column tiles)
    and partition counts past the plan's shared-memory histogram take
    simt; a single query needs neither, so it stays grouped."""
    assert fused.launch_plan(2, 4, 64, 150, 4096, BF16).variant == "simt"
    assert fused.launch_plan(1, 4, 64, 150, 4096, BF16).variant == "grouped"
    big = fused.PLAN_MAX_NLIST + 1
    assert fused.launch_plan(2, 4, big, 150, 64, INT8).variant == "simt"
    assert fused.launch_plan(1, 4, big, 150, 64, INT8).variant == "grouped"
    assert fused.launch_plan(2, 4, fused.PLAN_MAX_NLIST, 150, 64,
                             INT8).variant == "grouped"


@pytest.mark.parametrize("cap", [1, 100, 128, 129, 150, 1472, 5000])
@pytest.mark.parametrize("nq,nprobe", [(1, 1), (1, 32), (9, 4), (64, 8),
                                       (256, 32), (2048, 64)])
def test_row_spans_cover_every_row_once(cap, nq, nprobe):
    """split spans of span_chunks 128-row chunks cover [0, cap) with no
    empty span, and the grid reaches MIN_BLOCKS over the items it surely
    holds unless every chunk is already its own span."""
    plan = fused.launch_plan(nq, nprobe, 1024, cap, 64, BF16)
    rows = plan.span_chunks * fused.CHUNK_ROWS
    assert plan.split * rows >= cap > (plan.split - 1) * rows
    n = nq * nprobe
    least = n if plan.direct else -(-n // fused.N_MAX)
    assert least * plan.split >= fused.MIN_BLOCKS \
        or plan.split == _chunks(cap)


def _ids(rng, nq, nprobe, nlist, hot, bad):
    """Random probe ids; `hot` partitions probed by every query first;
    a share `bad` of ids out of range."""
    ids = rng.integers(0, nlist, (nq, nprobe))
    ids[:, :min(hot, nprobe)] = np.arange(min(hot, nprobe)) % nlist
    out = rng.random((nq, nprobe)) < bad
    ids[out] = rng.choice([-1, nlist, 1 << 30], int(out.sum()))
    return torch.from_numpy(ids.astype(np.int32))


def _check_plan(ids: torch.Tensor, nlist: int):
    entries, items, invalid = fused.probe_plan_reference(ids, nlist)
    flat = ids.reshape(-1).long()
    ok = (flat >= 0) & (flat < nlist)
    # every valid entry exactly once, every invalid one set apart
    assert sorted(entries.tolist()) == torch.nonzero(ok).flatten().tolist()
    assert invalid.tolist() == torch.nonzero(~ok).flatten().tolist()
    # items tile the entries in order, each within its own partition
    assert len(items) <= fused.item_bound(ids.shape[0], ids.shape[1], nlist)
    pos = 0
    for p, first, count in items.tolist():
        assert first == pos and 1 <= count <= fused.N_MAX
        assert (flat[entries[first:first + count].long()] == p).all()
        pos += count
    assert pos == len(entries) == int(ok.sum())
    # a partition splits into ceil(count / N_MAX) items, in partition order
    parts = items[:, 0].tolist()
    assert parts == sorted(parts)
    counts = torch.bincount(flat[ok], minlength=nlist)
    for p in set(parts):
        assert parts.count(p) == -(-int(counts[p]) // fused.N_MAX)


@settings(max_examples=60, deadline=None)
@given(nq=st.integers(1, 70), nprobe=st.integers(1, 40),
       nlist=st.integers(1, 300), hot=st.integers(0, 3),
       bad=st.sampled_from([0.0, 0.1, 1.0]), seed=st.integers(0, 2 ** 16))
def test_probe_plan_covers_every_entry_once(nq, nprobe, nlist, hot, bad,
                                            seed):
    _check_plan(_ids(np.random.default_rng(seed), nq, nprobe, nlist, hot,
                     bad), nlist)


def test_item_bound_is_reached():
    """The bound min(nlist, n) + n // N_MAX is met by fewer than N_MAX
    partitions that each hold 1 + 2 N_MAX entries (three items each):
    nothing tighter covers every plan."""
    nlist = 5
    ids = torch.arange(nlist, dtype=torch.int32).repeat_interleave(
        1 + 2 * fused.N_MAX)
    _, items, _ = fused.probe_plan_reference(ids[None, :], nlist)
    assert len(items) == 3 * nlist == fused.item_bound(1, ids.numel(), nlist)


def _partitions(rng, dtype, nlist, cap, d):
    if dtype in (INT8, UINT8):
        lo, hi, w, np_dtype = (-127, 128, d, np.int8) if dtype == INT8 \
            else (0, 256, d // 2, np.uint8)
        parts = torch.from_numpy(rng.integers(lo, hi, (nlist, cap, w))
                                 .astype(np_dtype))
        scales = torch.from_numpy(rng.random((nlist, cap)).astype(
            np.float32)) / 50 + 1e-3
    else:
        parts = torch.from_numpy(rng.standard_normal((nlist, cap, d)).astype(
            np.float32)).to(dtype)
        scales = torch.ones(nlist, cap)
    scales[:, cap - cap // 3:] = 0.0
    zeros = torch.zeros(nlist, cap)
    return IVFPartitions(
        centroids=torch.zeros(nlist, d), centroid_sq=torch.zeros(nlist),
        parts=parts, part_scales=scales, part_sq=zeros,
        part_rows=torch.zeros(nlist, cap, dtype=torch.int32))


def expected_board(q, ivf, ids):
    """The plain version's board over the in-range ids, and NEG_INF across
    the rows of out-of-range ones (the kernels' rule; the plain version
    would index with them)."""
    nlist = ivf.parts.shape[0]
    bad = (ids < 0) | (ids >= nlist)
    want = fused.probe_board_reference(q, ivf, ids.clamp(0, nlist - 1))
    return torch.where(bad[:, :, None], torch.full_like(want, NEG_INF), want)


def _tile_rows(tile):
    """A tile's rows as f32 [rows, D]: bf16-rounded values, or int4
    levels (the codec's planes, even dims low nibble) in dim order."""
    if tile.dtype == UINT8:
        lo, hi = codec.int4_planes(tile)
        return torch.stack([lo, hi], dim=-1).reshape(len(tile), -1).to(F32)
    return tile.to(torch.bfloat16).to(F32)


def _grouped_board(q, ivf, ids):
    """The board assembled the way the grouped kernel cuts it: the plan's
    items, each against every row span of its tile (bf16 operands, f32
    sums), invalid entries' rows NEG_INF, every slot written once."""
    nq, nprobe = ids.shape
    nlist, cap, d = ivf.parts.shape[0], ivf.parts.shape[1], q.shape[1]
    plan = fused.launch_plan(nq, nprobe, nlist, cap, d, ivf.parts.dtype)
    assert plan.variant == fused.VARIANT_GROUPED
    entries, items, invalid = fused.probe_plan_reference(ids, nlist)
    board = torch.full((nq * nprobe, cap), float("nan"))
    board[invalid.long()] = NEG_INF
    qb = q.to(torch.bfloat16).to(torch.float32)
    span = plan.span_chunks * fused.CHUNK_ROWS
    for p, first, count in items.tolist():
        ents = entries[first:first + count].long()
        for y in range(plan.split):
            r0, r1 = y * span, min(cap, (y + 1) * span)
            assert board[ents, r0:r1].isnan().all()
            tile = _tile_rows(ivf.parts[p, r0:r1])
            s = qb[ents // nprobe] @ tile.T
            scale = ivf.part_scales[p, r0:r1]
            board[ents, r0:r1] = torch.where(scale > 0, s * scale,
                                             torch.full_like(s, NEG_INF))
    assert not board.isnan().any()
    return board.view(nq, nprobe, cap)


@pytest.mark.parametrize("dtype,d", [(BF16, 64), (INT8, 48), (BF16, 960),
                                     (UINT8, 64), (UINT8, 288)])
@pytest.mark.parametrize("nq,hot,bad", [(1, 0, 0.0), (9, 0, 0.0),
                                        (70, 2, 0.0), (40, 1, 0.2)])
def test_grouped_cut_gives_the_plain_board(dtype, d, nq, hot, bad):
    """Items x row spans write every board slot exactly once, and scoring
    them item by item gives the plain version's board: NEG_INF at the
    same slots, the rest within f32 sum order. Hot partitions (probed by
    every query, more than N_MAX entries at Q=70) split into several
    items; out-of-range ids and duplicate ids within a query are their
    own entries. int4 rows score their codec levels; D=288 (144 bytes)
    ends in a partial 128-byte step."""
    rng = np.random.default_rng(nq + d)
    nlist, cap, nprobe = 7, 300, 6
    ivf = _partitions(rng, dtype, nlist, cap, d)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    ids = _ids(rng, nq, nprobe, nlist, hot, bad)
    got = _grouped_board(q, ivf, ids)
    want = expected_board(q, ivf, ids)
    neg = want <= -1e37
    assert torch.equal(got <= -1e37, neg)
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    assert float((got[~neg] - want[~neg]).abs().max()) <= tol


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors probe_board runs the plain version and counts no
    launch of either variant; probe_plan is the plain plan."""
    rng = np.random.default_rng(1)
    ivf = _partitions(rng, BF16, 5, 40, 16)
    ids = _ids(rng, 3, 4, 5, 1, 0.0)
    dispatch.reset_launches()
    fused.probe_board(torch.randn(3, 16), ivf, ids)
    assert dispatch.launches() == {} and dispatch.variant_launches() == {}
    entries, items = fused.probe_plan(ids, 5)
    want_e, want_i, _ = fused.probe_plan_reference(ids, 5)
    assert torch.equal(entries, want_e) and torch.equal(items, want_i)


# ------------------------------------------------- the int4 fragment layout

def _bf16_bits(bits):
    """bf16 bit patterns (uint32 < 2^16) as f32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _widen(x):
    """The kernel's `int4_pair`: the nibbles at bits 0-3 and 16-19 of x
    into a bf16x2 of 128 + n (a lop3 with 0x000F000F and 0x43004300), then
    a bf16x2 subtract of 136, rounded to bf16. Returns (low, high)."""
    v = (x & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    out = []
    for half in (v & np.uint32(0xFFFF), v >> np.uint32(16)):
        diff = torch.from_numpy(_bf16_bits(half) - np.float32(136.0))
        rounded = diff.to(torch.bfloat16).to(F32).numpy()
        assert (rounded == diff.numpy()).all()      # exact: no rounding
        out.append(rounded)
    return out


def _a_fragments(step):
    """An emulation of the kernel's loads and widening for one 128-byte
    step of rows [n, 128] uint8: [n, 16 slices, 4 lanes t, 2 registers, 2
    halves] levels. Lane t holds pieces t (pp = 0) and 4 + t (pp = 1);
    slice r takes word (r % 8) // 2 of piece pp = r // 8, shifted by 8 for
    odd r; register 0 is the shifted word's widening, register 1 that of
    the word shifted 4 more."""
    words = step.view(np.uint32)            # little-endian, [n, 32]
    out = np.empty((len(step), 16, 4, 2, 2), dtype=np.float32)
    for r in range(16):
        pp, h = r // 8, r % 8
        for t in range(4):
            u = words[:, 4 * (4 * pp + t) + h // 2] >> np.uint32(8 * (h & 1))
            for reg, x in enumerate((u, u >> np.uint32(4))):
                out[:, r, t, reg] = np.stack(_widen(x), axis=-1)
    return out


def _steps():
    """Rows of one 128-byte step that hold every byte value (0..255 over
    two rows, and shuffles of them), plus random rows."""
    rng = np.random.default_rng(11)
    every = np.arange(256, dtype=np.uint8)
    rows = [every.reshape(2, 128)]
    rows += [rng.permutation(every).reshape(2, 128) for _ in range(3)]
    rows.append(rng.integers(0, 256, (8, 128)).astype(np.uint8))
    return np.ascontiguousarray(np.concatenate(rows))


def _levels(step):
    """The codec's levels of rows [n, 128] uint8, in dim order [n, 256]."""
    lo, hi = codec.int4_planes(torch.from_numpy(step))
    return torch.stack([lo, hi], dim=-1).reshape(len(step), -1).numpy()


@pytest.mark.parametrize("check", ["permutation", "widening", "dot"])
def test_int4_k_order(check):
    """The grouped int4 kernel's K order in one 128-byte step: a
    permutation of the step's 256 dims; the emulated lop3 / bf16x2
    widening of every byte value gives, at each (slice, lane, register,
    half), the codec's level of the dim the order names there (so A, as
    loaded and widened, and B, as staged, meet at the same dims); and the
    dot product summed over the permuted fragments equals the straight
    one."""
    order = fused.int4_k_order()
    assert order.shape == (16, 4, 2, 2)
    if check == "permutation":
        assert sorted(order.flatten().tolist()) == list(range(256))
        return
    step = _steps()
    levels = _levels(step)
    got = _a_fragments(step)
    if check == "widening":
        assert (got == levels[:, order.numpy()]).all()
        return
    rng = np.random.default_rng(5)
    q = rng.standard_normal((7, 256)).astype(np.float32)
    qb = torch.from_numpy(q).to(torch.bfloat16).to(F32).numpy()
    frag_q = qb[:, order.numpy()]                   # the staged B values
    permuted = np.einsum("qskrh,nskrh->qn", frag_q.astype(np.float64),
                         got.astype(np.float64))
    straight = qb.astype(np.float64) @ levels.T.astype(np.float64)
    np.testing.assert_allclose(permuted, straight, rtol=1e-12, atol=1e-9)
