"""BM25 lexical scoring on the card: tile-padded impacts and a batched
score board (port of `elasticsearch_tpu/ops/bm25.py`).

* build (at a reader's first lexical search): every posting's full BM25
  impact ``idf(term) * (k1+1) * tf(freq, len)`` is computed once by
  `native.bm25_score` (the host query path's own engine, so the f32
  roundings are the same) and laid out as a tile-padded CSR: postings
  term-major, each term's run padded to whole 128-lane tiles. Impacts stay
  f32 (`index.lexical.impact_dtype: f32`, the default, exact), or go to
  the card as bf16, or as int8 with one scale a tile. Per-segment postings
  extractions (`columnar/blocks.py::PostingsBlock`) are kept by segment
  fingerprint, so an append-only refresh extracts only the new segments.

* search: one `bm25_board` call a batch (`csrc/bm25.cu`, two kernels).
  The plan is one entry a (query, term position): the term's tile run and
  boost, in query-term order. Kernel A gives each (slot range, query) a
  block whose score and count boards live in shared memory; it adds each
  position's tiles in order, so every slot adds in query-term order and
  the f32 sums equal the reference's bit for bit, masks the slots whose
  count is below the query's required matches (operator `and`,
  `minimum_should_match`) and keeps its range's top k. Kernel B merges a
  query's ranges into its window, ranked by (score desc, slot asc): ties
  to the lower slot (slots ascend with the global row), as
  `native.topk` and `ops/topk.py::top_k` break them.

Routes: `search_batch(route="host")` runs `_score_host`, the numpy twin of
the board over the f32 impacts; any other route runs the board, whose
wrapper launches the kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. The reference picks between the two with its
CostModel when a card is present; the port has no CostModel yet, so a
field whose tensors are on the card always takes the board.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import native, resolve_device
from elasticsearch_tpu_torch.columnar import blocks as columnar
from elasticsearch_tpu_torch.ops import _build
from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops.topk import top_k
from elasticsearch_tpu_torch.quant import codec as quant_codec

TILE = 128

BM25_K1 = 1.2
BM25_B = 0.75

KERNEL = "bm25_board"

# impact tensor dtype -> the kernel's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_IMPACT_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ------------------------------------------------------------------ kernel

# The kernels' launch shape (`csrc/bm25.cu`): a block a (slot range,
# query) scores and selects, a block a query merges.
RANGE_DEFAULT = 8192            # slots a range: a 64 KB board, 3 blocks an SM
RANGE_MIN = 1024
RANGE_MAX = 16384               # the kernel's shared-memory limit
SORT_SMEM_MAX = 1 << 17         # the merge sorts up to 16,384 keys in shared
                                # memory, more in global scratch
# `csrc/bm25.cu`'s shared-memory layout, for the logs (the C entry sizes
# and checks its own): a histogram + misc head, kernel A's boards (8 B a
# slot) and position windows, kernel B's digit histogram and key list
_HEAD_BYTES = 256 * 4 + 32 * 4
_POS_CHUNK = 512
_HIST_BINS = 4096
_B_LIST = 2048


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class BoardPlan(NamedTuple):
    range_slots: int    # R: the slots a kernel-A block owns
    n_ranges: int       # ceil(n_slots / R)
    k_range: int        # k' = min(k, R): candidates a range
    n_cand: int         # n_ranges * k': candidates a query
    sort_n: int         # pow2(k): the merge's sort width
    sort_in_smem: bool  # the merge sorts in shared memory (else in global
                        # scratch)


def launch_plan(nq: int, n_slots: int, k: int,
                range_slots: Optional[int] = None, *,
                sms: Optional[int] = None) -> BoardPlan:
    """The kernels' range decomposition for a batch of `nq` queries over
    `n_slots` slots and a window of k. R halves from RANGE_DEFAULT until
    nq * ceil(n_slots / R) blocks fill the card's `sms` SMs (Q = 1 too),
    but not below RANGE_MIN, nor above the field (rounded up to 32);
    `range_slots` forces it (a multiple of 32 up to RANGE_MAX), and then
    `sms` is not needed."""
    if range_slots is None:
        if sms is None or sms < 1:
            raise ValueError("launch_plan needs the card's SM count or "
                             "range_slots")
        r = RANGE_DEFAULT
        while r > RANGE_MIN and nq * -(-n_slots // r) < sms:
            r //= 2
        r = min(r, max(32, -(-n_slots // 32) * 32))
    else:
        r = int(range_slots)
        if r < 32 or r > RANGE_MAX or r % 32:
            raise ValueError(f"range_slots must be a multiple of 32 in "
                             f"[32, {RANGE_MAX}], got {r}")
    n_ranges = -(-n_slots // r)
    k_range = min(k, r)
    n_cand = n_ranges * k_range
    sort_n = _pow2(k)
    return BoardPlan(r, n_ranges, k_range, n_cand, sort_n,
                     8 * sort_n <= SORT_SMEM_MAX)


def range_windows(tile_first: np.ndarray, runs: np.ndarray, lo: int,
                  hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each plan entry's window of tiles touching the slots [lo, hi), as
    kernel A finds it: from the last tile of the term's run whose first
    slot is <= lo (else the run's first tile) up to, not including, the
    first tile whose first slot is >= hi. `tile_first` ascends within a
    run, so every posting in [lo, hi) lies in its window. Returns (first
    tile [P], tile count [P]) int64."""
    first = runs[0].astype(np.int64)
    end = first + runs[1].astype(np.int64)
    start = np.empty(len(first), dtype=np.int64)
    stop = np.empty(len(first), dtype=np.int64)
    for j, (a, b) in enumerate(zip(first.tolist(), end.tolist())):
        run = tile_first[a:b]
        start[j] = max(a + int(np.searchsorted(run, lo, "right")) - 1, a)
        stop[j] = a + int(np.searchsorted(run, hi, "left"))
    return start, np.maximum(stop - start, 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bm25")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bm25_board.argtypes = [p, p, ll, p, i, p, p, p, p, i, ll, i, i,
                                   p, i, p, p, p, ll]
        lib.bm25_board.restype = ctypes.c_int
        lib.bm25_kernel_launches.argtypes = []
        lib.bm25_kernel_launches.restype = ctypes.c_longlong
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def kernel_smem(plan: BoardPlan) -> Tuple[int, int]:
    """The two kernels' dynamic shared memory bytes for `plan`, as the C
    entry sizes them (for the logs: ptxas reports no dynamic size)."""
    return (_HEAD_BYTES + 8 * plan.range_slots + 12 * _POS_CHUNK,
            _HEAD_BYTES + 4 * _HIST_BINS + 8 * _B_LIST
            + (8 * plan.sort_n if plan.sort_in_smem else 0))


def kernel_launches() -> int:
    """The kernels `csrc/bm25.cu` has launched in this process, counted by
    the library as the runtime accepts each launch (two a `bm25_board`
    call); a measurement, apart from `dispatch`'s count of calls."""
    return int(_lib().bm25_kernel_launches())


def check_plan(pos_starts: np.ndarray, runs: np.ndarray,
               n_tiles: int) -> None:
    """Raise on a plan the kernels would read out of bounds: `pos_starts`
    must start at 0, ascend and end at runs.shape[1], and every entry's
    tiles lie in [0, n_tiles). Runs on the host copy before its upload:
    the CUDA wrapper checks only shapes, since reading the values on the
    card would wait for it."""
    ps = np.asarray(pos_starts, dtype=np.int64)
    rn = np.asarray(runs, dtype=np.int64)
    if ps.ndim != 1 or len(ps) < 2 or rn.ndim != 2 or rn.shape[0] != 3:
        raise ValueError(f"plan shapes: pos_starts {ps.shape}, runs "
                         f"{rn.shape}")
    if ps[0] != 0 or (np.diff(ps) < 0).any() or ps[-1] != rn.shape[1]:
        raise ValueError("pos_starts must ascend from 0 to the plan's "
                         "entries")
    if (rn[0] < 0).any() or (rn[1] < 0).any() \
            or (rn[0] + rn[1] > n_tiles).any():
        raise ValueError(f"a plan entry's tiles lie outside [0, {n_tiles})")


def _position_items(pos_starts: torch.Tensor, runs: torch.Tensor):
    """The per-query plan expanded to per-position work items: yields,
    for j = 0, 1, ..., (query [n], tile [n], boost [n]) of the tiles of
    every query's j-th entry."""
    dev = runs.device
    ps = pos_starts.long()
    per_q = ps[1:] - ps[:-1]
    if runs.shape[1] == 0:
        return
    q_of = torch.repeat_interleave(torch.arange(len(per_q), device=dev),
                                   per_q)
    j_of = torch.arange(runs.shape[1], device=dev) - ps[q_of]
    boost = runs[2].contiguous().view(torch.float32)
    for j in range(int(per_q.max())):
        e = torch.nonzero(j_of == j).squeeze(1)
        nt = runs[1][e].long()
        run_start = torch.repeat_interleave(torch.cumsum(nt, 0) - nt, nt)
        tiles = torch.repeat_interleave(runs[0][e].long(), nt) \
            + (torch.arange(int(nt.sum()), device=dev) - run_start)
        yield (torch.repeat_interleave(q_of[e], nt), tiles,
               torch.repeat_interleave(boost[e], nt))


def _tile_values(tiles, boost, tile_slots, tile_impacts, tile_scales):
    """(slots [n, TILE] int64, (imp [* scale]) * boost [n, TILE] f32) of
    the tiles, formed in the kernel's order."""
    slots = tile_slots[tiles].long()
    imp = tile_impacts[tiles].to(torch.float32)
    if tile_scales is not None:
        imp = imp * tile_scales[tiles][:, None]
    return slots, imp * boost[:, None]


def bm25_board_reference(pos_starts: torch.Tensor, runs: torch.Tensor,
                         required: torch.Tensor, tile_first: torch.Tensor,
                         tile_slots: torch.Tensor, tile_impacts: torch.Tensor,
                         tile_scales: Optional[torch.Tensor], k: int,
                         n_slots: int):
    """The plain PyTorch version of `bm25_board`: a [Q, n_slots + 1] score
    and count board (lane n_slots the padding lane), filled position by
    position (every query's j-th entry) with `index_put_(accumulate=True)`,
    whose indices within one position are unique but for the padding lane,
    which gets only zeros, so each add is exact and in the kernel's order;
    then `board_top_k`, and slot -1 where the score is -inf. `tile_first`
    is not needed here."""
    nq = pos_starts.shape[0] - 1
    dev = tile_slots.device
    scores = torch.zeros((nq, n_slots + 1), dtype=torch.float32, device=dev)
    counts = torch.zeros((nq, n_slots + 1), dtype=torch.int32, device=dev)
    for q, tiles, boost in _position_items(pos_starts, runs):
        slots, vals = _tile_values(tiles, boost, tile_slots, tile_impacts,
                                   tile_scales)
        valid = slots >= 0
        tgt = torch.where(valid, slots, torch.full_like(slots, n_slots))
        q = q[:, None].expand_as(tgt)
        scores.index_put_((q, tgt), torch.where(valid, vals,
                                                torch.zeros_like(vals)),
                          accumulate=True)
        counts.index_put_((q, tgt), valid.to(torch.int32), accumulate=True)
    vals, idx = board_top_k(scores, counts, required, k)
    return vals, torch.where(vals > -math.inf, idx,
                             torch.full_like(idx, -1)).to(torch.int32)


def bm25_board_ranged_reference(pos_starts: torch.Tensor, runs: torch.Tensor,
                                required: torch.Tensor,
                                tile_first: torch.Tensor,
                                tile_slots: torch.Tensor,
                                tile_impacts: torch.Tensor,
                                tile_scales: Optional[torch.Tensor], k: int,
                                n_slots: int,
                                range_slots: Optional[int] = None, *,
                                sms: Optional[int] = None):
    """The plain version of the kernels' decomposition: `launch_plan`'s
    ranges (for `sms` SMs, or `range_slots` forced), each scored on its
    own board over `range_windows`'s tiles, its top k' taken, the
    candidates merged into the top k; the same window as
    `bm25_board_reference`."""
    nq = pos_starts.shape[0] - 1
    plan = launch_plan(nq, n_slots, k, range_slots, sms=sms)
    ps = pos_starts.tolist()
    first_h, runs_h = tile_first.cpu().numpy(), runs.cpu().numpy()
    boost = runs[2].contiguous().view(torch.float32)
    req = required.tolist()
    dev = tile_slots.device
    out_v, out_s = [], []
    for q in range(nq):
        cv, cs = [], []
        for r in range(plan.n_ranges):
            lo = r * plan.range_slots
            width = min(plan.range_slots, n_slots - lo)
            start, count = range_windows(first_h, runs_h[:, ps[q]:ps[q + 1]],
                                         lo, lo + width)
            scores = torch.zeros(width + 1, dtype=torch.float32, device=dev)
            counts = torch.zeros(width + 1, dtype=torch.int32, device=dev)
            for j in range(len(start)):
                if not count[j]:
                    continue
                tiles = torch.arange(int(start[j]), int(start[j] + count[j]),
                                     device=dev)
                slots, vals = _tile_values(
                    tiles, boost[ps[q] + j].expand(len(tiles)), tile_slots,
                    tile_impacts, tile_scales)
                inr = (slots >= lo) & (slots < lo + width)
                tgt = torch.where(inr, slots - lo,
                                  torch.full_like(slots, width))
                scores.index_put_((tgt,), torch.where(
                    inr, vals, torch.zeros_like(vals)), accumulate=True)
                counts.index_put_((tgt,), inr.to(torch.int32),
                                  accumulate=True)
            masked = torch.where(counts[:width] >= max(req[q], 1),
                                 scores[:width],
                                 torch.full_like(scores[:width], -math.inf))
            v, i = top_k(masked, min(plan.k_range, width))
            cv.append(v)
            cs.append(i + lo)
        v, i = top_k(torch.cat(cv), k)
        out_v.append(v)
        out_s.append(torch.where(v > -math.inf, torch.cat(cs)[i],
                                 torch.full_like(i, -1)))
    return (torch.stack(out_v),
            torch.stack(out_s).to(torch.int32))


def _check_inputs(pos_starts, runs, required, tile_first, tile_slots,
                  tile_impacts, tile_scales, k, n_slots) -> None:
    """Raise on anything the kernels do not take: they read every pointer
    at the sizes given here."""
    tensors = [pos_starts, runs, required, tile_first, tile_slots,
               tile_impacts]
    if tile_scales is not None:
        tensors.append(tile_scales)
    dev = tile_slots.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must lie on one CUDA device")
    if any(t.dtype != torch.int32 for t in tensors[:5]):
        raise TypeError("the plan, required and the tile slots must be int32")
    if tile_impacts.dtype not in _DTYPE_CODES:
        raise TypeError(f"no bm25_board kernel for {tile_impacts.dtype} "
                        f"impacts")
    if (tile_impacts.dtype == torch.int8) != (tile_scales is not None):
        raise ValueError("int8 impacts need their tile scales, and only "
                         "they take scales")
    n_tiles = tile_slots.shape[0] if tile_slots.dim() == 2 else -1
    if tile_scales is not None and (tile_scales.dtype != torch.float32
                                    or tuple(tile_scales.shape)
                                    != (n_tiles,)):
        raise ValueError("tile scales must be f32 [T]")
    nq = pos_starts.shape[0] - 1 if pos_starts.dim() == 1 else -1
    if nq < 1 or tuple(required.shape) != (nq,) \
            or runs.dim() != 2 or runs.shape[0] != 3 \
            or tile_slots.dim() != 2 or tile_slots.shape[1] != TILE \
            or tile_impacts.shape != tile_slots.shape \
            or tuple(tile_first.shape) != (n_tiles,):
        raise ValueError(
            f"shape mismatch: pos_starts {tuple(pos_starts.shape)}, runs "
            f"{tuple(runs.shape)}, required {tuple(required.shape)}, tiles "
            f"{tuple(tile_first.shape)} / {tuple(tile_slots.shape)} / "
            f"{tuple(tile_impacts.shape)}")
    if not 1 <= n_slots < 2 ** 31 or not 1 <= k <= n_slots:
        raise ValueError(f"need 1 <= k <= n_slots < 2^31, got k {k}, "
                         f"n_slots {n_slots}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if tile_slots.data_ptr() % 16 or tile_impacts.data_ptr() % 16:
        raise ValueError("tile slots and impacts must be 16-byte aligned")


def bm25_board(pos_starts: torch.Tensor, runs: torch.Tensor,
               required: torch.Tensor, tile_first: torch.Tensor,
               tile_slots: torch.Tensor, tile_impacts: torch.Tensor,
               tile_scales: Optional[torch.Tensor], k: int, n_slots: int,
               variant: Optional[str] = None,
               range_slots: Optional[int] = None):
    """A batch's windows: (vals [Q, k] f32, slots [Q, k] int32), each
    query's slots counted at least max(required, 1) times, ranked by
    (score desc, slot asc), -inf / -1 past the matched count.

    The plan (`LexicalField.plan_positions`): `pos_starts` [Q + 1] int32,
    query q's entries runs[:, pos_starts[q]:pos_starts[q + 1]] of `runs`
    [3, P] int32 (first tile, tile count, boost as f32 bits), in query-term
    order; `required` [Q] int32. The field: `tile_first` [T], `tile_slots`
    [T, TILE] int32, `tile_impacts` [T, TILE] f32 / bf16 / int8 with
    `tile_scales` [T] f32 for int8. On CUDA tensors the two kernels of
    `csrc/bm25.cu` run on the current stream (one call counted, also under
    `variant` when given: the learned-sparse layout counts as `sparse`),
    over `launch_plan`'s ranges for the card's SMs (`range_slots` forces
    R); on CPU tensors the plain version; anything else raises. The
    plan's values are checked by `check_plan` on the CPU; on the card the
    caller checks its host copy before the upload (`_score_device`)."""
    tensors = [pos_starts, runs, required, tile_first, tile_slots,
               tile_impacts]
    if tile_scales is not None:
        tensors.append(tile_scales)
    if all(t.device.type == "cpu" for t in tensors):
        check_plan(pos_starts.numpy(), runs.numpy(), tile_slots.shape[0])
        return bm25_board_reference(pos_starts, runs, required, tile_first,
                                    tile_slots, tile_impacts, tile_scales,
                                    k, n_slots)
    _check_inputs(pos_starts, runs, required, tile_first, tile_slots,
                  tile_impacts, tile_scales, k, n_slots)
    nq = pos_starts.shape[0] - 1
    dev = tile_slots.device
    plan = launch_plan(nq, n_slots, k, range_slots,
                       sms=_sm_count(dev.index if dev.index is not None
                                     else torch.cuda.current_device()))
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    slots = torch.empty((nq, k), dtype=torch.int32, device=dev)
    cand = torch.empty((nq, plan.n_cand), dtype=torch.int64, device=dev)
    sort = None if plan.sort_in_smem else torch.empty(
        (nq, plan.sort_n), dtype=torch.int64, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.bm25_board(
        pos_starts.data_ptr(), runs.data_ptr(), runs.shape[1],
        required.data_ptr(), nq, tile_first.data_ptr(),
        tile_slots.data_ptr(), tile_impacts.data_ptr(),
        None if tile_scales is None else tile_scales.data_ptr(),
        _DTYPE_CODES[tile_impacts.dtype], n_slots, plan.range_slots, k,
        cand.data_ptr(), int(plan.sort_in_smem),
        None if sort is None else sort.data_ptr(), vals.data_ptr(),
        slots.data_ptr(), stream)
    if code != 0:
        raise RuntimeError(f"{KERNEL} launch failed: "
                           f"{lib.cuda_error_string(code).decode()}")
    dispatch.count_launch(KERNEL, variant, f"q{nq}.slots{n_slots}.k{k}")
    return vals, slots


def board_top_k(scores: torch.Tensor, counts: torch.Tensor,
                required: torch.Tensor, k: int):
    """Mask the slots matched fewer than max(required, 1) times to -inf,
    drop the padding lane, and take the top k (ties to the lower slot)."""
    w = scores.shape[1] - 1
    need = torch.clamp(required, min=1)[:, None]
    masked = torch.where(counts[:, :w] >= need, scores[:, :w],
                         torch.full_like(scores[:, :w], -math.inf))
    return top_k(masked, k)


# ------------------------------------------------------------------- field

class LexicalField:
    """One text field's tile-padded impact layout over a reader snapshot.

    Host arrays are the source of truth (and the host scoring twin); the
    device copies upload on the first board search of a version.
    `ops/sparse.py::SparseField` retargets the layout and the board at
    learned-sparse weights by overriding `sync` and `_term_boosts`."""

    # counted beside the kernel's launches (`bm25_board(variant=)`)
    VARIANT: Optional[str] = None

    def __init__(self, field: str, dtype: str = "f32", device="cuda"):
        if dtype not in _IMPACT_BYTES:
            raise ValueError(f"unknown lexical impact dtype [{dtype}]; "
                             f"expected one of {sorted(_IMPACT_BYTES)}")
        self.field = field
        self.dtype = dtype              # f32 (exact) | bf16 | int8
        self.device = resolve_device(device)
        self.version: tuple = ()
        self.n_slots = 0
        self.row_map = np.zeros(0, dtype=np.int64)  # slot -> global row
        # tile-padded CSR (term-major): [n_tiles, TILE]
        self.tile_slots = np.full((0, TILE), -1, dtype=np.int32)
        self.tile_impacts = np.zeros((0, TILE), dtype=np.float32)
        self.tile_first = np.zeros(0, dtype=np.int32)   # each tile's lane 0
        self.term_tiles: Dict[str, Tuple[int, int]] = {}  # term -> (first, n)
        self.nnz = 0
        self.columnar_refresh: dict = {}
        # per-segment postings blocks, keyed by fingerprint and base
        self._blocks: Dict[tuple, object] = {}
        self._device = None     # (slots, impacts, scales, first) tensors
        self._device_version: tuple = ()

    # ------------------------------------------------------------- build
    def sync(self, reader) -> bool:
        """(Re)build from a reader snapshot; True if rebuilt. Segments
        whose postings block is kept are not extracted again."""
        version = self._version_of(reader)
        if version == self.version:
            return False
        blocks = self._sync_blocks(reader, version,
                                   columnar.extract_postings_block)
        lengths = (np.concatenate([b.lengths for b in blocks]) if blocks
                   else np.zeros(0, dtype=np.float32))
        terms, dfs, slot_flat, freq_flat = self._merge(blocks)
        ptr = np.zeros(len(dfs) + 1, dtype=np.int64)
        np.cumsum(dfs, out=ptr[1:])
        self.nnz = len(slot_flat)
        len_flat = lengths[slot_flat] if self.nnz else \
            np.zeros(0, dtype=np.float32)

        # global stats: the quantities the host query path reads
        n = max(reader.docs_with_field_count(self.field), 1)
        avg_len = reader.avg_field_length(self.field) or 1.0
        # impacts, one native call a distinct df
        impact_flat = np.zeros(self.nnz, dtype=np.float32)
        df_post = np.repeat(dfs, dfs)
        by_df = np.argsort(df_post, kind="stable")
        cuts = np.nonzero(np.diff(df_post[by_df]))[0] + 1
        for gather in np.split(by_df, cuts) if self.nnz else ():
            df = int(df_post[gather[0]])
            idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
            impact_flat[gather] = native.bm25_score(
                freq_flat[gather], len_flat[gather], idf, avg_len,
                BM25_K1, BM25_B, 1.0)

        self._install_tiles(terms, dfs, ptr, slot_flat, impact_flat)
        self.version = version
        return True

    @staticmethod
    def _version_of(reader) -> tuple:
        # a combined reader repeats seg_ids across shards: the base (the
        # shard's row offset) tells their segments apart
        return tuple((columnar.fingerprint(v), v.segment.base)
                     for v in reader.views)

    def _sync_blocks(self, reader, version: tuple, extract) -> list:
        """The reader's per-segment blocks (`extract(view, field)` for the
        segments not kept from the last build, keyed as `version` names
        them), and its slot space."""
        blocks, cache = [], {}
        n_cached = n_extracted = 0
        for view, key in zip(reader.views, version):
            blk = self._blocks.get(key)
            if blk is None:
                blk = extract(view, self.field)
                n_extracted += 1
            else:
                n_cached += 1
            cache[key] = blk
            blocks.append(blk)
        self._blocks = cache
        self.columnar_refresh = {
            "blocks": n_cached + n_extracted, "cached": n_cached,
            "extracted": n_extracted,
            "mode": ("cached" if not n_extracted else
                     "delta" if n_cached else "full")}
        # dense slot space: segment-major, ascending local order, so the
        # row map ascends and slot tie-breaks are row tie-breaks
        self.n_slots = sum(b.n_live for b in blocks)
        rows = [np.nonzero(v.live)[0].astype(np.int64) + v.segment.base
                for v in reader.views]
        self.row_map = (np.concatenate(rows) if rows
                        else np.zeros(0, dtype=np.int64))
        return blocks

    @staticmethod
    def _merge(blocks, values: str = "freqs"):
        """Terms (sorted) with their df and their postings, term-major,
        segment order within a term, slots ascending: (terms list, dfs
        int64, slots int32, each block's `values` array in the same
        order) in the dense slot space."""
        if not blocks:
            return ([], np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
        bases = np.cumsum([0] + [b.n_live for b in blocks[:-1]])
        if len(blocks) == 1:
            b = blocks[0]
            return (b.terms.tolist(), np.diff(b.starts), b.slots,
                    getattr(b, values))
        words, inv = np.unique(np.concatenate([b.terms for b in blocks]),
                               return_inverse=True)
        ranks, at = [], 0
        for b in blocks:
            nt = len(b.terms)
            ranks.append(np.repeat(inv[at:at + nt], np.diff(b.starts)))
            at += nt
        rank = np.concatenate(ranks)
        order = np.argsort(rank, kind="stable")
        slots = np.concatenate([b.slots + np.int32(base)
                                for b, base in zip(blocks, bases)])
        vals = np.concatenate([getattr(b, values) for b in blocks])
        dfs = np.bincount(rank, minlength=len(words)).astype(np.int64)
        return words.tolist(), dfs, slots[order], vals[order]

    def _install_tiles(self, terms, dfs, ptr, slot_flat, impact_flat):
        """Tile-pad the term-major flat (slot, impact) runs: each term's
        run rounds up to whole TILE-lane tiles."""
        dfs = np.asarray(dfs, dtype=np.int64)
        n_tiles = np.where(dfs > 0, np.maximum(1, -(-dfs // TILE)), 0)
        first = np.zeros(len(dfs), dtype=np.int64)
        if len(dfs):
            np.cumsum(n_tiles[:-1], out=first[1:])
        total = int(n_tiles.sum())
        tile_slots = np.full((max(total, 1), TILE), -1, dtype=np.int32)
        tile_impacts = np.zeros((max(total, 1), TILE), dtype=np.float32)
        term_of = np.repeat(np.arange(len(dfs)), dfs)
        dest = first[term_of] * TILE + (np.arange(len(slot_flat))
                                        - ptr[term_of])
        tile_slots.reshape(-1)[dest] = slot_flat
        tile_impacts.reshape(-1)[dest] = impact_flat
        self.term_tiles = {t: (f, nt) for t, f, nt in
                           zip(terms, first.tolist(), n_tiles.tolist())
                           if nt}
        self.tile_slots = tile_slots
        self.tile_impacts = tile_impacts
        # a run starts on a new tile and pads only at its end, so lane 0 of
        # a run's tile is valid, and the first slots ascend within a run
        self.tile_first = np.ascontiguousarray(tile_slots[:, 0])

    # ------------------------------------------------------------ search
    def nbytes(self) -> int:
        return (self.tile_slots.size * 4
                + self.tile_impacts.size * _IMPACT_BYTES[self.dtype])

    def _device_arrays(self):
        """The tiles on the card: (slots, impacts, scales or None)."""
        return self._upload()[:3]

    def _device_tile_first(self) -> torch.Tensor:
        return self._upload()[3]

    def _upload(self):
        if self._device is not None and self._device_version == self.version:
            return self._device
        dev = self.device
        slots = torch.from_numpy(self.tile_slots).to(dev)
        scales = None
        if self.dtype == "bf16":
            impacts = torch.from_numpy(self.tile_impacts).to(dev).to(
                torch.bfloat16)
        elif self.dtype == "int8":
            # one symmetric scale a tile: a tile's impacts share one
            # term's idf, so its dynamic range is narrow
            enc = quant_codec.get("int8").encode_np(self.tile_impacts)
            impacts = torch.from_numpy(enc.data).to(dev)
            scales = torch.from_numpy(enc.scales).to(dev)
        else:
            impacts = torch.from_numpy(self.tile_impacts).to(dev)
        first = torch.from_numpy(self.tile_first).to(dev)
        self._device = (slots, impacts, scales, first)
        self._device_version = self.version
        return self._device

    @staticmethod
    def _term_boosts(query):
        """A query's (term, the boost its tiles carry) pairs in order: a
        lexical query is (terms, boost), each term carrying the boost."""
        terms, boost = query
        return ((t, boost) for t in terms)

    def plan_queries(self, queries) -> Tuple[np.ndarray, np.ndarray, int]:
        """Resolve each query's terms to padded tile id / boost matrices
        (the host twin's plan): every tile of every resolved term, in
        query-term order; out-of-vocabulary terms add none."""
        per_q = []
        for query in queries:
            spans = [(span[0], span[1], boost)
                     for t, boost in self._term_boosts(query)
                     if (span := self.term_tiles.get(t)) is not None]
            if not spans:
                per_q.append((np.zeros(0, dtype=np.int64),
                              np.zeros(0, dtype=np.float32)))
                continue
            first, nt, boost = (np.asarray(c) for c in zip(*spans))
            nt = nt.astype(np.int64)
            run_start = np.repeat(np.cumsum(nt) - nt, nt)
            per_q.append((np.repeat(first.astype(np.int64), nt)
                          + (np.arange(int(nt.sum())) - run_start),
                          np.repeat(boost.astype(np.float32), nt)))
        m = _pow2(max(max((len(t) for t, _b in per_q), default=1), 1))
        tile_ids = np.full((len(per_q), m), -1, dtype=np.int32)
        boosts = np.zeros((len(per_q), m), dtype=np.float32)
        for qi, (tiles, b) in enumerate(per_q):
            tile_ids[qi, :len(tiles)] = tiles
            boosts[qi, :len(tiles)] = b
        return tile_ids, boosts, m

    def plan_positions(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """The board's plan, one entry a (query, term position): (pos_starts
        [Q + 1] int32, runs [3, P] int32), query q's entries runs[:,
        pos_starts[q]:pos_starts[q + 1]] being its in-vocabulary terms in
        query-term order (a repeated term once each time) as (first tile,
        tile count, the term's boost as f32 bits)."""
        starts, first, n_tiles, boost = [0], [], [], []
        for query in queries:
            for t, b in self._term_boosts(query):
                span = self.term_tiles.get(t)
                if span is None:
                    continue
                first.append(span[0])
                n_tiles.append(span[1])
                boost.append(b)
            starts.append(len(first))
        runs = np.empty((3, len(first)), dtype=np.int32)
        runs[0] = first
        runs[1] = n_tiles
        runs[2] = np.asarray(boost, dtype=np.float32).view(np.int32)
        return np.asarray(starts, dtype=np.int32), runs

    def _score_host(self, tile_ids, boosts, required, k):
        """Numpy twin of the board over the f32 impacts: the same
        accumulation order (term-major, f32) and tie-breaks."""
        nq = tile_ids.shape[0]
        out = []
        for qi in range(nq):
            scores = np.zeros(self.n_slots, dtype=np.float32)
            counts = np.zeros(self.n_slots, dtype=np.int32)
            real = tile_ids[qi] >= 0
            tids = tile_ids[qi][real]
            slots = self.tile_slots[tids]
            valid = slots >= 0
            sv = slots[valid]
            vals = (self.tile_impacts[tids]
                    * boosts[qi][real][:, None])[valid]
            # tile by tile in plan order; a run of lanes whose slots
            # strictly ascend holds no slot twice, so one add a run is
            # the per-tile adds in the same order
            cuts = np.nonzero(sv[1:] <= sv[:-1])[0] + 1
            for lo, hi in zip(np.concatenate([[0], cuts]),
                              np.concatenate([cuts, [len(sv)]])):
                scores[sv[lo:hi]] += vals[lo:hi]
                counts[sv[lo:hi]] += 1
            req = int(required[qi])
            elig = np.nonzero(counts >= max(req, 1))[0]
            kk = min(k, len(elig))
            top = native.topk(scores[elig], kk)
            sel = elig[top]
            out.append((self.row_map[sel],
                        scores[sel].astype(np.float32)))
        return out

    def _score_device(self, queries, required, k):
        """The board route: the plan up in one copy, one `bm25_board` call
        for the batch (its two kernels on the card), the [Q, k] window down
        in one copy."""
        nq = len(queries)
        slots_d, impacts_d, scales_d = self._device_arrays()
        k_req = min(k, self.n_slots)
        pos_starts, runs = self.plan_positions(queries)
        check_plan(pos_starts, runs, len(self.tile_slots))
        n_runs = runs.shape[1]
        plan = torch.from_numpy(np.concatenate(
            [pos_starts, runs.reshape(-1), required])).to(self.device)
        vals, slot_idx = bm25_board(
            plan[:nq + 1], plan[nq + 1:nq + 1 + 3 * n_runs].view(3, n_runs),
            plan[nq + 1 + 3 * n_runs:], self._device_tile_first(), slots_d,
            impacts_d, scales_d, k_req, self.n_slots, variant=self.VARIANT)
        window = torch.stack([vals.view(torch.int32), slot_idx]).cpu().numpy()
        out = []
        for qi in range(nq):
            keep = window[1, qi] >= 0
            out.append((self.row_map[window[1, qi][keep]],
                        window[0, qi][keep].view(np.float32)))
        return out

    def search_batch(self, queries, window: int, required=None,
                     route: str = "device"):
        """Score a batch of (terms, boost) queries; returns per query
        (global rows ranked by (-score, row), f32 scores), len <= window.

        required: per-query minimum matched clauses (operator `and` /
        minimum_should_match), default 1. route: "host" for the numpy
        twin, else the board. A window of 0 is empty on either route."""
        if self.n_slots == 0 or not self.term_tiles or not queries \
                or window < 1:
            return [(np.zeros(0, dtype=np.int64),
                     np.zeros(0, dtype=np.float32)) for _ in queries]
        if required is None:
            required = np.ones(len(queries), dtype=np.int32)
        else:
            required = np.asarray(required, dtype=np.int32)
        if route == "host":
            tile_ids, boosts, _m = self.plan_queries(queries)
            return self._score_host(tile_ids, boosts, required, window)
        return self._score_device(queries, required, window)


class LexicalShard:
    """Per-reader lexical store: one LexicalField per text field, synced
    lazily on first lexical use (most refreshes never serve a lexical
    leg, and the build is a full postings pass)."""

    FIELD_CLS = LexicalField

    def __init__(self, dtype: str = "f32", device="cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._fields: Dict[str, LexicalField] = {}
        self._lock = threading.Lock()

    def field(self, reader, name: str) -> LexicalField:
        with self._lock:
            lf = self._fields.get(name)
            if lf is None:
                lf = self.FIELD_CLS(name, dtype=self.dtype,
                                    device=self.device)
                self._fields[name] = lf
            lf.sync(reader)
            return lf

    def search_batch(self, reader, field: str, queries, window: int,
                     required=None, route: str = "device"):
        return self.field(reader, field).search_batch(
            queries, window, required=required, route=route)
