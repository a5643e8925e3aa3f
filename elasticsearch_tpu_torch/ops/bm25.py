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

* search: one board a batch (`bm25_board`, `csrc/bm25.cu`): each query's
  term tiles add their impacts into a [Q, W + 1] score board and a count
  board (W = pow2(live docs); lane W is the padding lane), term position
  by term position, so every slot adds in query-term order and the f32
  sums equal the reference's bit for bit. The slots whose count is below
  the query's required matches (operator `and`, `minimum_should_match`)
  mask to -inf, and `ops/topk.py::top_k` cuts the ranked window, ties to
  the lower slot (slots ascend with the global row), as `native.topk`
  breaks them.

Routes: `search_batch(route="host")` runs `_score_host`, the numpy twin of
the board over the f32 impacts; any other route runs the board, whose
wrapper launches the kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. The reference picks between the two with its
CostModel when a card is present; the port has no CostModel yet, so a
field whose tensors are on the card always takes the board.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

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

def _lib() -> ctypes.CDLL:
    lib = _build.load("bm25")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bm25_board.argtypes = [p, p, ll, p, ll, p, i, p, p, p, i, ll]
        lib.bm25_board.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def bm25_board_reference(scores: torch.Tensor, counts: torch.Tensor,
                         items: torch.Tensor, starts: np.ndarray,
                         tile_slots: torch.Tensor, tile_impacts: torch.Tensor,
                         tile_scales: Optional[torch.Tensor]) -> None:
    """The plain PyTorch version of `bm25_board`, in place: term position
    by term position, gather its items' tiles, form (imp [* scale]) *
    boost in that order, and add with `index_put_(accumulate=True)`. The
    indices of one position are unique but for the padding lane, which
    gets only zeros, so each add is exact and in the kernel's order."""
    w = scores.shape[1] - 1
    q_all, tile_all = items[0].long(), items[1].long()
    boost_all = items[2].view(torch.float32)
    for j in range(len(starts) - 1):
        lo, hi = int(starts[j]), int(starts[j + 1])
        if hi <= lo:
            continue
        tiles = tile_all[lo:hi]
        slots = tile_slots[tiles].long()                      # [n, TILE]
        imp = tile_impacts[tiles].to(torch.float32)
        if tile_scales is not None:
            imp = imp * tile_scales[tiles][:, None]
        imp = imp * boost_all[lo:hi][:, None]
        valid = slots >= 0
        tgt = torch.where(valid, slots, torch.full_like(slots, w))
        q = q_all[lo:hi][:, None].expand_as(tgt)
        scores.index_put_((q, tgt), torch.where(valid, imp,
                                                torch.zeros_like(imp)),
                          accumulate=True)
        counts.index_put_((q, tgt), valid.to(counts.dtype), accumulate=True)


def _check_inputs(scores, counts, items, starts, tile_slots, tile_impacts,
                  tile_scales) -> None:
    """Raise on anything the kernel does not take: it reads every pointer
    at the sizes given here."""
    tensors = [scores, counts, items, tile_slots, tile_impacts]
    if tile_scales is not None:
        tensors.append(tile_scales)
    dev = scores.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must lie on one CUDA device")
    if scores.dtype != torch.float32 or counts.dtype != torch.int32 \
            or items.dtype != torch.int32 or tile_slots.dtype != torch.int32:
        raise TypeError("boards must be f32 / int32, items and tile slots "
                        "int32")
    if tile_impacts.dtype not in _DTYPE_CODES:
        raise TypeError(f"no bm25_board kernel for {tile_impacts.dtype} "
                        f"impacts")
    if (tile_impacts.dtype == torch.int8) != (tile_scales is not None):
        raise ValueError("int8 impacts need their tile scales, and only "
                         "they take scales")
    if tile_scales is not None and (tile_scales.dtype != torch.float32
                                    or tuple(tile_scales.shape)
                                    != (tile_slots.shape[0],)):
        raise ValueError("tile scales must be f32 [T]")
    if scores.shape != counts.shape or scores.dim() != 2 \
            or tile_slots.dim() != 2 or tile_slots.shape[1] != TILE \
            or tile_impacts.shape != tile_slots.shape \
            or items.dim() != 2 or items.shape[0] != 3:
        raise ValueError(
            f"shape mismatch: boards {tuple(scores.shape)} / "
            f"{tuple(counts.shape)}, items {tuple(items.shape)}, tiles "
            f"{tuple(tile_slots.shape)} / {tuple(tile_impacts.shape)}")
    if starts.dtype != np.int32 or starts.ndim != 1 or len(starts) < 1 \
            or int(starts[-1]) != items.shape[1] \
            or (np.diff(starts) < 0).any():
        raise ValueError("starts must be ascending int32 [n_pos + 1] "
                         "ending at the item count")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def bm25_board(scores: torch.Tensor, counts: torch.Tensor,
               items: torch.Tensor, starts: np.ndarray,
               tile_slots: torch.Tensor, tile_impacts: torch.Tensor,
               tile_scales: Optional[torch.Tensor] = None,
               variant: Optional[str] = None) -> None:
    """Add a batch's impacts into zeroed boards, in place: `scores` [Q,
    W + 1] f32 and `counts` [Q, W + 1] int32. `items` [3, I] int32 holds
    each work item's (query, tile, boost as f32 bits), grouped by term
    position: items starts[j]:starts[j + 1] (`starts`, host int32 [P + 1])
    are the tiles of every query's j-th term. On CUDA tensors the kernel
    runs, one launch a term position on the current stream (one launch
    set, counted once, also under `variant` when given: the learned-sparse
    layout counts as `sparse`); on CPU tensors its plain version; anything
    else raises."""
    tensors = [scores, counts, items, tile_slots, tile_impacts]
    if tile_scales is not None:
        tensors.append(tile_scales)
    if all(t.device.type == "cpu" for t in tensors):
        bm25_board_reference(scores, counts, items, starts, tile_slots,
                             tile_impacts, tile_scales)
        return
    starts = np.ascontiguousarray(starts)
    _check_inputs(scores, counts, items, starts, tile_slots, tile_impacts,
                  tile_scales)
    lib = _lib()
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    code = lib.bm25_board(
        scores.data_ptr(), counts.data_ptr(), scores.shape[1],
        items.data_ptr(), items.shape[1],
        starts.ctypes.data_as(ctypes.c_void_p), len(starts) - 1,
        tile_slots.data_ptr(), tile_impacts.data_ptr(),
        None if tile_scales is None else tile_scales.data_ptr(),
        _DTYPE_CODES[tile_impacts.dtype], stream)
    if code != 0:
        raise RuntimeError(f"{KERNEL} launch failed: "
                           f"{lib.cuda_error_string(code).decode()}")
    dispatch.count_launch(KERNEL, variant)


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
        self.term_tiles: Dict[str, Tuple[int, int]] = {}  # term -> (first, n)
        self.nnz = 0
        self.columnar_refresh: dict = {}
        # per-segment postings blocks, keyed by fingerprint and base
        self._blocks: Dict[tuple, object] = {}
        self._device = None             # (slots, impacts, scales) tensors
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

    # ------------------------------------------------------------ search
    def nbytes(self) -> int:
        return (self.tile_slots.size * 4
                + self.tile_impacts.size * _IMPACT_BYTES[self.dtype])

    def _device_arrays(self):
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
        self._device = (slots, impacts, scales)
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
        """The board's work items, grouped by term position: (items [3, I]
        int32 of (query, tile, boost bits), starts [P + 1] int32), items
        starts[j]:starts[j + 1] holding the tiles of every query's j-th
        in-vocabulary term (a repeated term is one position each time),
        each with that term's boost."""
        q_of, first, n_tiles, boost, pos = [], [], [], [], []
        for qi, query in enumerate(queries):
            j = 0
            for t, b in self._term_boosts(query):
                span = self.term_tiles.get(t)
                if span is None:
                    continue
                q_of.append(qi)
                first.append(span[0])
                n_tiles.append(span[1])
                boost.append(b)
                pos.append(j)
                j += 1
        if not q_of:
            return (np.zeros((3, 0), dtype=np.int32),
                    np.zeros(1, dtype=np.int32))
        # position-major, queries ascending within a position (a stable
        # sort of the query-major list)
        pos = np.asarray(pos, dtype=np.int64)
        order = np.argsort(pos, kind="stable")
        nt = np.asarray(n_tiles, dtype=np.int64)[order]
        run_start = np.repeat(np.cumsum(nt) - nt, nt)
        tile = np.repeat(np.asarray(first, dtype=np.int64)[order], nt) \
            + (np.arange(int(nt.sum())) - run_start)
        items = np.stack([
            np.repeat(np.asarray(q_of, dtype=np.int32)[order], nt),
            tile.astype(np.int32),
            np.repeat(np.asarray(boost, dtype=np.float32)[order],
                      nt).view(np.int32)])
        per_pos = np.bincount(pos, weights=n_tiles).astype(np.int64)
        starts = np.zeros(len(per_pos) + 1, dtype=np.int32)
        np.cumsum(per_pos, out=starts[1:])
        return np.ascontiguousarray(items), starts

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
        """The board route: one `bm25_board` launch set for the batch,
        padded to its query bucket, then the masked top k."""
        n_real = len(queries)
        n_pad = dispatch.bucket_queries(n_real)
        slots_d, impacts_d, scales_d = self._device_arrays()
        # board width pads to a pow2 of the live docs; pad slots keep
        # count 0, so the required-mask turns them to -inf
        w = _pow2(max(self.n_slots, 1))
        k_req = min(k, max(self.n_slots, 1))
        k_b = dispatch.bucket_k(k_req, limit=w)
        items, starts = self.plan_positions(queries)
        dev = self.device
        scores = torch.zeros((n_pad, w + 1), dtype=torch.float32, device=dev)
        counts = torch.zeros((n_pad, w + 1), dtype=torch.int32, device=dev)
        req = np.ones(n_pad, dtype=np.int32)
        req[:n_real] = required
        bm25_board(scores, counts, torch.from_numpy(items).to(dev), starts,
                   slots_d, impacts_d, scales_d, variant=self.VARIANT)
        vals, slot_idx = board_top_k(scores, counts,
                                     torch.from_numpy(req).to(dev), k_b)
        vals = vals[:n_real, :k_req].cpu().numpy()
        slot_idx = slot_idx[:n_real, :k_req].cpu().numpy()
        out = []
        for qi in range(n_real):
            v, si = vals[qi], slot_idx[qi]
            keep = v > -np.inf
            out.append((self.row_map[si[keep]],
                        v[keep].astype(np.float32)))
        return out

    def search_batch(self, queries, window: int, required=None,
                     route: str = "device"):
        """Score a batch of (terms, boost) queries; returns per query
        (global rows ranked by (-score, row), f32 scores), len <= window.

        required: per-query minimum matched clauses (operator `and` /
        minimum_should_match), default 1. route: "host" for the numpy
        twin, else the board."""
        if self.n_slots == 0 or not self.term_tiles:
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
