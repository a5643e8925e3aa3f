"""Generational corpus and background merge scheduler (port of
`elasticsearch_tpu/segments/generational.py`, less the mesh and the host
mirror).

`GenerationalCorpus` is the device side of the engine's segment life:
a refresh seals the new rows into a small L0 generation (O(delta), never a
re-upload of the corpus), deletes set per-generation tombstones, and a
budgeted background thread merges generations up the tier ladder. Every
install is copy-on-write, so a search dispatched against an earlier
generation set keeps reading valid tensors: a batch's handle holds its
`GenerationSet` until it has landed.

The merge thread also owns the IVF retrain: a merge that makes a new base
re-enters the trained layout (clone + add the delta), or retrains when the
layout drifted or the base had tombstones. The refresh thread never pays
for it.

Search runs one board a generation and merges the boards with
`ops/topk.merge_top_k`: their concatenation in generation order breaks
ties by the lower flat row, as the single corpus's top-k does.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import dispatch
from elasticsearch_tpu_torch.ops import knn as knn_ops
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.similarity import NEG_INF
from elasticsearch_tpu_torch.quant import codec as quant_codec
from elasticsearch_tpu_torch.segments.generation import (
    KERNEL_BASE, Generation, build_generation,
)
from elasticsearch_tpu_torch.segments.policy import (
    MergeSpec, TieredMergePolicy,
)


class GenerationSet:
    """Immutable snapshot of the live generations (the searchable view).

    The flat row space is the concatenation of the generations' row maps
    in order (tombstoned rows keep their slots, masked, so positions hold
    between merges). `epoch` counts the refreshes that changed the set's
    rows: a merge keeps it, since it keeps the live rows and their order.
    """

    __slots__ = ("generations", "offsets", "row_map", "total_rows",
                 "total_pad", "dead_rows", "epoch")

    def __init__(self, generations: Sequence[Generation], epoch: int = 0):
        self.generations = tuple(generations)
        sizes = [g.n_rows for g in self.generations]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(
            np.int64) if sizes else np.zeros(1, dtype=np.int64)
        self.row_map = (np.concatenate([g.row_map for g in self.generations])
                        if self.generations else np.zeros(0, dtype=np.int64))
        self.total_rows = int(self.offsets[-1])
        self.total_pad = sum(g.n_pad for g in self.generations)
        self.dead_rows = sum(g.dead_rows for g in self.generations)
        self.epoch = epoch

    @property
    def simple(self) -> bool:
        """One clean generation: it serves as the single corpus does."""
        return (len(self.generations) == 1
                and not self.generations[0].has_tombstones)

    @property
    def l0_count(self) -> int:
        return sum(1 for g in self.generations if g.tier == 0)

    @property
    def nbytes(self) -> int:
        return sum(g.nbytes for g in self.generations)

    def live_row_map(self) -> np.ndarray:
        """Engine rows live now, in flat order (the refresh classifier's
        baseline)."""
        if self.dead_rows == 0:
            return self.row_map
        return np.concatenate([g.row_map[g.live_mask()]
                               for g in self.generations])

    def gather_rows(self, flat_ids: np.ndarray) -> np.ndarray:
        """f32 host rows of ascending unique flat row ids, read through
        each generation's RowSource: the two-phase rescore's gather."""
        flat_ids = np.asarray(flat_ids, dtype=np.int64)
        d = self.generations[0].source.dims if self.generations else 0
        out = np.zeros((len(flat_ids), d), dtype=np.float32)
        for gen, off in zip(self.generations, self.offsets[:-1]):
            lo, hi = np.searchsorted(flat_ids, [off, off + gen.n_rows])
            if hi > lo:
                out[lo:hi] = gen.source.gather(flat_ids[lo:hi] - off)
        return out

    # ------------------------------------------------------------ search
    def search_async(self, queries: torch.Tensor, queries_np: np.ndarray,
                     n_real: int, k_eff: int,
                     filters: Sequence[Optional[np.ndarray]], metric: str,
                     precision: str, num_candidates: Optional[int] = None,
                     bump: Optional[Callable] = None):
        """One board a generation, merged by `merge_top_k`.

        queries: [B_pad, D] f32 on the device, padded to the query bucket
        (`queries_np` the same on the host, for an IVF leg). filters: one
        allowed engine-row array (or None) a real request. Returns (scores,
        flat ids, phases): [B_pad, k_t] boards in the flat row space, not
        waited for."""
        dev = queries.device
        b_pad = queries.shape[0]
        k_t = dispatch.bucket_k(k_eff, limit=self.total_pad)
        any_filter = any(fr is not None for fr in filters)
        boards_s: List[torch.Tensor] = []
        boards_i: List[torch.Tensor] = []
        legs: List[str] = []
        for gen, off in zip(self.generations, self.offsets[:-1]):
            if gen.n_rows == 0:
                continue
            s, ids, leg = self._search_generation(
                gen, int(off), queries, queries_np, b_pad, k_t, any_filter,
                filters, metric, precision, num_candidates, bump)
            boards_s.append(s)
            boards_i.append(ids)
            legs.append(leg)
        if not boards_s:
            return (torch.full((b_pad, k_t), NEG_INF, dtype=torch.float32,
                               device=dev),
                    torch.full((b_pad, k_t), -1, dtype=torch.int64,
                               device=dev),
                    {"engine": "tpu_generational", "generations": 0})
        # concatenation in generation order: ties go to the lower flat row
        s, i = topk_ops.merge_top_k(torch.stack(boards_s),
                                    torch.stack(boards_i), k=k_t)
        return s, i, {"engine": "tpu_generational",
                      "generations": len(self.generations),
                      "l0_generations": self.l0_count,
                      "tombstoned_rows": self.dead_rows, "legs": legs}

    @staticmethod
    def _search_generation(gen: Generation, off: int, queries: torch.Tensor,
                           queries_np: np.ndarray, b_pad: int, k_t: int,
                           any_filter: bool, filters, metric: str,
                           precision: str, num_candidates: Optional[int],
                           bump: Optional[Callable]):
        """One generation's board [B_pad, k_t] in flat ids: its IVF router
        (an IVF base without tombstones or filters), else the exact route
        with the tombstone and filter mask, else the kernel route of an
        unmasked full-build base."""
        need_mask = gen.has_tombstones or any_filter
        dev = queries.device
        if gen.router is not None and not need_mask:
            reason = gen.router.should_fallback(min(k_t, gen.n_rows), False,
                                                precision)
            if reason is None:
                return GenerationSet._ivf_board(gen, off, queries_np, k_t,
                                                num_candidates, bump, dev)
        n_pad = gen.n_pad
        k_g = dispatch.bucket_k(min(k_t, n_pad), limit=n_pad)
        mask = None
        if any_filter:
            from elasticsearch_tpu_torch.vectors.store import filter_mask
            host = filter_mask(gen, filters, b_pad, n_pad)
            host.numpy()[:, :gen.n_rows] &= gen.live_mask()
            mask = host.to(dev, non_blocking=True)
        elif gen.has_tombstones:
            mask = gen.live_device_mask()
        if gen.kernel == KERNEL_BASE and mask is None:
            s, ids = knn_ops.knn_search_auto(queries, gen.corpus, k=k_g,
                                             metric=metric,
                                             precision=precision)
        else:
            s, ids = knn_ops.knn_search(queries, gen.corpus, k_g,
                                        metric=metric, filter_mask=mask,
                                        precision=precision)
        if bump is not None:
            bump(**{"segment_legs_auto" if mask is None
                    and gen.kernel == KERNEL_BASE
                    else "segment_legs_exact": 1})
        ids = ids.to(torch.int64) + off
        if k_g < k_t:
            s = torch.nn.functional.pad(s, (0, k_t - k_g), value=NEG_INF)
            ids = torch.nn.functional.pad(ids, (0, k_t - k_g), value=-1)
        return s, ids, gen.kernel

    @staticmethod
    def _ivf_board(gen: Generation, off: int, queries_np: np.ndarray,
                   k_t: int, num_candidates: Optional[int],
                   bump: Optional[Callable], dev):
        """An IVF base served through its router (which waits for the card
        between its phases), as a board on the device."""
        k_i = dispatch.bucket_k(min(k_t, gen.n_rows), limit=gen.n_rows)
        scores, rows, phases = gen.router.search(
            queries_np, k_i, num_candidates=num_candidates)
        rows = np.asarray(rows, dtype=np.int64)
        ids = np.where(rows >= 0, rows + off, -1)
        scores = np.asarray(scores, dtype=np.float32)
        if k_i < k_t:
            pad = ((0, 0), (0, k_t - k_i))
            scores = np.pad(scores, pad, constant_values=NEG_INF)
            ids = np.pad(ids, pad, constant_values=-1)
        if bump is not None:
            bump(ivf_searches=1,
                 fused_probe_searches=int(phases["fused_probe"]))
        return (torch.from_numpy(scores).to(dev),
                torch.from_numpy(ids).to(dev), "ivf")


class GenerationalCorpus:
    """One vector field's generation life: the O(delta) refresh classifier,
    the copy-on-write generation set and the background merge scheduler.
    `_lock` guards the installed set and the counters; a merge runs outside
    it, and its install checks that the merged generations are still the
    installed ones (a refresh that tombstoned a victim meanwhile drops the
    install; the next cycle retries on the new set)."""

    def __init__(self, metric: str, dtype: str, rescore: bool, dims: int,
                 device="cuda", policy: Optional[TieredMergePolicy] = None,
                 merge_budget_ms: float = 50.0, background: bool = True,
                 knn_params: Optional[dict] = None, view_cb=None,
                 ivf_build=None):
        self.metric = metric
        self.dtype = dtype
        self.rescore = bool(rescore)
        self.dims = int(dims)
        self.device = torch.device(device)
        self.policy = policy or TieredMergePolicy()
        self.merge_budget_ms = float(merge_budget_ms)
        self.background = bool(background)
        # the IVF parameters of the merge thread's retrain: engine and
        # min_rows; `ivf_build(vecs, metric, dtype)` makes the router
        self.knn_params = dict(knn_params or {})
        self.ivf_build = ivf_build
        # called outside the lock after a merge installs, so the store can
        # serve the new set and let go of the old one
        self.view_cb = view_cb
        self._lock = threading.Lock()
        self._set = GenerationSet(())
        self._epoch = 0
        self._next_gen_id = 0
        self._merge_thread: Optional[threading.Thread] = None
        self._last_merge_nanos = 0
        self._closed = False
        self.last_rebuild_reason: Optional[str] = None
        # the exception of the last background merge that failed, cleared
        # by the next merge that installs
        self.merge_error: Optional[BaseException] = None
        self.stats = {
            "seals": 0, "sealed_rows": 0, "merges": 0, "merge_nanos": 0,
            "merged_rows": 0, "aborted_merges": 0, "tombstone_deletes": 0,
            "ivf_background_builds": 0, "dtype_retargets": 0,
            "dtype_reencodes": 0}
        # merges installed, by the policy's reason
        self.merge_reasons: dict = {}

    # ------------------------------------------------------------ set-up
    @classmethod
    def from_monolithic(cls, corpus, row_map: np.ndarray, source,
                        metric: str, dtype: str, rescore: bool, dims: int,
                        router=None, **kwargs) -> "GenerationalCorpus":
        """A full build as generation 0, on the kernel route. `source` is
        the RowSource of the build's rows (an array is wrapped, pinning
        it)."""
        from elasticsearch_tpu_torch.columnar.store import RowSource
        if isinstance(source, np.ndarray):
            source = RowSource.from_array(source)
        gc = cls(metric, dtype, rescore, dims, **kwargs)
        gen = Generation(gc._next_gen_id, corpus,
                         np.asarray(row_map, dtype=np.int64), source,
                         kernel=KERNEL_BASE, router=router)
        gc._next_gen_id += 1
        gc._set = GenerationSet((gen,))
        return gc

    def snapshot(self) -> GenerationSet:
        with self._lock:
            return self._set

    # ----------------------------------------------------------- refresh
    def try_incremental(self, view, row_map: np.ndarray, dtype: str,
                        metric: str, rescore: bool) -> Optional[str]:
        """Absorb one refresh as tombstones and an L0 seal. Returns the
        outcome ("append", "delete", "append+delete", "noop", with
        "+retarget" after a change of encoding), or None when only a full
        build can hold the new reader (`last_rebuild_reason` says why).
        `view` is the block store's `FieldRowsView`: only the new rows
        materialize."""
        retargeted = False
        with self._lock:
            cur = self._set
            if self._closed or not cur.generations:
                self.last_rebuild_reason = "first_build"
                return None
            if metric != self.metric:
                # cosine rows are normalized at encode time: every row
                # changes, so only a rebuild is sound
                self.last_rebuild_reason = "metric_change"
                return None
            if dtype != self.dtype or bool(rescore) != self.rescore:
                # new seals encode at the new target at once; the merge
                # thread re-encodes the resident generations
                # (`dtype_reencode`), so a mapping change never rebuilds on
                # the refresh or serving path
                self.dtype = dtype
                self.rescore = bool(rescore)
                self.stats["dtype_retargets"] += 1
                retargeted = True
            old_rows = cur.row_map
            old_live = cur.live_row_map()
            new = np.asarray(row_map, dtype=np.int64)
            deleted_any = False
            keep = None
            if len(new) >= len(old_live) \
                    and np.array_equal(new[:len(old_live)], old_live):
                # a pure append (the steady refresh)
                added = new[len(old_live):]
            else:
                keep = np.isin(new, old_rows)
                added = new[~keep]
                # rows the engine re-based (its merge) look like a mass
                # delete and add in a new row space: sealing the whole
                # corpus as a delta would double its bytes, so it rebuilds
                if len(added) and len(old_rows) \
                        and added.min() <= old_rows.max():
                    self.last_rebuild_reason = "segment_rewrite"
                    return None
                still = np.isin(old_live, new)
                if not np.array_equal(old_live[still], new[keep]):
                    self.last_rebuild_reason = "segment_rewrite"
                    return None
            if keep is None:
                # only the tail rows materialize
                added_src = view.source_slice(len(old_live))
            else:
                added_src = view.source_select(~keep)
                gens = []
                for g in cur.generations:
                    gone = g.live_mask() & np.isin(g.row_map, new,
                                                   invert=True)
                    if gone.any():
                        deleted_any = True
                        self.stats["tombstone_deletes"] += int(gone.sum())
                        gens.append(g.with_tombstones(g.tombstones | gone))
                    else:
                        gens.append(g)
                if deleted_any:
                    self._epoch += 1
                    self._set = GenerationSet(gens, self._epoch)
            gen_id = self._next_gen_id
            self._next_gen_id += 1
        sealed = None
        if len(added):
            # the seal's host and device work runs outside the lock, since
            # `snapshot()` is on every search. Appending at the end of the
            # set installed then is safe against a merge in between:
            # merges splice runs the tail never belongs to
            sealed = build_generation(gen_id, added_src.gather(), added,
                                      self.metric, self.dtype, self.rescore,
                                      source=added_src, device=self.device)
            with self._lock:
                self.stats["seals"] += 1
                self.stats["sealed_rows"] += len(added)
                self._epoch += 1
                self._set = GenerationSet(self._set.generations + (sealed,),
                                          self._epoch)
        self.notify()
        if sealed is not None and deleted_any:
            outcome = "append+delete"
        elif sealed is not None:
            outcome = "append"
        elif deleted_any:
            outcome = "delete"
        else:
            outcome = "noop"
        if retargeted:
            # a retarget is a rebuild avoided, also on a refresh that is
            # otherwise a noop
            outcome = ("retarget" if outcome == "noop"
                       else outcome + "+retarget")
        return outcome

    # ------------------------------------------------------------ merges
    def _gen_encoding_stale(self, gen: Generation) -> bool:
        """Does this generation still hold an encoding a retarget replaced
        (its matrix dtype, or an int8 residual present against the
        rescore flag)?"""
        if quant_codec.encoding_of(gen.corpus.matrix.dtype) != self.dtype:
            return True
        if self.dtype == "int8":
            return (gen.corpus.residual is not None) != self.rescore
        return False

    def _select(self, gens: Sequence[Generation]) -> Optional[MergeSpec]:
        spec = self.policy.select(gens)
        if spec is not None:
            return spec
        # a tombstoned IVF base dropped its router (dead rows would come
        # back through its partitions): compact it now, on this thread,
        # so the pruned route comes back without waiting for the GC
        # fraction
        if (self.knn_params.get("engine") == "tpu_ivf" and gens
                and gens[0].has_tombstones and gens[0].router is None
                and gens[0].live_rows
                >= int(self.knn_params.get("min_rows", 512))):
            return MergeSpec(0, 1, "tombstone_gc")
        # after a retarget, re-encode the generations one at a time here,
        # at the current target
        for i, g in enumerate(gens):
            if self._gen_encoding_stale(g):
                return MergeSpec(i, i + 1, "dtype_reencode")
        return None

    def merge_pending(self) -> bool:
        with self._lock:
            return self._select(self._set.generations) is not None

    def notify(self) -> None:
        """Start the background merge thread when work is pending and no
        thread is registered (a thread a burst: the loop exits when the
        set is steady, so an idle corpus holds no thread). Registration is
        tested with `is not None`, not `is_alive()`, which would race the
        window between registering a thread and starting it; the loop
        clears it in a `finally`."""
        if not self.background:
            return
        with self._lock:
            if self._closed or self._merge_thread is not None:
                return
            if self._select(self._set.generations) is None:
                return
            t = threading.Thread(target=self._merge_loop, daemon=True,
                                 name="segments-merge")
            self._merge_thread = t
        t.start()

    def _merge_loop(self) -> None:
        budget_ns = max(self.merge_budget_ms, 1.0) * 1e6
        spent = 0.0
        try:
            while self._merge_once():
                spent += self._last_merge_nanos
                if spent > budget_ns:
                    # the budget is spent: yield to serving for as long
                    time.sleep(budget_ns / 1e9)
                    spent = 0.0
        except BaseException as exc:
            # the thread stops with the error (no retry of the same merge
            # here); `drain()` raises it, and the next refresh may try again
            with self._lock:
                self.merge_error = exc
            raise
        finally:
            with self._lock:
                self._merge_thread = None
        # a seal may have landed between the last select and the clear
        self.notify()

    def run_merges(self) -> int:
        """Run every pending merge on the calling thread; returns how many
        installed or aborted."""
        n = 0
        while self._merge_once():
            n += 1
        return n

    def force_merge(self) -> bool:
        """Merge everything into one clean generation (forceMerge(1))."""
        with self._lock:
            spec = TieredMergePolicy.force(self._set.generations)
            victims = (self._set.generations[spec.start:spec.stop]
                       if spec else None)
        if spec is None:
            return False
        return self._execute(spec, victims)

    def drain(self, timeout_s: float = 60.0) -> None:
        """Wait until the background thread is idle and no merge is
        pending. Raises the error of a background merge that failed, and
        TimeoutError when merges are still pending at the deadline."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                t = self._merge_thread
                err = self.merge_error
                pending = (not self._closed and
                           self._select(self._set.generations) is not None)
            if t is not None and t.is_alive():
                t.join(0.05)
                continue
            if err is not None:
                raise RuntimeError("a background merge failed") from err
            if not pending:
                return
            if not self.background:
                self.run_merges()
                continue
            self.notify()
            time.sleep(0.005)
        raise TimeoutError(f"merges still pending after {timeout_s} s")

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop the merge thread and drop every generation (an index
        delete): the device memory goes with the last batch that still
        holds a snapshot."""
        with self._lock:
            self._closed = True
            self._set = GenerationSet((), self._epoch + 1)
            t = self._merge_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout_s)

    def _merge_once(self) -> bool:
        with self._lock:
            spec = (None if self._closed
                    else self._select(self._set.generations))
            victims = (self._set.generations[spec.start:spec.stop]
                       if spec else None)
        if spec is None:
            self._last_merge_nanos = 0
            return False
        return self._execute(spec, victims)

    def _execute(self, spec: MergeSpec,
                 victims: Tuple[Generation, ...]) -> bool:
        t0 = time.perf_counter_ns()
        merged = self._build_merged(spec, victims)
        ok = self._install(victims, merged)
        nanos = time.perf_counter_ns() - t0
        self._last_merge_nanos = nanos
        with self._lock:
            if ok:
                self.merge_error = None
                self.stats["merges"] += 1
                self.stats["merged_rows"] += merged.n_rows
                if spec.reason == "dtype_reencode":
                    self.stats["dtype_reencodes"] += 1
                self.merge_reasons[spec.reason] = \
                    self.merge_reasons.get(spec.reason, 0) + 1
            else:
                self.stats["aborted_merges"] += 1
            self.stats["merge_nanos"] += nanos
        if ok and self.view_cb is not None:
            self.view_cb(self)
        return ok

    def _build_merged(self, spec: MergeSpec,
                      victims: Tuple[Generation, ...]) -> Generation:
        """Seal the victims' live rows into one generation; a merge that
        makes the new base (start 0) also carries the IVF layout over or
        retrains it. The rows are read through the victims' RowSources:
        their f32 concatenation is a transient of this merge, and the new
        generation keeps only the narrowed sources."""
        from elasticsearch_tpu_torch.columnar.store import RowSource
        src = RowSource.concat([g.source.select(g.live_mask())
                                for g in victims])
        rows = np.concatenate([g.row_map[g.live_mask()] for g in victims])
        vecs = src.gather()
        if vecs.size == 0:
            vecs = vecs.reshape(0, self.dims)
        with self._lock:
            gen_id = self._next_gen_id
            self._next_gen_id += 1
        merged = build_generation(gen_id, vecs, rows, self.metric,
                                  self.dtype, self.rescore, source=src,
                                  device=self.device)
        if spec.start == 0:
            merged.router = self._graduate_ivf(victims[0], merged, vecs)
        return merged

    def _graduate_ivf(self, old_base: Generation, merged: Generation,
                      vecs: np.ndarray):
        """The new base's IVF router: the old base's layout with the delta
        placed into a copy, or a retrained one (drift, or a compaction
        after tombstones); always on this merge thread."""
        if self.knn_params.get("engine") != "tpu_ivf" \
                or merged.n_rows < int(self.knn_params.get("min_rows", 512)):
            return None
        old = old_base.router
        if (old is not None and not old_base.has_tombstones
                and old.index.dtype == self.dtype
                and old.index.metric == self.metric
                and not old.index.needs_retrain
                and old_base.n_rows <= merged.n_rows):
            # the old base's rows are a prefix of the merged ones: place the
            # delta into a copy of its layout (the serving router keeps the
            # original while this merge runs)
            idx = old.index.clone()
            idx.add(vecs[old_base.n_rows:],
                    np.arange(old_base.n_rows, merged.n_rows,
                              dtype=np.int32))
            if not idx.needs_retrain:
                return old.with_index(idx)
        with self._lock:
            self.stats["ivf_background_builds"] += 1
        return self.ivf_build(vecs, self.metric, self.dtype)

    def _install(self, victims: Tuple[Generation, ...],
                 merged: Generation) -> bool:
        """Splice `merged` where the victims sit in the current list,
        checked by identity: a refresh that replaced a victim (tombstones)
        meanwhile drops the install instead of bringing its deleted rows
        back."""
        with self._lock:
            if self._closed:
                return False
            gens = list(self._set.generations)
            try:
                i = gens.index(victims[0])
            except ValueError:
                return False
            if i + len(victims) > len(gens) or any(
                    gens[i + j] is not victims[j]
                    for j in range(len(victims))):
                return False
            gens[i:i + len(victims)] = [merged]
            self._set = GenerationSet(gens, self._set.epoch)
            return True

    # ------------------------------------------------------------- stats
    def segment_stats(self) -> dict:
        with self._lock:
            s = self._set
            out = dict(self.stats)
            reasons = dict(self.merge_reasons)
        tiers: dict = {}
        for g in s.generations:
            t = tiers.setdefault(str(g.tier), {"generations": 0, "bytes": 0,
                                               "rows": 0,
                                               "tombstoned_rows": 0})
            t["generations"] += 1
            t["bytes"] += g.nbytes
            t["rows"] += g.n_rows
            t["tombstoned_rows"] += g.dead_rows
        out.update({"generations": len(s.generations),
                    "l0_generations": s.l0_count,
                    "tombstoned_rows": s.dead_rows, "bytes": s.nbytes,
                    "tiers": tiers, "merge_reasons": reasons})
        return out
