"""IVF partition layout over the stored corpus (port of
`elasticsearch_tpu/ann/ivf_index.py`).

Builds the bucketed, padded-to-a-common-capacity partition matrices the
probe scorers (`ops/knn_ivf.py`, `ops/ivf_fused.py`) read, from the same
host vectors `vectors/store.py` feeds `ops/knn.build_corpus`:

  * centroids train on the device (`ann/kmeans.py`), then rows place into
    capacity-capped buckets: first-choice partition when it has room,
    else the nearest partition that does (displacement). Total capacity
    (`nlist * cap >= slack * n`) guarantees placement;
  * incremental `add` appends into the host mirror of the bucket layout
    and re-uploads lazily at the next search; adds that miss their
    first-choice partition count as displaced, and once displaced + spill
    exceed `retrain_threshold` of the corpus (or the corpus outgrows the
    trained layout) `needs_retrain` flips;
  * int8 and int4 storage encode through the codec; sq-norms ride along
    for l2.

The placement (`_routing_matrix`, `_routing_scores`, `IVFIndex._place`)
is a verbatim numpy copy of the reference's, so with the same centroids
the port builds a byte-identical layout. Row ids stored in the layout are
device-corpus rows, so IVF results join the row maps like exhaustive
results do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.ann import kmeans as kmeans_lib
from elasticsearch_tpu_torch.ops import similarity as sim
from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions
from elasticsearch_tpu_torch.ops.quantization import quantize_int8_np
from elasticsearch_tpu_torch.quant import codec as quant_codec

# partition capacity is padded to this many rows
CAP_PAD = 8
# capacity slack over the perfectly-balanced size: bounds both padding
# waste and the displacement rate
DEFAULT_SLACK = 1.5
# corpora below nlist * this never benefit from pruning
MIN_ROWS_PER_LIST = 8
# rows placed per routing matmul (bounds the [chunk, nlist] score matrix)
_PLACE_CHUNK = 131_072


def _routing_matrix(centroids: np.ndarray, metric: str) -> np.ndarray:
    """Centroids as the query-time router sees them: unit-normalized for
    cosine (spherical routing: max-dot == nearest-angle), raw otherwise."""
    if metric == sim.COSINE:
        norms = np.linalg.norm(centroids, axis=-1, keepdims=True)
        return centroids / np.maximum(norms, 1e-30)
    return centroids


def _routing_scores(x: np.ndarray, centroids: np.ndarray,
                    metric: str) -> np.ndarray:
    """[n, nlist] bigger-is-better routing scores, same convention as
    `ops/knn_ivf.route`."""
    dots = x @ centroids.T
    if metric == sim.L2_NORM:
        c_sq = np.einsum("kd,kd->k", centroids, centroids)
        x_sq = np.einsum("nd,nd->n", x, x)
        return 2.0 * dots - x_sq[:, None] - c_sq[None, :]
    return dots


def _normalized(vectors: np.ndarray, metric: str) -> np.ndarray:
    vectors = np.asarray(vectors, dtype=np.float32)
    if metric == sim.COSINE:
        norms = np.linalg.norm(vectors, axis=-1, keepdims=True)
        vectors = vectors / np.maximum(norms, 1e-30)
    return vectors


class IVFIndex:
    """Host mirror + device partitions of one field's layout."""

    def __init__(self, centroids: np.ndarray, cap: int, metric: str,
                 dtype: str, retrain_threshold: float = 0.2):
        nlist, dims = centroids.shape
        self.metric = metric
        self.dtype = dtype
        self.dims = dims
        self.nlist = nlist
        self.cap = cap
        self.retrain_threshold = float(retrain_threshold)
        self.centroids = _routing_matrix(
            np.asarray(centroids, dtype=np.float32), metric)
        # host mirrors of the bucket layout
        self.part_vecs = np.zeros((nlist, cap, dims), dtype=np.float32)
        self.part_rows = np.full((nlist, cap), -1, dtype=np.int32)
        self.counts = np.zeros(nlist, dtype=np.int64)
        self.trained_on = 0   # corpus size the centroids were trained on
        self.displaced = 0    # rows not in their first-choice partition
        self.spilled = 0      # rows that found no capacity at all
        self._device = {}     # device -> lazy IVFPartitions

    # ------------------------------------------------------------- build

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    @property
    def needs_retrain(self) -> bool:
        total = self.total
        if total == 0:
            return False
        if self.spilled > 0:
            return True
        if (self.displaced + self.spilled) / total > self.retrain_threshold:
            return True
        # the layout was sized for trained_on rows; growth past the
        # capacity headroom degrades routing even without displacement
        return self.trained_on > 0 and total > 2 * self.trained_on

    def _place(self, vecs: np.ndarray, rows: np.ndarray,
               count_displaced: bool = True) -> None:
        """Greedy capacity-capped placement: first-choice when it has
        room, else nearest-with-room among the top candidates (the
        reference's numpy, verbatim)."""
        if len(rows) == 0:
            return
        rows = np.asarray(rows, dtype=np.int32)
        scores = _routing_scores(vecs, self.centroids, self.metric)
        first = np.argmin(-scores, axis=1)  # argmax, ties to lowest pid
        order = np.argsort(first, kind="stable")
        bounds = np.searchsorted(first[order], np.arange(self.nlist + 1))
        leftover = []
        for pid in range(self.nlist):
            grp = order[bounds[pid]:bounds[pid + 1]]
            if len(grp) == 0:
                continue
            c = int(self.counts[pid])
            take = grp[: max(0, self.cap - c)]
            if len(take):
                self.part_vecs[pid, c:c + len(take)] = vecs[take]
                self.part_rows[pid, c:c + len(take)] = rows[take]
                self.counts[pid] = c + len(take)
            leftover.extend(grp[len(take):])

        if leftover:
            leftover = np.asarray(leftover)
            n_choices = min(self.nlist, 8)
            sub = scores[leftover]
            choice = np.argpartition(-sub, n_choices - 1,
                                     axis=1)[:, :n_choices] \
                if n_choices < self.nlist else \
                np.tile(np.arange(self.nlist), (len(leftover), 1))
            ordc = np.take_along_axis(sub, choice, axis=1).argsort(axis=1)
            choice = np.take_along_axis(choice, ordc[:, ::-1], axis=1)
            for i, ri in enumerate(leftover):
                placed = False
                for pid in choice[i][1:]:  # [0] is the full first choice
                    c = int(self.counts[pid])
                    if c < self.cap:
                        self.part_vecs[pid, c] = vecs[ri]
                        self.part_rows[pid, c] = rows[ri]
                        self.counts[pid] = c + 1
                        if count_displaced:
                            self.displaced += 1
                        placed = True
                        break
                if not placed:
                    # every candidate bucket is full: fall back to the
                    # emptiest partition anywhere, else record a spill
                    pid = int(np.argmin(self.counts))
                    c = int(self.counts[pid])
                    if c < self.cap:
                        self.part_vecs[pid, c] = vecs[ri]
                        self.part_rows[pid, c] = rows[ri]
                        self.counts[pid] = c + 1
                        if count_displaced:
                            self.displaced += 1
                    else:
                        self.spilled += 1
        self._device = {}

    def _place_chunked(self, vectors: np.ndarray, rows: np.ndarray) -> None:
        """Initial placement into fresh buckets: overflow into a neighbour
        here is layout slack, not drift, so it is not counted."""
        rows = np.asarray(rows, dtype=np.int32)
        for lo in range(0, len(vectors), _PLACE_CHUNK):
            self._place(vectors[lo:lo + _PLACE_CHUNK],
                        rows[lo:lo + _PLACE_CHUNK], count_displaced=False)

    def clone(self) -> "IVFIndex":
        """Deep copy of the layout (trained centroids + bucket mirrors,
        counters included) with the lazy device partitions reset."""
        new = IVFIndex.__new__(IVFIndex)
        new.__dict__.update(self.__dict__)
        new.part_vecs = self.part_vecs.copy()
        new.part_rows = self.part_rows.copy()
        new.counts = self.counts.copy()
        new._device = {}
        return new

    def add(self, vecs: np.ndarray, rows: np.ndarray) -> None:
        """Incremental add (post-build refresh delta): place into the host
        mirror; the device partitions refresh lazily at the next search."""
        self._place(_normalized(vecs, self.metric),
                    np.asarray(rows, dtype=np.int32))

    # ------------------------------------------------------------ device

    def device_partitions(self, device) -> IVFPartitions:
        """The IVFPartitions on `device`, uploading the host mirror on
        first use and after any add(). Padding slots' scale is 0, so the
        scorers mask them."""
        dev = torch.device(device)
        cached = self._device.get(dev)
        if cached is not None:
            return cached

        def up(a):
            # a copy even on the CPU: `add` mutates the host mirror while
            # a search may still hold the previous partitions
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, copy=True)

        valid = self.part_rows >= 0
        flat = self.part_vecs.reshape(-1, self.dims)
        part_sq = np.einsum("kcd,kcd->kc", self.part_vecs, self.part_vecs)
        if self.dtype == "int8":
            q8, scales = quantize_int8_np(flat)
            parts = up(q8.reshape(self.nlist, self.cap, self.dims))
            part_scales = np.where(valid, scales.reshape(self.nlist, self.cap),
                                   0.0)
        elif self.dtype in quant_codec.PACKED_ENCODINGS:
            codec = quant_codec.get(self.dtype)
            enc = codec.encode_np(flat)
            w = codec.packed_width(self.dims)
            parts = up(enc.data.reshape(self.nlist, self.cap, w))
            part_scales = np.where(
                valid, enc.scales.reshape(self.nlist, self.cap), 0.0)
        else:
            parts = up(self.part_vecs)
            if self.dtype == "bf16":
                parts = parts.to(torch.bfloat16)
            part_scales = valid
        c_sq = np.einsum("kd,kd->k", self.centroids, self.centroids)
        ivf = IVFPartitions(
            centroids=up(self.centroids),
            centroid_sq=up(c_sq.astype(np.float32)),
            parts=parts,
            part_scales=up(part_scales.astype(np.float32)),
            part_sq=up(part_sq.astype(np.float32)),
            part_rows=up(self.part_rows))
        self._device = {dev: ivf}
        return ivf


def export_layout(index: IVFIndex) -> dict:
    """The trained layout as a corpus-independent dict: centroids + shape
    + counters, NOT the bucket mirrors (those re-place deterministically).
    The same keys as the reference's, so a layout exported by either
    package restores into the other."""
    return {
        "nlist": int(index.nlist), "cap": int(index.cap),
        "dims": int(index.dims), "metric": index.metric,
        "dtype": index.dtype,
        "retrain_threshold": float(index.retrain_threshold),
        "trained_on": int(index.trained_on),
        # already routing-normalized at train time
        "centroids": np.asarray(index.centroids, dtype=np.float32).copy(),
    }


def layout_compatible(layout: dict, n: int, dims: int, metric: str,
                      dtype: str) -> bool:
    """Can a restored layout serve `n` rows of this field without an
    immediate retrain? (`needs_retrain`'s growth gate plus the hard
    capacity bound)"""
    try:
        trained_on = int(layout.get("trained_on", 0))
        return (int(layout["dims"]) == int(dims)
                and layout["metric"] == metric
                and layout["dtype"] == dtype
                and n <= int(layout["nlist"]) * int(layout["cap"])
                and 0 < trained_on and n <= 2 * trained_on)
    except (KeyError, TypeError, ValueError):
        return False


def ivf_from_layout(layout: dict, vectors: np.ndarray,
                    rows: Optional[np.ndarray] = None) -> IVFIndex:
    """Rebuild an IVFIndex from an exported layout WITHOUT re-training:
    the restored centroids route, rows re-place exactly like the initial
    build. With the same vectors in the same order this reproduces the
    layout the source trained, byte for byte."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n, dims = vectors.shape
    if not layout_compatible(layout, n, dims, layout["metric"],
                             layout["dtype"]):
        raise ValueError("IVF layout incompatible with corpus")
    if rows is None:
        rows = np.arange(n, dtype=np.int32)
    index = IVFIndex(np.asarray(layout["centroids"], dtype=np.float32),
                     int(layout["cap"]), layout["metric"], layout["dtype"],
                     retrain_threshold=float(layout["retrain_threshold"]))
    # the exported centroids are already routing-normalized: keep them as
    # they are, byte for byte
    index.centroids = np.asarray(layout["centroids"], dtype=np.float32)
    index._place_chunked(_normalized(vectors, index.metric), rows)
    index.trained_on = int(layout.get("trained_on") or n)
    return index


def pick_nlist(n: int, dims: int) -> int:
    """Default partition count: ~sqrt(n) rounded to a power of two."""
    if n <= 0:
        return 1
    target = max(1, int(np.sqrt(n)))
    return 1 << max(0, int(round(np.log2(target))))


def build_ivf_index(vectors: np.ndarray, rows: Optional[np.ndarray] = None,
                    *, metric: str = sim.COSINE, nlist: Optional[int] = None,
                    dtype: str = "bf16", seed: int = 0,
                    slack: float = DEFAULT_SLACK,
                    retrain_threshold: float = 0.2,
                    train_iters: int = 8, device="cuda") -> IVFIndex:
    """Train (k-means on `device`) + build the partition layout for one
    corpus snapshot. vectors: [n, d] raw host vectors (cosine
    normalization happens here); rows: [n] device-corpus row ids
    (defaults to arange — the store builds IVF over the same extraction
    that built the flat corpus)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n, dims = vectors.shape
    if rows is None:
        rows = np.arange(n, dtype=np.int32)
    if nlist is None:
        nlist = pick_nlist(n, dims)
    nlist = max(1, min(int(nlist), max(1, n // MIN_ROWS_PER_LIST)))
    vectors = _normalized(vectors, metric)
    centroids = kmeans_lib.train_kmeans(vectors, nlist, seed=seed,
                                        iters=train_iters, device=device)
    cap = int(np.ceil(n / nlist * slack))
    cap = max(CAP_PAD, ((cap + CAP_PAD - 1) // CAP_PAD) * CAP_PAD)
    index = IVFIndex(centroids, cap, metric, dtype,
                     retrain_threshold=retrain_threshold)
    index._place_chunked(vectors, rows)
    index.trained_on = n
    return index
