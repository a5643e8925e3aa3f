"""Mini-batch k-means on the device for IVF partition training (port of
`elasticsearch_tpu/ann/kmeans.py`).

Trains the `nlist` routing centroids of the `tpu_ivf` engine from the
stored corpus, in torch on the given device:

  * k-means++ seeding (Arthur & Vassilvitskii, 2007) over a bounded
    training sample — each next seed is drawn proportional to its squared
    distance from the chosen set;
  * mini-batch Lloyd updates (Sculley, 2010): per-batch assignment is one
    [B, nlist] matmul + argmax, the centroid update a one-hot matmul with
    per-center decaying learning rates;
  * a soft balance penalty: assignment cost adds
    `alpha * mean_d2 * (count_c / expected - 1)` so persistently
    over-full centers repel new members (the hard cap lives in the index
    build, `ivf_index.py`).

Everything is deterministic given `seed`. The random draws come from a
`torch.Generator` seeded from it, so the seeds and batch orders differ
from the reference's `jax.random` ones; the training sample is drawn with
numpy exactly as the reference draws it. These are plain tensor programs
(the reference's XLA programs), not hand-written kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch import resolve_device


def kmeans_pp_init(gen: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding: [n, d] sample → [k, d] initial centroids, each a
    row of `x`. Draws stay on the device (no host sync per seed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n = x.shape[0]
    x_sq = torch.sum(x * x, dim=-1)

    def d2_to(c):
        # squared distance via the dot expansion
        return torch.clamp(x_sq - 2.0 * (x @ c) + torch.sum(c * c), min=0.0)

    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    c = x[first][0]
    centroids[0] = c
    min_d2 = d2_to(c)
    for i in range(1, k):
        # sample ∝ D²(x), as the reference's log-space categorical does
        nxt = torch.multinomial(torch.clamp(min_d2, min=1e-30), 1,
                                generator=gen)
        c = x[nxt][0]
        centroids[i] = c
        min_d2 = torch.minimum(min_d2, d2_to(c))
    return centroids


def assign_blocks(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids [n] for rows [n, d] (plain L2 assignment — for
    unit-normalized cosine data this equals max-dot routing). Ties go to
    the lower id, as `jnp.argmax` breaks them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c_sq = torch.sum(centroids * centroids, dim=-1)
    # argmin ||x-c||² = argmax (x·c - ||c||²/2)
    return torch.argmax(x @ centroids.T - 0.5 * c_sq[None, :],
                        dim=-1).to(torch.int32)


def minibatch_epoch(carry, batches: torch.Tensor, nlist: int,
                    balance_alpha: float):
    """One pass over the stacked mini-batches [S, B, d]; carry is
    (centroids [nlist, d], counts [nlist]) f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cents, counts = carry
    for batch in batches:
        c_sq = torch.sum(cents * cents, dim=-1)
        score = batch @ cents.T - 0.5 * c_sq[None, :]
        if balance_alpha > 0.0:
            expected = torch.clamp(torch.sum(counts) / nlist, min=1.0)
            mean_d2 = torch.mean(torch.clamp(
                torch.sum(batch * batch, dim=-1)[:, None] - 2.0 * score,
                min=0.0))
            score = score - (balance_alpha * mean_d2
                             * (counts / expected - 1.0))[None, :]
        assign = torch.argmax(score, dim=-1)
        one_hot = torch.nn.functional.one_hot(assign, nlist).to(torch.float32)
        batch_counts = torch.sum(one_hot, dim=0)
        batch_sums = one_hot.T @ batch
        new_counts = counts + batch_counts
        # per-center learning rate 1/total_count (Sculley eq. 1)
        lr = batch_counts / torch.clamp(new_counts, min=1.0)
        target = batch_sums / torch.clamp(batch_counts[:, None], min=1.0)
        cents = cents + lr[:, None] * (target - cents)
        counts = new_counts
    return cents, counts


def train_kmeans(vectors: np.ndarray, nlist: int, *, iters: int = 8,
                 batch_size: int = 4096, sample: int = 262_144,
                 seed: int = 0, balance_alpha: float = 0.25,
                 device="cuda") -> np.ndarray:
    """Train `nlist` centroids from host vectors; returns [nlist, d] f32.

    The training sample is bounded (`sample` rows) so training cost is
    independent of corpus size; `iters` epochs of mini-batch Lloyd over a
    reshuffled sample each epoch."""
    dev = resolve_device(device)
    vectors = np.asarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if nlist < 1:
        raise ValueError(f"nlist must be >= 1, got {nlist}")
    if n < nlist:
        raise ValueError(f"cannot train {nlist} centroids from {n} rows")

    rng = np.random.default_rng(seed)
    n_sample = min(n, max(sample, nlist * 4))
    idx = rng.choice(n, size=n_sample, replace=False) if n_sample < n \
        else np.arange(n)
    x = torch.from_numpy(np.ascontiguousarray(vectors[idx])).to(dev)

    gen = torch.Generator(device=dev).manual_seed(seed)
    seed_rows = min(n_sample, max(nlist * 32, 4096))
    centroids = kmeans_pp_init(gen, x[:seed_rows], nlist)

    batch_size = min(batch_size, n_sample)
    steps = n_sample // batch_size
    counts = torch.zeros((nlist,), dtype=torch.float32, device=dev)
    for _ in range(max(iters, 1)):
        perm = torch.randperm(n_sample, generator=gen,
                              device=dev)[: steps * batch_size]
        batches = x[perm].reshape(steps, batch_size, d)
        centroids, counts = minibatch_epoch(
            (centroids, counts), batches, nlist, balance_alpha)
    return centroids.cpu().numpy().astype(np.float32)
