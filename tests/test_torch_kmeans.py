"""The port's mini-batch k-means (`elasticsearch_tpu_torch/ann/kmeans.py`)
against `elasticsearch_tpu.ann.kmeans` on the CPU.

The deterministic steps are held to the reference on the same numpy
inputs: nearest-centroid ids equal wherever the best centroid leads the
runner-up by more than 1e-5, and one mini-batch epoch on the same carry
and batches within 1e-5 (f32 sums in another order). The random steps
cannot be: `jax.random` draws differ from a `torch.Generator`'s, so
k-means++ seeding is checked for its properties (each seed is a sample
row, seeds are distinct, the same seed gives the same seeds) and
`train_kmeans` for its objective (mean squared distance to the nearest
centroid) within 5% of the reference's on clustered data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ann import kmeans as ref_kmeans
from elasticsearch_tpu_torch.ann import kmeans

D = 24


def _clustered(n, d, n_centers, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_centers, size=n)
    return (centers[assign]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _objective(x, centroids):
    d2 = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    return float(d2.min(axis=1).mean())


def test_assign_blocks_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, D)).astype(np.float32)
    cents = rng.standard_normal((16, D)).astype(np.float32)
    want = np.asarray(ref_kmeans._assign_blocks_impl(jnp.asarray(x),
                                                     jnp.asarray(cents)))
    got = kmeans.assign_blocks(torch.from_numpy(x),
                               torch.from_numpy(cents)).numpy()
    assert got.dtype == np.int32
    score = x.astype(np.float64) @ cents.T.astype(np.float64) \
        - 0.5 * (cents.astype(np.float64) ** 2).sum(-1)[None, :]
    top2 = np.sort(score, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("alpha", [0.0, 0.25])
@pytest.mark.parametrize("steps", [1, 3])
def test_minibatch_epoch_matches_reference(alpha, steps):
    rng = np.random.default_rng(11 + steps)
    nlist = 12
    cents = rng.standard_normal((nlist, D)).astype(np.float32)
    counts = rng.integers(0, 40, nlist).astype(np.float32)
    batches = rng.standard_normal((steps, 64, D)).astype(np.float32)
    w_c, w_n = ref_kmeans._minibatch_epoch_impl(
        (jnp.asarray(cents), jnp.asarray(counts)), jnp.asarray(batches),
        nlist, alpha)
    g_c, g_n = kmeans.minibatch_epoch(
        (torch.from_numpy(cents), torch.from_numpy(counts)),
        torch.from_numpy(batches), nlist, alpha)
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(w_n))
    np.testing.assert_allclose(g_c.numpy(), np.asarray(w_c), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_pp_init_seeds_are_distinct_sample_rows_and_deterministic(seed):
    x = torch.from_numpy(_clustered(400, D, 8, seed=1))
    k = 16
    a = kmeans.kmeans_pp_init(torch.Generator().manual_seed(seed), x, k)
    b = kmeans.kmeans_pp_init(torch.Generator().manual_seed(seed), x, k)
    assert torch.equal(a, b)
    # every seed is one of the sample's rows, and no row is chosen twice
    match = (a[:, None, :] == x[None, :, :]).all(-1)
    assert match.any(1).all()
    rows = match.float().argmax(1)
    assert len(set(rows.tolist())) == k
    other = kmeans.kmeans_pp_init(torch.Generator().manual_seed(seed + 1),
                                  x, k)
    assert not torch.equal(a, other)


@pytest.mark.parametrize("n_centers,nlist", [(8, 16), (16, 32)])
def test_train_kmeans_objective_close_to_reference(n_centers, nlist):
    """More partitions than natural clusters, as IVF uses k-means: with
    nlist equal to the cluster count the objective depends on which local
    minimum the seeds fall into, for both packages alike."""
    x = _clustered(3000, D, n_centers, seed=7)
    want = ref_kmeans.train_kmeans(x, nlist, seed=0, iters=4, batch_size=512)
    got = kmeans.train_kmeans(x, nlist, seed=0, iters=4, batch_size=512,
                              device="cpu")
    assert got.shape == want.shape == (nlist, D) and got.dtype == np.float32
    assert np.isfinite(got).all()
    o_got, o_want = _objective(x, got), _objective(x, want)
    assert o_got <= 1.05 * o_want, (o_got, o_want)
    again = kmeans.train_kmeans(x, nlist, seed=0, iters=4, batch_size=512,
                                device="cpu")
    np.testing.assert_array_equal(got, again)


def test_train_kmeans_rejects_what_the_reference_rejects():
    x = np.zeros((5, D), np.float32)
    for nlist in (0, 6):
        with pytest.raises(ValueError):
            ref_kmeans.train_kmeans(x, nlist)
        with pytest.raises(ValueError):
            kmeans.train_kmeans(x, nlist, device="cpu")
