"""The port's clustering against the reference's, on the CPU.

Inputs are made by numpy from a seed and given to both. The port's
k-means++ draws are bit-exact threefry and its float32 sums follow the
reference's order, so fits agree exactly in practice; the stated rule is
the one the port is held to everywhere: labels equal except units whose
two best reference distances lie within 1e-5 relative (a float32
near-tie, where either side of the tie is right). Each test records how
many such exceptions it found (0 at the time of writing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import kmeans as jax_kmeans
from repro.core.clustering import kmeans_bank as jax_bank
from repro.core.clustering import kmeans_batch as jax_batch
from repro.core.clustering import random_project as jax_project
from repro.core.clustering import Standardizer as JaxStandardizer
import importlib

from repro_torch.core import ordered
from repro_torch.core.clustering import (Standardizer, kmeans, kmeans_bank,
                                         kmeans_batch, random_project)
from repro_torch.kernels.segment_stats.ops import segment_stats
from repro_torch import prng

km_module = importlib.import_module("repro_torch.core.clustering.kmeans")

TIE_RTOL = 1e-5


def _clustered(seed, shape, n_centers=30):
    rng = np.random.default_rng(seed)
    *lead, n, d = shape
    centers = rng.normal(size=(n_centers, d)) * 3
    lab = rng.integers(0, n_centers, (*lead, n))
    return (centers[lab] + rng.normal(size=(*lead, n, d))).astype(np.float32)


def _exceptions(x, want_c, got_labels, want_labels):
    """Label differences away from reference near-ties (must be 0) and
    the number of differences at near-ties (reported)."""
    d2 = ((x[..., :, None, :].astype(np.float64)
           - want_c[..., None, :, :]) ** 2).sum(-1)
    two = np.sort(d2, axis=-1)[..., :2]
    tie = (two[..., 1] - two[..., 0]) <= TIE_RTOL * np.abs(two[..., 1])
    differ = got_labels != want_labels
    return int((differ & ~tie).sum()), int((differ & tie).sum())


@pytest.mark.parametrize("shape", [(2, 3001, 15), (3, 1201, 38)])
def test_kmeans_bank_matches_reference(shape):
    x = _clustered(shape[-1], shape)
    w = np.ones(shape[:2], np.float32)
    w[1, -257:] = 0.0                         # a padded, ragged lane
    x[1, -257:] = 0.0
    want = jax_bank(x, 20, weights=w, seed=0)
    got = kmeans_bank(torch.from_numpy(x), 20, weights=torch.from_numpy(w),
                      seed=0)
    bad, at_ties = _exceptions(x, want.centroids, got.labels.numpy(),
                               want.labels)
    assert bad == 0
    assert at_ties == 0, f"{at_ties} labels flipped at near-ties"
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    np.testing.assert_allclose(got.centroids.numpy(), want.centroids,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.inertia.numpy(), want.inertia, rtol=1e-5)
    assert got.backend == "plain"


def test_kmeans_batch_and_restarts_match_reference():
    x = _clustered(5, (1500, 7))
    want = jax_batch(x, 12, seeds=[0, 3, 9])
    got = kmeans_batch(torch.from_numpy(x), 12, seeds=[0, 3, 9])
    for g, w in zip(got, want):
        bad, at_ties = _exceptions(x, w.centroids, g.labels.numpy(),
                                   w.labels)
        assert bad == 0 and at_ties == 0
        assert g.iterations == w.iterations
    best_w = jax_kmeans(x, 12, seed=4, restarts=3)
    best_g = kmeans(torch.from_numpy(x), 12, seed=4, restarts=3)
    np.testing.assert_array_equal(best_g.labels.numpy(), best_w.labels)
    np.testing.assert_allclose(best_g.inertia, best_w.inertia, rtol=1e-5)


def test_kmeans_rejects_bad_k():
    with pytest.raises(ValueError):
        kmeans_bank(torch.zeros(2, 5, 3), 6)
    with pytest.raises(ValueError):
        kmeans_batch(torch.zeros(5, 3), 0, seeds=[0])


def test_random_project_matches_reference_program():
    """The reference engine projects inside one compiled program, where
    XLA folds the normal draw's constants; the port reproduces that
    program's matrix and product order bitwise."""
    rng = np.random.default_rng(2)
    bbv = rng.gamma(0.3, size=(2, 700, 256)).astype(np.float32)
    bbv[1, -50:] = 0.0                        # padded rows project to 0
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax.jit(jax.vmap(
        lambda b: jax_project(b, 15, key=key)))(bbv))
    got = random_project(torch.from_numpy(bbv), 15, key=prng.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_standardizer_matches_reference():
    """The reference transforms in jnp, i.e. float32 without x64; the
    port in float64, so they agree to float32 rounding."""
    x = _clustered(8, (400, 6)).astype(np.float64)
    x[:, 2] = 1.5                                       # constant column
    st_w, z_w = JaxStandardizer.fit_transform(x)
    st_g, z_g = Standardizer.fit_transform(torch.from_numpy(x))
    np.testing.assert_allclose(z_g.numpy(), np.asarray(z_w), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st_g.scale.numpy(), st_w.scale)


@pytest.mark.parametrize("n", [5, 32, 33, 1000, 6861, 120000])
def test_ordered_sums_match_xla(n):
    rng = np.random.default_rng(n)
    v = rng.random((3, n)).astype(np.float32)
    np.testing.assert_array_equal(
        ordered.tree_sum(torch.from_numpy(v)).numpy(),
        np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(v)))
    np.testing.assert_array_equal(
        ordered.blocked_cumsum(torch.from_numpy(v)).numpy(),
        np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(v)))


@pytest.mark.parametrize("d", [3, 15, 16, 21, 22, 38, 39])
def test_ordered_products_match_xla(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 300, d)).astype(np.float32)
    c = rng.normal(size=(2, 20, d)).astype(np.float32)
    np.testing.assert_array_equal(
        ordered.dot_nt(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(jax.jit(lambda a, b: jnp.einsum(
            "bnd,bkd->bnk", a, b))(x, c)))
    np.testing.assert_array_equal(
        ordered.sum_sq(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(lambda a: jnp.sum(a * a, axis=2))(x)))


def _update_unmasked(x, labels, k, old, w, backend):
    """The centroid update with weight-0 rows left in their clusters (the
    port's update before it dropped them)."""
    vals = torch.cat([x * w[..., None], w[..., None]], dim=-1)
    sums, _, _ = segment_stats(vals, labels, k, backend=backend)
    counts = sums[..., -1]
    means = sums[..., :-1] / torch.clamp_min(counts, 1.0)[..., None]
    return torch.where((counts > 0)[..., None], means, old)


def test_update_centroids_drops_weight_zero_rows_exactly():
    """Dropping weight-0 rows (label -1) changes no bit of the update:
    they add w x = +-0 and w = 0 to sums that start at +0. Negative values
    of weight 0 give -0 terms; one cluster holds only weight-0 rows."""
    rng = np.random.default_rng(11)
    b, n, d, k = 3, 2000, 15, 20
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    w = torch.from_numpy((rng.random((b, n)) < 0.6).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, k, (b, n)).astype(np.int32))
    labels[0, :300] = 4                      # cluster 4 of lane 0: all
    w[0, :300] = 0.0                         # weight 0, mostly negative
    labels[0, 300:][labels[0, 300:] == 4] = 5
    x[0, :300] = -x[0, :300].abs()
    old = torch.from_numpy(rng.normal(size=(b, k, d)).astype(np.float32))
    terms = x * w[..., None]
    assert bool((torch.signbit(terms) & (terms == 0)).any())   # -0 terms
    got = km_module._update_centroids(x, labels, k, old, w, "plain")
    want = _update_unmasked(x, labels, k, old, w, "plain")
    assert torch.equal(got, want)
    assert torch.equal(got[0, 4], old[0, 4])


@pytest.mark.parametrize("shape", [(2, 3001, 15), (3, 1201, 38)])
def test_kmeans_bank_fit_unchanged_by_dropping_weight_zero_rows(
        monkeypatch, shape):
    """A whole padded fit: centroids, labels, inertia and iterations are
    bitwise those of the update that keeps weight-0 rows."""
    x = _clustered(shape[-1] + 1, shape)
    w = np.ones(shape[:2], np.float32)
    w[1, -401:] = 0.0                         # a padded, ragged lane
    x[1, -401:] = 0.0
    w[0, ::7] = 0.0                           # weight-0 rows with values
    got = kmeans_bank(torch.from_numpy(x), 20, weights=torch.from_numpy(w),
                      seed=0)
    monkeypatch.setattr(km_module, "_update_centroids", _update_unmasked)
    want = kmeans_bank(torch.from_numpy(x), 20, weights=torch.from_numpy(w),
                       seed=0)
    for field in ("centroids", "labels", "inertia", "iterations"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
