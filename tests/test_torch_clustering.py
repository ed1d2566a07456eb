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


# ------------------------------------ wide fits on the bank's own BBVs
BBV_APPS = ("502.gcc_r", "505.mcf_r", "523.xalancbmk_r")
BBV_ROWS = 2000
WIDE_ITERS = 25


@pytest.fixture(scope="module")
def bank_bbvs():
    """``BBV_ROWS`` regions (in order, seeded choice) of three apps' real
    BBVs, ``(3, BBV_ROWS, 256)`` float32 block counts, and their random
    projection to 64 features (the port's, given to both packages)."""
    from repro_torch.simcpu import get_bbvs, get_population
    rng = np.random.default_rng(29)
    rows = []
    for app in BBV_APPS:
        bbv = get_bbvs(get_population(app))
        rows.append(bbv[np.sort(rng.choice(len(bbv), BBV_ROWS,
                                           replace=False))])
    raw = np.stack(rows).astype(np.float32)
    z = random_project(torch.from_numpy(raw), 64,
                       key=prng.PRNGKey(0)).numpy()
    return {256: raw, 64: z}


@pytest.fixture
def one_torch_thread():
    """One torch thread: beside the suite's other workers a thread pool
    per process waits on descheduled threads (``tests/lm_family_checks.py``
    says more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_fit(x, got, want, what: str) -> int:
    """Labels equal but at reference near-ties (none away from them),
    centroids and iterations bit for bit: the near-tie flips found."""
    bad, at_ties = _exceptions(x, want.centroids, got.labels.numpy(),
                               want.labels)
    assert bad == 0, f"{what}: {bad} labels differ away from near-ties"
    np.testing.assert_array_equal(got.centroids.numpy(), want.centroids,
                                  err_msg=what)
    np.testing.assert_array_equal(np.asarray(got.iterations),
                                  np.asarray(want.iterations), err_msg=what)
    return at_ties


@pytest.mark.parametrize("d,k", [(64, 64), (256, 20)])
def test_wide_fits_match_reference_on_bank_bbvs(bank_bbvs,
                                                one_torch_thread, d, k):
    """``kmeans``, ``kmeans_batch`` and ``kmeans_bank`` at the widths the
    card's wide path serves (d = 64 at k = 64: one chain; the raw d = 256
    BBVs at k = 20: four chains) against the reference's ``backend="jnp"``
    fits on the same points, the port in its own float mode (its fits
    read subnormals as zeros, as XLA does: ``flush_subnormals``; the raw
    BBVs hold some, 0.17 % of the values here): labels under the near-tie
    rule, centroids and iterations bitwise, inertia to rtol 1e-5 (a sum
    over the fit's points in another order)."""
    x = bank_bbvs[d]
    assert ordered.reference_dot_order(3, BBV_ROWS, k, d) == \
        ("chain" if d == 64 else "four")
    flips = 0
    want = jax_kmeans(x[0], k, seed=0, max_iters=WIDE_ITERS)
    got = kmeans(torch.from_numpy(x[0]), k, seed=0, max_iters=WIDE_ITERS)
    flips += _same_fit(x[0], got, want, "kmeans")
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-5)
    for g, w in zip(kmeans_batch(torch.from_numpy(x[1]), k, seeds=[0, 5],
                                 max_iters=WIDE_ITERS),
                    jax_batch(x[1], k, seeds=[0, 5], max_iters=WIDE_ITERS)):
        flips += _same_fit(x[1], g, w, "kmeans_batch")
    wts = np.ones(x.shape[:2], np.float32)
    wts[2, -300:] = 0.0                      # a ragged lane's padding
    want = jax_bank(x, k, weights=wts, seed=0, max_iters=WIDE_ITERS)
    got = kmeans_bank(torch.from_numpy(x), k, weights=torch.from_numpy(wts),
                      seed=0, max_iters=WIDE_ITERS)
    flips += _same_fit(x, got, want, "kmeans_bank")
    np.testing.assert_allclose(got.inertia.numpy(), want.inertia, rtol=1e-5)
    assert flips == 0, f"{flips} labels flipped at near-ties"


def test_raw_bbv_fit_parts_from_reference_only_at_subnormals(
        bank_bbvs, one_torch_thread, monkeypatch):
    """ROADMAP C.9, what the fits' flush repairs: with subnormals kept
    (``flush_subnormals`` taken out) the port's bank fit on the raw
    d = 256 BBVs gives the reference's labels, and parts from its
    centroids, but only at elements whose cluster holds a subnormal value
    in that column, which XLA reads as zero."""
    monkeypatch.setattr(km_module, "flush_subnormals", lambda t: t)
    x = bank_bbvs[256]
    want = jax_bank(x, 20, seed=0, max_iters=WIDE_ITERS)
    got = kmeans_bank(torch.from_numpy(x), 20, seed=0, max_iters=WIDE_ITERS)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    tiny = np.finfo(np.float32).tiny
    parted = np.argwhere(got.centroids.numpy() != want.centroids)
    assert len(parted) > 0
    for a, j, col in parted:
        members = x[a][want.labels[a] == j][:, col]
        assert ((members != 0) & (np.abs(members) < tiny)).any(), (a, j, col)


def test_flush_subnormals_keeps_signs_and_normals():
    """Subnormals become zeros of their sign; zeros, the smallest
    normals, infinities and NaN pass unchanged."""
    tiny = np.finfo(np.float32).tiny
    t = torch.tensor([tiny / 2, -tiny / 2, tiny, -tiny, 0.0, -0.0, 1.0,
                      float("inf"), float("nan")])
    got = km_module.flush_subnormals(t)
    want = torch.tensor([0.0, -0.0, tiny, -tiny, 0.0, -0.0, 1.0,
                         float("inf"), float("nan")])
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.equal(got[:-1], want[:-1]) and bool(got[-1].isnan())


def test_wide_assignment_matches_reference_pallas_kernel(
        bank_bbvs, one_torch_thread):
    """The port's assignment at d = 256 against the reference's Pallas
    kernel in interpret mode (its own padding to 128-multiples of d and
    k, its own product order): labels under the near-tie rule, distances
    to rtol 1e-5 and atol 1e-6 of the largest distance."""
    from repro.kernels.kmeans_assign.ops import kmeans_assign as jax_assign
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    x = bank_bbvs[256][:, :512]
    c = x[:, 7:27].copy()
    lab, d2 = kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    want_lab, want_d2 = (np.asarray(a) for a in jax_assign(x, c))
    bad, _ = _exceptions(x, c, lab.numpy(), want_lab)
    assert bad == 0
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-5,
                               atol=1e-6 * float(want_d2.max()))
