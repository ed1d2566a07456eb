"""The port's kernel wrappers against the reference's kernels, on the CPU.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it against the reference's jnp oracles (``kmeans_assign_ref``,
``segment_stats_ref``) and against the reference's Pallas kernels run in
interpret mode (``backend="pallas"``, as ``tests/test_kernels.py`` runs
them). The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there.

Tolerances: labels must be equal except where the reference's best and
second-best squared distances lie within 1e-5 relative (a float32
near-tie); distances agree to rtol 1e-5; segment sums and sums of squares
to 1e-5 of the sum of the terms' magnitudes in each segment (the bound on
float32 rounding in any summation order, which a sum that cancels to near
zero needs), counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kmeans_assign.ops import kmeans_assign as jax_assign
from repro.kernels.kmeans_assign.ref import kmeans_assign_ref as jax_assign_ref
from repro.kernels.segment_stats.ops import segment_stats as jax_segment
from repro.kernels.segment_stats.ref import segment_stats_ref as jax_seg_ref
from repro_torch.kernels import backend
from repro_torch.kernels.kmeans_assign import ops as assign_ops
from repro_torch.kernels.kmeans_assign.ref import (kmeans_assign_ref,
                                                   pairwise_d2)
from repro_torch.kernels.segment_stats import ops as segment_ops

TIE_RTOL = 1e-5


def _near_ties(x, c):
    """(..., n) mask of points whose two best float64 distances lie within
    TIE_RTOL of each other."""
    d2 = ((x[..., :, None, :].astype(np.float64)
           - c[..., None, :, :]) ** 2).sum(-1)
    two = np.sort(d2, axis=-1)[..., :2]
    return (two[..., 1] - two[..., 0]) <= TIE_RTOL * np.abs(two[..., 1])


def _check_labels(got, want, ties):
    differ = got != want
    assert not (differ & ~ties).any(), int((differ & ~ties).sum())


@pytest.mark.parametrize("shape,k", [
    ((100, 15), 20), ((1000, 38), 20), ((513, 7), 3), ((3, 257, 15), 20),
    ((2, 3, 129, 5), 4), ((4097, 16), 64), ((64, 1), 2),
])
def test_assign_plain_matches_reference(shape, k):
    rng = np.random.default_rng(sum(shape) + k)
    x = rng.normal(size=shape).astype(np.float32)
    c = rng.normal(size=shape[:-2] + (k, shape[-1])).astype(np.float32)
    lab, d2 = assign_ops.kmeans_assign(torch.from_numpy(x),
                                       torch.from_numpy(c))
    assert lab.dtype == torch.int32 and lab.shape == shape[:-1]
    ties = _near_ties(x, c)
    for want_lab, want_d2 in (jax_assign_ref(jnp.asarray(x), jnp.asarray(c)),
                              jax_assign(x, c)):
        _check_labels(lab.numpy(), np.asarray(want_lab), ties)
        np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2),
                                   rtol=1e-5, atol=1e-6)


def test_assign_np_matches_reference():
    """``kmeans_assign_np``: numpy in and out, the reference's labels and
    distances (here on the CPU, which takes the plain version)."""
    from repro.kernels.kmeans_assign.ops import kmeans_assign_np as jax_np
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 300, 15)).astype(np.float32)
    c = rng.normal(size=(2, 20, 15)).astype(np.float32)
    lab, d2 = assign_ops.kmeans_assign_np(x, c, device="cpu")
    assert isinstance(lab, np.ndarray) and lab.dtype == np.int32
    assert d2.dtype == np.float32 and lab.shape == d2.shape == (2, 300)
    want_lab, want_d2 = jax_np(x, c)
    _check_labels(lab, np.asarray(want_lab), _near_ties(x, c))
    np.testing.assert_allclose(d2, want_d2, rtol=1e-5, atol=1e-6)


def test_assign_ties_go_to_lowest_index():
    x = torch.zeros((1, 4, 3))
    c = torch.zeros((1, 5, 3))
    lab, d2 = assign_ops.kmeans_assign(x, c)
    assert (lab == 0).all() and (d2 == 0).all()


def test_assign_shape_errors():
    with pytest.raises(ValueError):
        assign_ops.kmeans_assign(torch.zeros(4, 3), torch.zeros(2, 2, 3))
    with pytest.raises(ValueError):
        assign_ops.kmeans_assign(torch.zeros(2, 4, 3), torch.zeros(3, 2, 3))
    with pytest.raises(ValueError):
        assign_ops.kmeans_assign(torch.zeros(4, 3), torch.zeros(2, 4))


def _split_k_argmin(d2: torch.Tensor, split: int):
    """The CUDA kernel's split-k argmin, emulated: ``split`` threads share
    a point, thread s scans centroids [s k / split, (s + 1) k / split) in
    order with a strict <, starting from (inf, its first index); a
    butterfly of xor shuffles then keeps the lower (d2, index) pair."""
    n, k = d2.shape
    best = torch.full((n, split), float("inf"))
    arg = torch.zeros((n, split), dtype=torch.int64)
    for s in range(split):
        lo, hi = s * k // split, (s + 1) * k // split
        arg[:, s] = lo
        for kk in range(lo, hi):
            better = d2[:, kk] < best[:, s]
            best[:, s] = torch.where(better, d2[:, kk], best[:, s])
            arg[:, s] = torch.where(better, kk, arg[:, s])
    lanes = torch.arange(split)
    m = split // 2
    while m:
        ob, oa = best[:, lanes ^ m], arg[:, lanes ^ m]
        take = (ob < best) | ((ob == best) & (oa < arg))
        best, arg = torch.where(take, ob, best), torch.where(take, oa, arg)
        m //= 2
    assert bool((arg == arg[:, :1]).all())    # every share agrees
    return arg[:, 0].to(torch.int32), torch.clamp_min(best[:, 0], 0.0)


# (split, n, d, k): the kernel's shares are a power of two, at most 32 and
# at most k
SPLIT_CASES = [(split, n, d, k)
               for n, d, k in [(300, 15, 20), (257, 38, 20), (64, 1, 6),
                               (40, 3, 300), (33, 16, 32), (9, 2, 1)]
               for split in (1, 2, 4, 8, 32) if split <= k]


@pytest.mark.parametrize("split,n,d,k", SPLIT_CASES)
def test_split_k_argmin_equals_plain(split, n, d, k):
    """Shares of k, then a lexicographic (d2, index) minimum, equal the
    plain version's argmin bitwise, ties included: repeated centroids in
    different shares, and points that sit on a centroid."""
    rng = np.random.default_rng(n + d + k + split)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    if k > 3:
        c[k - 1] = c[1]                       # a tie across shares
        c[k // 2] = c[0]
        x[:5] = c[1]                          # points on a tied centroid
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    got_lab, got_d2 = _split_k_argmin(pairwise_d2(x, c), split)
    assert torch.equal(got_lab, want_lab)
    assert torch.equal(got_d2, want_d2)
    if k > 3:
        assert not bool(((want_lab == k - 1) | (want_lab == k // 2)).any())


@pytest.mark.parametrize("shape,d,k", [
    ((100,), None, 4), ((3000,), 38, 20), ((1025,), 8, 7),
    ((3, 700), None, 6), ((2, 3, 333), 2, 5), ((2, 6861), 39, 20),
])
def test_segment_plain_matches_reference(shape, d, k):
    rng = np.random.default_rng(len(shape) * 100 + k)
    x = rng.normal(size=shape if d is None else shape + (d,)) \
        .astype(np.float32)
    # -1 (masked) and k (out of range) both add nothing; their rows hold
    # NaN, which must not reach any sum
    lab = rng.integers(-1, k + 1, shape).astype(np.int32)
    dead = (lab < 0) | (lab >= k)
    x[dead] = np.nan
    got = segment_ops.segment_stats(torch.from_numpy(x),
                                    torch.from_numpy(lab), k)
    want_ref = jax_seg_ref(jnp.asarray(x), jnp.asarray(lab), k)
    want_pallas = jax_segment(x, lab, k, backend="pallas")
    magnitude = np.asarray(jax_seg_ref(jnp.asarray(np.abs(x)),
                                       jnp.asarray(lab), k)[0])
    for want in (want_ref, want_pallas):
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            assert np.isfinite(g.numpy()).all()
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w, scale in ((got[0], want[0], magnitude),
                            (got[1], want[1], np.asarray(want[1]))):
            err = np.abs(g.numpy() - np.asarray(w))
            assert (err <= 1e-5 * scale + 1e-6).all(), err.max()


def test_segment_plain_bitwise_with_reference_oracle():
    """Rows add in index order, as the reference's segment_sum does."""
    rng = np.random.default_rng(7)
    x = rng.random((2, 5000, 3)).astype(np.float32)
    lab = rng.integers(0, 20, (2, 5000)).astype(np.int32)
    got = segment_ops.segment_stats(torch.from_numpy(x),
                                    torch.from_numpy(lab), 20)
    want = jax_seg_ref(jnp.asarray(x), jnp.asarray(lab), 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stratum_moments_plain():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 400)).astype(np.float32)
    lab = rng.integers(0, 5, (2, 400)).astype(np.int32)
    means, var, counts = segment_ops.stratum_moments(
        torch.from_numpy(x), torch.from_numpy(lab), 5)
    for a in range(2):
        for h in range(5):
            vals = x[a][lab[a] == h].astype(np.float64)
            assert counts[a, h] == vals.size
            np.testing.assert_allclose(means[a, h, 0], vals.mean(),
                                       rtol=1e-5)
            np.testing.assert_allclose(var[a, h, 0], vals.var(ddof=1),
                                       rtol=1e-4)


def test_routes_cpu_tensors_to_plain_and_never_counts():
    assign_ops.reset_launch_count()
    segment_ops.reset_launch_count()
    assign_ops._reset_dispatch_record()
    x = torch.zeros((2, 5, 3))
    assign_ops.kmeans_assign(x, torch.zeros((2, 2, 3)))
    segment_ops.segment_stats(x, torch.zeros((2, 5), dtype=torch.int32), 2)
    assert assign_ops.launch_count() == 0
    assert segment_ops.launch_count() == 0
    assert assign_ops.last_dispatch() is None
    assert backend.resolve_route(x, "auto") == "plain"
    assert backend.resolve_route(x, "plain") == "plain"


@pytest.mark.parametrize("name", ["kernel", "pallas", "jnp"])
def test_unknown_backend_raises(name):
    x = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError):
        assign_ops.kmeans_assign(x, torch.zeros((2, 2, 3)), backend=name)
    with pytest.raises(ValueError):
        segment_ops.segment_stats(x, torch.zeros((2, 5), dtype=torch.int32),
                                  2, backend=name)


# each CUDA source (or build unit) and the TPU kernel it replaces
KERNEL_SOURCES = {"flash_attention": "flash_attention",
                  "flash_attention_sm90": "flash_attention",
                  "kmeans_assign": "kmeans_assign",
                  "kmeans_assign_wide": "kmeans_assign",
                  "kmeans_assign_128": "kmeans_assign",
                  "segment_stats": "segment_stats"}


def test_kernel_sources_present():
    names = sorted(p.stem for p in backend.CSRC_DIR.glob("*.cu"))
    assert names == sorted(KERNEL_SOURCES)
    for name, tpu in KERNEL_SOURCES.items():
        text = (backend.CSRC_DIR / f"{name}.cu").read_text()
        assert f"src/repro/kernels/{tpu}/{tpu}.py" in text
        assert "atomicAdd(" not in text
    for header in backend.CSRC_DIR.glob("*.cuh"):
        assert "atomicAdd(" not in header.read_text()
