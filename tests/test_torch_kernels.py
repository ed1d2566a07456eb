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


def test_kernel_sources_present():
    names = sorted(p.stem for p in backend.CSRC_DIR.glob("*.cu"))
    assert names == ["kmeans_assign", "segment_stats"]
    for name in names:
        text = (backend.CSRC_DIR / f"{name}.cu").read_text()
        assert f"src/repro/kernels/{name}/{name}.py" in text
        assert "atomicAdd(" not in text
