"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip. They
import torch only (no JAX), so they run on a card machine that has no
JAX: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``. The plain
versions themselves are held against the reference on the CPU in
``tests/test_torch_kernels.py``.

Tolerances: ``kmeans_assign`` labels must be equal except where the plain
version's best and second-best squared distances lie within 1e-5
relative (a float32 near-tie), distances to rtol 1e-5 / atol 1e-6;
``segment_stats`` counts exactly, sums within 1e-5 of the sum of the
terms' magnitudes per segment, sums of squares to 1e-5 relative — and,
at the main path's shapes, bitwise, since the kernel and the plain
version on both devices add in row order.
"""

import pytest
import torch

from repro_torch.kernels.kmeans_assign import ops as assign_ops
from repro_torch.kernels.segment_stats import ops as segment_ops

TIE_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only on "
                    "the card (python -m pytest -m cuda "
                    "tests/test_torch_cuda.py there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [(10, 120000, 15, 20),
                                     (10, 6861, 38, 20), (3, 129, 5, 7)])
def test_assign_kernel_matches_plain(cuda, b, n, d, k):
    from repro_torch.kernels.kmeans_assign.ref import pairwise_d2
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    c = torch.randn((b, k, d), generator=gen, device=cuda)
    before = assign_ops.launch_count()
    lab, d2 = assign_ops.kmeans_assign(x, c)
    assert assign_ops.launch_count() == before + 1
    all_d2 = pairwise_d2(x, c)
    two = torch.topk(all_d2, 2, dim=-1, largest=False).values
    ties = (two[..., 1] - two[..., 0]) <= TIE_RTOL * two[..., 1].abs()
    want_d2, want_lab = torch.min(all_d2, dim=-1)
    assert not ((lab.long() != want_lab) & ~ties).any()
    torch.testing.assert_close(d2, torch.clamp_min(want_d2, 0.0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [(10, 120000, 1, 20),
                                     (10, 6861, 39, 20), (3, 1025, 2, 5)])
def test_segment_kernel_matches_plain_and_is_deterministic(cuda, b, n, d, k):
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    lab = torch.randint(-1, k + 1, (b, n), generator=gen, device=cuda,
                        dtype=torch.int32)
    x = torch.where(((lab < 0) | (lab >= k))[..., None],
                    torch.full_like(x, float("nan")), x)
    first = segment_ops.segment_stats(x, lab, k)
    second = segment_ops.segment_stats(x, lab, k)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    want = segment_stats_ref(x, lab, k)
    assert torch.equal(first[2], want[2])
    scale = segment_stats_ref(x.abs(), lab, k)[0]
    assert ((first[0] - want[0]).abs() <= 1e-5 * scale + 1e-6).all()
    assert ((first[1] - want[1]).abs() <= 1e-5 * want[1] + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [(10, 120000, 1, 20),
                                     (10, 6861, 1, 20),
                                     (10, 120000, 16, 20),
                                     (10, 6861, 39, 20)])
def test_segment_plain_cuda_bitwise_equals_plain_cpu(cuda, b, n, d, k):
    """The plain version adds in row order on both devices (on CUDA it
    leans on ``index_put_(accumulate=True)`` sorting stably, as torch
    2.11 does), and so does the kernel: all three agree bitwise at the
    main path's shapes."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    lab = torch.randint(-1, k + 1, (b, n), generator=gen, device=cuda,
                        dtype=torch.int32)
    on_cpu = segment_stats_ref(x.cpu(), lab.cpu(), k)
    plain = segment_stats_ref(x, lab, k)
    kernel = segment_ops.segment_stats(x, lab, k)
    for want, got_plain, got_kernel in zip(on_cpu, plain, kernel):
        assert torch.equal(got_plain.cpu(), want)
        assert torch.equal(got_kernel.cpu(), want)


def _labels(pattern, b, n, k, gen, device):
    if pattern == "one_segment":
        return torch.full((b, n), k - 1, dtype=torch.int32, device=device)
    if pattern == "all_dead":
        return torch.full((b, n), -1, dtype=torch.int32, device=device)
    if pattern == "skewed":
        # most rows in segment 0, the rest spread, some dead
        lab = torch.randint(-1, k + 1, (b, n), generator=gen, device=device,
                            dtype=torch.int32)
        heavy = torch.rand((b, n), generator=gen, device=device) < 0.9
        return torch.where(heavy, torch.zeros_like(lab), lab)
    return torch.randint(-1, k + 1, (b, n), generator=gen, device=device,
                         dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,b,n,d,k", [
    ("one_segment", 2, 1000, 3, 4), ("all_dead", 2, 700, 2, 3),
    ("skewed", 3, 50000, 16, 20), ("random", 2, 257, 130, 5),
    ("random", 2, 3000, 1, 300), ("random", 1, 1, 1, 1),
    ("random", 4, 0, 2, 3), ("random", 3, 255, 7, 1)])
def test_segment_kernel_partition_edges_bitwise(cuda, pattern, b, n, d, k):
    """Label patterns that stress the partition: one segment or none
    holding every row, heavy skew, more segments than a tile has rows,
    more columns than one block sums, a single row, no rows."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    lab = _labels(pattern, b, n, k, gen, cuda)
    want = segment_stats_ref(x.cpu(), lab.cpu(), k)
    got = segment_ops.segment_stats(x, lab, k)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert torch.equal(g.cpu(), w)
