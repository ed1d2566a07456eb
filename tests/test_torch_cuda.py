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
version on both devices add in row order. ``flash_attention`` against
its plain version (``flash_attention_ref``): 1e-4 (atol and rtol) in
float32, where only the order of the sums differs; rtol 8e-3 and atol
1e-3 in bfloat16, where one rounding of the output adds at most one bf16
unit in the last place (2^-7 of the value).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.kmeans_assign import ops as assign_ops
from repro_torch.kernels.segment_stats import ops as segment_ops

TIE_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only on "
                    "the card (python -m pytest -m cuda "
                    "tests/test_torch_cuda.py there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _update_inputs(case, gen, device):
    """(x, labels, k) of a centroid update as the simulation build gives
    it: (b, n, d) points with a weight column, labels in [0, k)."""
    if case == "padding_skew":
        # two thirds of lane 0 are weight-0 padding rows in one segment
        b, n, d, k = 2, 30000, 15, 20
        x = torch.randn((b, n, d), generator=gen, device=device)
        lab = torch.randint(0, k, (b, n), generator=gen, device=device,
                            dtype=torch.int32)
        w = torch.ones((b, n), device=device)
        pad = torch.zeros((b, n), dtype=torch.bool, device=device)
        pad[0, n // 3:] = True
        x[pad] = 0.0
        w[pad] = 0.0
        lab[pad] = 7
        vals = torch.cat([x * w[..., None], w[..., None]], dim=-1)
        return vals, lab, k
    b, n, d, k = {"long_d16": (2, 64000, 16, 20),
                  "d39": (3, 6861, 39, 20),
                  "k1": (2, 5000, 16, 1),
                  "k300": (2, 9000, 16, 300),
                  "n0": (3, 0, 16, 20)}[case]
    x = torch.randn((b, n, d), generator=gen, device=device)
    lab = torch.randint(-1, k, (b, n), generator=gen, device=device,
                        dtype=torch.int32)
    if case == "long_d16":
        lab[0, 1000:62000] = 3            # one 61,000-row segment
    return x, lab, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["padding_skew", "long_d16", "d39", "k1",
                                  "k300", "n0"])
def test_segment_kernel_update_shapes_bitwise(cuda, case):
    """The sum pass's chains at the centroid update's shapes: a weight-0
    segment holding two thirds of a lane (dropped or not, the sums are the
    same bits), one 61,000-row segment at d = 16, d = 39 (4-byte copies),
    one segment, 300 segments, no rows: bitwise equal to the plain version
    on the CPU, and two launches bitwise equal."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(17)
    x, lab, k = _update_inputs(case, gen, cuda)
    got = segment_ops.segment_stats(x, lab, k)
    again = segment_ops.segment_stats(x, lab, k)
    want = segment_stats_ref(x.cpu(), lab.cpu(), k)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape
        assert torch.equal(g.cpu(), w)
        assert torch.equal(g, a)
    if case == "padding_skew":
        dropped = torch.where(x[..., -1] != 0, lab, -1)
        sums, sumsq, counts = segment_ops.segment_stats(x, dropped, k)
        assert torch.equal(sums, got[0]) and torch.equal(sumsq, got[1])
        assert counts[0, 7] < got[2][0, 7]


@pytest.mark.cuda
def test_segment_kernel_orders_items_beyond_one_wave(cuda):
    """More sum-pass blocks than fit on the card at once: the items go
    longest segment first, and the result is the same bits."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, n, d, k = 40, 4000, 40, 300
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    lab = torch.randint(0, k, (b, n), generator=gen, device=cuda,
                        dtype=torch.int32)
    lab[:, :1500] = 11
    got = segment_ops.segment_stats(x, lab, k)
    assert segment_ops.last_dispatch()["ordered"]
    want = segment_stats_ref(x.cpu(), lab.cpu(), k)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("k", [11264, 11265, 20000, 120000])
def test_segment_kernel_bitwise_at_any_k(cuda, k, b):
    """At and above the one-block partition's 11,264 segments (the
    ranged partition: ``partition_geometry``), up to one segment a
    region: bitwise equal to the plain version on the CPU, two launches
    bitwise equal, the launch's geometry the wrapper's."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    n, d = 120000, 16
    gen = torch.Generator(device=cuda).manual_seed(k + b)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    lab = torch.randint(-1, k + 1, (b, n), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = segment_ops.segment_stats(x, lab, k)
    rec = segment_ops.last_dispatch()
    again = segment_ops.segment_stats(x, lab, k)
    want = segment_stats_ref(x.cpu(), lab.cpu(), k)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.cpu(), w)
        assert torch.equal(g, a)
    geometry = segment_ops.partition_geometry(n, k)
    assert {key: rec[key] for key in ("tiles", "tile_rows", "ranges")} == {
        key: geometry[key] for key in ("tiles", "tile_rows", "ranges")}
    assert int(segment_ops._lib()[1](b, n, k, d)) == \
        segment_ops.workspace_words(b, n, k, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [65536, 70000])
def test_segment_kernel_bitwise_past_65535_lanes(cuda, b):
    """More lanes than one launch's grid holds on its y axis."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(b)
    x = torch.randn((b, 4, 3), generator=gen, device=cuda)
    lab = torch.randint(-1, 3, (b, 4), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = segment_ops.segment_stats(x, lab, 2)
    want = segment_stats_ref(x.cpu(), lab.cpu(), 2)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,d", [(1, 30000, 12000, 15),
                                     (2, 5000, 2000, 38),
                                     (1, 4000, 3000, 15)])
def test_assign_kernel_bitwise_past_the_register_units_centroids(cuda, b, n,
                                                                 k, d):
    """More centroids than ``kmeans_assign.cu`` holds in shared memory
    (d = 15 to about k = 3,400, d = 38 to about 1,400) go to the tiled
    unit, bitwise equal to the plain version; fewer stay."""
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    gen = torch.Generator(device=cuda).manual_seed(n + k + d)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    c = torch.randn((b, k, d), generator=gen, device=cuda)
    lab, d2 = assign_ops.kmeans_assign(x, c)
    want_lab, want_d2 = kmeans_assign_ref(x.cpu(), c.cpu())
    assert torch.equal(lab.cpu(), want_lab)
    assert torch.equal(d2.cpu(), want_d2)
    assert assign_ops.last_dispatch()["unit"] == (
        "kmeans_assign" if k == 3000 else "kmeans_assign_tiled")


@pytest.mark.cuda
def test_tiled_assign_kernel_bitwise_past_65535_lanes(cuda):
    """The tiled unit over 70,000 lanes of 4 points and 3 centroids."""
    from repro_torch.kernels.kmeans_assign.ref import (dot_order,
                                                       kmeans_assign_ref)
    gen = torch.Generator(device=cuda).manual_seed(70000)
    x = torch.randn((70000, 4, 5), generator=gen, device=cuda)
    c = torch.randn((70000, 3, 5), generator=gen, device=cuda)
    lab, d2, geometry = assign_ops._launch(x, c, dot_order(x, c),
                                           "kmeans_assign_tiled")
    want_lab, want_d2 = kmeans_assign_ref(x.cpu(), c.cpu())
    assert torch.equal(lab.cpu(), want_lab)
    assert torch.equal(d2.cpu(), want_d2)
    assert geometry[1] == 70000


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [
    (3, 1001, 15, 20),      # n d 4 = 60060: tiles off 16 bytes per lane
    (5, 777, 38, 7),        # odd lanes start 8 bytes off 16
    (10, 6861, 38, 20),     # the RFV fit's shape: split k
    (2, 3000, 1, 6), (2, 2000, 128, 20),
    (2, 4000, 15, 1), (2, 3000, 16, 300), (1, 5, 3, 300)])
def test_assign_kernel_bitwise(cuda, b, n, d, k):
    """Labels and distances bitwise equal to the plain version on the
    CPU, ties included (two centroids repeated), at tile boundaries off
    16 bytes, through the split-k path, at d = 1 and 128, k = 1 and 300."""
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    gen = torch.Generator(device=cuda).manual_seed(n + d + k)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    c = torch.randn((b, k, d), generator=gen, device=cuda)
    if k > 3:
        c[:, 3] = c[:, 1]                # exact ties go to the lower index,
        c[:, -1] = c[:, 1]               # across shares of k too
    lab, d2 = assign_ops.kmeans_assign(x, c)
    want_lab, want_d2 = kmeans_assign_ref(x.cpu(), c.cpu())
    assert torch.equal(lab.cpu(), want_lab)
    assert torch.equal(d2.cpu(), want_d2)
    if k > 3:
        assert not ((lab == 3) | (lab == k - 1)).any()
    rec = assign_ops.last_dispatch()
    assert rec["tiles"] >= rec["grid"][0] >= 1
    if (b, n, d) == (10, 6861, 38):
        assert rec["split"] > 1


FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (8e-3, 1e-3)}


def _qkv(shape, dtype, device, seed):
    b, hq, hkv, sq, skv, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 4, 2, 256, 256, 64), (2, 8, 4, 300, 300, 32),
    (1, 4, 1, 1, 512, 64), (1, 2, 2, 1, 700, 128),
    (1, 4, 4, 512, 512, 128),                    # tests/test_kernels.py
    (1, 2, 2, 1, 700, 64),                       # decode, 700-long cache
    (1, 2, 1, 100, 612, 64),                     # append to a cache
    (1, 2, 2, 200, 200, 64), (1, 4, 2, 200, 200, 64),
    (1, 6, 2, 200, 200, 64), (1, 8, 2, 200, 200, 64),  # GQA groups 1-4
    (1, 2, 1, 130, 130, 8), (1, 2, 1, 130, 130, 40),   # d padded in-kernel
    (4, 24, 8, 1024, 1024, 128),                 # far more blocks than SMs
    (1, 3, 1, 7, 1000, 128), (2, 4, 1, 7, 129, 32),    # 7-row appends
    (2, 6, 2, 333, 333, 40), (1, 4, 1, 257, 385, 64),  # ragged tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _qkv(shape, dtype, cuda, seed=sum(shape))
    before = flash_ops.launch_count()
    out = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_ops.launch_count() == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 4, 2, 256, 512, 64), (1, 4, 4, 512, 256, 64),   # sq < and > skv
    (2, 6, 2, 333, 100, 40), (1, 4, 1, 257, 385, 32),   # ragged, GQA
    (1, 2, 2, 1, 700, 128), (2, 3, 3, 130, 7, 128),     # one row, few keys
    (2, 16, 16, 300, 1000, 64), (1, 16, 16, 1000, 300, 64),  # cross-like
    (1, 2, 1, 130, 130, 8),                              # d padded in-kernel
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_kernel_matches_plain(cuda, shape, dtype):
    """The bidirectional branch (the enc-dec model's encoder and
    cross-attention) against ``flash_attention_ref(causal=False)``: ragged
    sq and skv, sq above skv, d = 8 to 128; counted as a non-causal
    launch."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _qkv(shape, dtype, cuda, seed=sum(shape) + 1)
    causal0 = flash_ops.launch_count("causal")
    before = flash_ops.launch_count("non_causal")
    out = flash_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_ops.launch_count("non_causal") == before + 1
    assert flash_ops.launch_count("causal") == causal0
    assert flash_ops.last_dispatch()["causal"] is False
    assert out.dtype == dtype and out.shape == q.shape
    rtol, atol = FLASH_TOL[dtype]
    want = flash_attention_ref(q, k, v, causal=False).float()
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
    causal = flash_attention_ref(q, k, v).float() if shape[3] <= shape[4] \
        else None
    if causal is not None and shape[3] > 1:
        assert not torch.allclose(want, causal, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 7, 60, 100, 136, 192, 256, 320, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_at_every_width(cuda, d, causal, dtype):
    """Every head width, both branches, both types: below 8 and not a
    multiple of 8 through the padded copy, above 128 in column blocks
    (``kernel_plan``, recorded by ``last_dispatch``); GQA, ragged tiles."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    shape = (2, 4, 2, 200, 300 if causal else 170, d)
    q, k, v = _qkv(shape, dtype, cuda, seed=d)
    out = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    rec = flash_ops.last_dispatch()
    plan = flash_ops.kernel_plan(d)
    assert {key: rec[key] for key in plan} == plan
    rows = flash_ops.BF16_ROWS if dtype == torch.bfloat16 \
        else flash_ops.F32_ROWS
    assert rec["grid"] == (-(-200 // rows) * 2 * 4 * plan["col_blocks"],)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
        rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["non_causal", "sq_gt_skv", "heads",
                                  "dtypes"])
def test_flash_kernel_raises(cuda, case):
    """Refused before any launch: a causal call with sq > skv, a
    non-causal one with no key column, bad heads and types (every width
    is taken: ``test_flash_kernel_matches_plain_at_every_width``)."""
    shape = {"non_causal": (1, 2, 2, 8, 0, 64),
             "sq_gt_skv": (1, 2, 2, 65, 64, 64),
             "heads": (1, 3, 2, 8, 8, 64)}.get(case, (1, 2, 2, 8, 8, 64))
    q, k, v = _qkv(shape, torch.float32, cuda, seed=1)
    if case == "dtypes":
        q = q.to(torch.bfloat16)
    before = flash_ops.launch_count()
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v, causal=case != "non_causal")
    assert flash_ops.launch_count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 6, 2, 300, 300, 128),
                                   (1, 4, 1, 7, 260, 64),
                                   (1, 8, 2, 130, 130, 40),
                                   (3, 3, 3, 64, 200, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_projection_layout(cuda, shape, dtype):
    """(b, h, s, d) views of (b, s, h, d) tensors, read in place, give
    the same bits as contiguous copies; the output is the (b, hq, sq, d)
    view of a contiguous (b, sq, hq, d) tensor."""
    b, hq, hkv, sq, skv, d = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    views = [torch.randn((b, s, h, d), generator=gen, device=cuda)
             .to(dtype).transpose(1, 2)
             for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    got = flash_ops.flash_attention(*views)
    want = flash_ops.flash_attention(*(t.contiguous() for t in views))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.shape == (b, hq, sq, d) and got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["last_dim_strided", "row_stride_not_8",
                                  "unaligned_base"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rejects_layout(cuda, case, dtype):
    b, h, s, d = 1, 2, 16, 64
    good = torch.zeros((b, h, s, d), dtype=dtype, device=cuda)
    bad = {"last_dim_strided": lambda: torch.zeros(
               (b, h, s, 2 * d), dtype=dtype, device=cuda)[..., ::2],
           "row_stride_not_8": lambda: torch.zeros(
               (b, h, s, d + 4), dtype=dtype, device=cuda)[..., :d],
           "unaligned_base": lambda: torch.zeros(
               b * h * s * d + 2, dtype=dtype, device=cuda)[2:]
           .reshape(b, h, s, d)}[case]()
    before = flash_ops.launch_count()
    with pytest.raises(ValueError):
        flash_ops.flash_attention(bad, good, good)
    assert flash_ops.launch_count() == before


# --------------------------------------- fused sweep and trials as graphs
SWEEP_APPS = ("505.mcf_r", "520.omnetpp_r")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def sweep_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.experiments import ExperimentEngine
    engine = ExperimentEngine(device="cuda")
    engine.build(SWEEP_APPS)
    engine.memo.cols_for(engine.configs)
    return engine


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,policy", [("bbv", "centroid"),
                                           ("rfv", "random"),
                                           ("dg", "mean")])
def test_fused_graph_replays_its_eager_run_bitwise(cuda, sweep_engine,
                                                  scheme, policy):
    """The first fused sweep runs eagerly and captures its graph; the
    same sweep from the same memo state, replayed, gives the same
    outputs and memo tables bit for bit and captures nothing new."""
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import SweepSpec, fused, run_sweep
    engine = sweep_engine
    spec = SweepSpec(apps=SWEEP_APPS,
                     plan=SamplingPlan.from_strings(scheme, policy))
    snap = engine.memo.state()
    captures = fused.program_captures()
    eager = run_sweep(engine, spec)
    out_eager = {k: v.clone() for k, v in engine.fused_outputs.items()}
    tree_eager, _ = engine.memo.state()
    assert fused.program_captures() == captures + 1
    engine.memo.load_state(*snap)
    replayed = run_sweep(engine, spec)
    tree_replay, _ = engine.memo.state()
    assert fused.program_captures() == captures + 1
    for k, v in out_eager.items():
        assert _same_bits(engine.fused_outputs[k], v), k
    assert list(replayed.column("estimate")) == list(eager.column("estimate"))
    for k in ("mask", "cpi", "charges", "hit_count", "miss_count",
              "ledger_regions"):
        assert (tree_eager[k] == tree_replay[k]).all(), k


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["random", "rfv"])
def test_trial_chunk_graph_equals_eager_chunks(cuda, sweep_engine, scheme):
    """Chunks replayed from a captured graph equal the same chunks run
    eagerly, in every carry leaf and kept array; a warm run captures
    nothing new."""
    from repro_torch.core.sampling.tables import trial_stats_init
    from repro_torch.experiments import montecarlo as mc
    engine = sweep_engine
    spec = mc.TrialSpec(trials=1500, schemes=(scheme,), chunk_size=512)
    truth, _, setups = mc._scheme_setup(engine, spec, SWEEP_APPS)
    chunk_fn, draws, crit, tables = setups[scheme]
    prog = mc._StreamingProgram(chunk_fn, 2, draws, torch.float32, True)
    x = mc._program_inputs(spec, scheme, truth.float(), crit, tables)
    carry = trial_stats_init((len(SWEEP_APPS),), device=cuda)
    eager = []
    for c in range(3):
        carry, (ys, _) = prog.step(carry, {**x, "b0": torch.full(
            (), 2 * c, dtype=torch.int64, device=cuda)})
        eager.append(ys)
    captures = mc.program_captures()
    for run in range(2):
        stats, chunks, _ = prog.run(x, chunk0=0, n_chunks=3,
                                    graphs=engine.graphs)
        assert mc.program_captures() == captures + 1
        for a, b in zip(stats.leaves(), carry.leaves()):
            assert _same_bits(a, b)
        for got, want in zip(chunks, eager):
            for g, w in zip(got, want):
                assert _same_bits(g, w)


@pytest.mark.cuda
def test_graphs_are_freed_with_their_engine(cuda):
    """The fused sweep's and the trial chunks' graphs (their pools and
    static buffers) belong to the engine: deleting it gives all of the
    card's memory back."""
    import gc
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import (ExperimentEngine, SweepSpec,
                                         TrialSpec, run_sweep, run_trials)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    engine = ExperimentEngine(device="cuda")
    run_sweep(engine, SweepSpec(apps=SWEEP_APPS,
                                plan=SamplingPlan.from_strings("bbv")))
    run_trials(engine, TrialSpec(trials=512, schemes=("random", "rfv")),
               apps=SWEEP_APPS)
    assert len(engine.graphs) == 3
    del engine
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.cuda
def test_fused_graph_recaptures_when_the_memo_grows(cuda):
    """A graph writes into the memo tables it was captured on; when the
    memo grows (a new app), the next fused sweep captures anew on the new
    tables and still equals the staged sweep bit for bit."""
    import dataclasses
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import (ExperimentEngine, SweepSpec, fused,
                                         run_sweep)
    engine = ExperimentEngine(device="cuda")
    spec = SweepSpec(apps=SWEEP_APPS[:1],
                     plan=SamplingPlan.from_strings("rfv", "centroid"))
    run_sweep(engine, spec)
    captures = fused.program_captures()
    mask = engine.memo.mask
    engine.build(SWEEP_APPS)
    assert engine.memo.mask is not mask
    engine.memo.cols_for(engine.configs)
    snap = engine.memo.state()
    got = run_sweep(engine, spec)
    assert fused.program_captures() == captures + 1
    tree_fused, _ = engine.memo.state()
    engine.memo.load_state(*snap)
    want = run_sweep(engine, dataclasses.replace(spec, fused=False))
    tree_staged, _ = engine.memo.state()
    assert list(got.column("estimate")) == list(want.column("estimate"))
    for k in ("mask", "cpi", "charges"):
        assert (tree_fused[k] == tree_staged[k]).all(), k



# ------------------------------------------------- the flow's new shapes
@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(120000, 15, 50),     # gcc sensitivity
                                   (6861, 38, 500)])     # Fig 12/13 k=500
def test_clustering_kernels_bitwise_at_figure_shapes(cuda, n, d, k):
    """Both clustering kernels bitwise equal to their plain versions at the
    figure path's new shapes: k = 50 over gcc's 120,000 projected BBVs,
    and k = 500 (82 KB of centroids in shared memory) over the largest
    phase-1 RFV sample; the update's [x, 1] sums by the labels it gives."""
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn((1, n, d), generator=gen, device=cuda)
    c = x[:, torch.randperm(n, generator=gen, device=cuda)[:k]] \
        + 0.01 * torch.randn((1, k, d), generator=gen, device=cuda)
    lab, d2 = assign_ops.kmeans_assign(x, c)
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_lab) and torch.equal(d2, want_d2)
    vals = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    got = segment_ops.segment_stats(vals, lab, k)
    want = segment_stats_ref(vals, lab, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k,weighted", [(1, 6861, 38, 500, False),
                                              (3, 2000, 15, 20, True)])
def test_kmeanspp_graph_replays_equal_cpu_seeding(cuda, b, n, d, k,
                                                  weighted):
    """k-means++ seeding on the card (one eager draw, then replays of its
    CUDA graph) picks bitwise the seeds the CPU's eager draws pick, at the
    Fig 12/13 shape and for a weighted stack of lanes."""
    from repro_torch import prng
    from repro_torch.core.clustering.kmeans import _kmeanspp_init
    gen = torch.Generator().manual_seed(n + k)
    x = torch.randn((b, n, d), generator=gen)
    w = (torch.rand((b, n), generator=gen) > 0.3).float() \
        if weighted else None
    keys = torch.stack([prng.PRNGKey(s) for s in range(b)])
    want = _kmeanspp_init(keys, x, k, w)
    got = _kmeanspp_init(keys.to(cuda), x.to(cuda), k,
                         None if w is None else w.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(900,), (4, 3000)])
def test_stratum_tables_device_route_matches_host(cuda, shape):
    """``stratum_tables``' segment_stats route on the card against its
    float64 host route: counts exactly, moments and the eq. (3) / (6)
    estimates to rtol 1e-5; the tables stay on the card."""
    from repro_torch.core.sampling import tables
    gen = torch.Generator(device=cuda).manual_seed(shape[-1])
    y = 3.0 + torch.randn(shape, generator=gen, device=cuda,
                          dtype=torch.float64)
    labels = torch.randint(-1, 20, shape, generator=gen, device=cuda)
    host = tables.stratum_tables(y, labels, num_strata=20)
    before = segment_ops.launch_count()
    dev = tables.stratum_tables(y, labels, num_strata=20, backend="auto")
    assert segment_ops.launch_count() == before + 1
    assert dev.counts.is_cuda and dev.sums.is_cuda and dev.shift.is_cuda
    assert torch.equal(dev.counts.cpu().double(), host.counts)
    for f in ("means", "variances"):
        torch.testing.assert_close(getattr(dev, f).cpu().double(),
                                   getattr(host, f), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(
        tables.two_phase_variance(dev, 900).cpu().double(),
        tables.two_phase_variance(host, 900), rtol=1e-5, atol=1e-12)


@pytest.mark.cuda
def test_stratum_tables_auto_never_leaves_the_card(cuda, monkeypatch):
    """A CUDA input under backend="auto": no copy to the host anywhere in
    the construction."""
    from repro_torch.core.sampling import tables
    y = torch.rand(5000, device=cuda)
    labels = torch.randint(0, 20, (5000,), device=cuda)
    real_to, real_cpu = torch.Tensor.to, torch.Tensor.cpu

    def to(self, *args, **kwargs):
        dest = args[0] if args else kwargs.get("device")
        if self.is_cuda and (dest == "cpu" or getattr(dest, "type", None)
                             == "cpu"):
            raise AssertionError("a CUDA tensor was moved to the CPU")
        return real_to(self, *args, **kwargs)

    def cpu(self, *args, **kwargs):
        raise AssertionError("a CUDA tensor was moved to the CPU")

    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    t = tables.stratum_tables(y, labels, num_strata=20, backend="auto")
    mean = tables.stratified_mean(t)
    monkeypatch.undo()
    assert t.counts.is_cuda and mean.is_cuda
    assert int(t.counts.sum()) == 5000


@pytest.mark.cuda
def test_two_phase_flow_on_the_card_equals_cpu(cuda):
    """``TwoPhaseFlow`` on the card (clustering kernels) against the same
    flow on the CPU (plain versions) for one app: phase-1 indices and
    picks equal, labels equal except at near-ties, estimates to
    rtol 1e-5."""
    import numpy as np
    from repro_torch.core import sampling as S
    from repro_torch.simcpu import CONFIGS, make_cached_simulator
    out = {}
    for dev in ("cpu", "cuda"):
        sim = make_cached_simulator("520.omnetpp_r", device=dev)
        flow = S.TwoPhaseFlow(population_size=sim.pop.n_regions,
                              rng=np.random.default_rng(11), device=dev)
        before = assign_ops.launch_count()
        idx1, y0, feats, _ = flow.characterize(
            lambda i: sim.simulate_rfv(i, CONFIGS[0]), 900)
        strat = flow.stratify(idx1, y0, feats,
                              scheme=S.RFVClusters(num_strata=20))
        launched = assign_ops.launch_count() - before
        sel = flow.select(strat, policy=S.Centroid())
        ests = [flow.point_estimate(strat, sel,
                                    lambda i, c=c: sim.simulate_cpi(i, c))
                for c in CONFIGS]
        ci = flow.ci_check(strat, lambda i: sim.simulate_cpi(i, CONFIGS[6]),
                           per_stratum_sizes=np.full(20, 8))
        out[dev] = (idx1.cpu(), strat, [s.cpu() for s in sel], ests, ci,
                    launched)
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu[5] > 0 and cpu[5] == 0
    assert torch.equal(cpu[0], gpu[0])
    diff = (cpu[1].labels != gpu[1].labels.cpu()).nonzero().reshape(-1)
    if diff.numel():
        z = cpu[1].features.double()[diff]
        d2 = ((z[:, None] - cpu[1].centroids.double()[None]) ** 2).sum(-1)
        two = torch.sort(d2, dim=1).values[:, :2]
        assert bool((two[:, 1] - two[:, 0] <= TIE_RTOL * two[:, 0]).all())
    else:
        assert [s.tolist() for s in cpu[2]] == [s.tolist() for s in gpu[2]]
    np.testing.assert_allclose(gpu[3], cpu[3], rtol=1e-5)
    np.testing.assert_allclose([gpu[4].mean, gpu[4].margin],
                               [cpu[4].mean, cpu[4].margin], rtol=1e-5)


# ------------------------------------- the reference's dot order, per shape
def _dot_order_rows():
    from repro_torch.core.ordered import DOT_ORDERS
    # and the fit shapes below d = 4, which have no row (one chain)
    return sorted(DOT_ORDERS) + [(1, 32, 4, 3), (1, 120, 16, 2),
                                 (1, 200, 6, 2), (1, 250, 8, 2),
                                 (3, 400, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _dot_order_rows(),
                         ids=lambda s: "x".join(map(str, s)))
def test_assign_kernel_bitwise_at_every_dot_order_row(cuda, shape):
    """At every row of the dot-order table (B lanes, n points, k
    centroids, d features) the kernel takes the row's order, as its plain
    version does, and the two agree bit for bit."""
    from repro_torch.core.ordered import reference_dot_order
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    b, n, k, d = shape
    gen = torch.Generator(device=cuda).manual_seed(b * 7 + n + k + d)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    c = torch.randn((b, k, d), generator=gen, device=cuda)
    lab, d2 = assign_ops.kmeans_assign(x, c)
    assert assign_ops.last_dispatch()["order"] == reference_dot_order(*shape)
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_lab) and _same_bits(d2, want_d2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 6, 9, 10, 13, 21, 22, 37, 42, 61, 62,
                               65, 66, 94, 125, 126])
def test_assign_kernel_bitwise_in_two_chains(cuda, d):
    """Where d is 1 or 2 mod 4 the interleaved order is two chains and an
    odd last product: the kernel agrees with its plain version bit for
    bit at every width it instantiates (ceil4(d) up to 64, then 128).
    k = 28 takes that order at every one of these widths (at k <= 24 the
    reference takes four chains from d = 93)."""
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((2, 700, d), generator=gen, device=cuda)
    c = torch.randn((2, 28, d), generator=gen, device=cuda)
    lab, d2 = assign_ops.kmeans_assign(x, c)
    assert assign_ops.last_dispatch()["order"] == "four"
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_lab) and _same_bits(d2, want_d2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,d", [
    (1, 6861, 40, 38), (1, 6861, 8, 38), (2, 6861, 200, 38),
    (1, 120000, 28, 15), (3, 5000, 96, 15), (2, 700, 12, 6),
    (2, 900, 30, 7), (1, 700, 10, 21), (2, 700, 27, 16), (1, 300, 3, 5),
    (2, 700, 20, 94), (1, 500, 18, 126), (2, 600, 30, 56)])
def test_assign_kernel_bitwise_in_swapped_order(cuda, b, n, k, d):
    """The third dot order (``core.ordered.dot_swapped``: four chains
    where d is 1 or 2 mod 4, two elsewhere) at shapes where the reference
    takes it, through every build unit: the kernel takes it too and
    agrees with ``pairwise_d2``'s argmin bit for bit."""
    from repro_torch.core.ordered import reference_dot_order
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    assert reference_dot_order(b, n, k, d) == "swapped"
    gen = torch.Generator(device=cuda).manual_seed(b + n + k + d)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    c = torch.randn((b, k, d), generator=gen, device=cuda)
    lab, d2 = assign_ops.kmeans_assign(x, c)
    assert assign_ops.last_dispatch()["order"] == "swapped"
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_lab) and _same_bits(d2, want_d2)


# ------------------------------------------ the wide path (tiled unit)
def _order_k(order: str, d: int) -> tuple[int, int]:
    """(lanes, k) at which the reference's rule takes ``order`` at width
    d: one lane at k = 1 for the vector loop, two for the matrix-vector
    loop, else the first k from a short list that the rule maps there."""
    from repro_torch.core.ordered import reference_dot_order
    if order in ("vector", "gemv"):
        return (1 if order == "vector" else 2), 1
    for k in (20, 28, 50, 40, 2, 65, 100, 12, 30):
        if reference_dot_order(2, 3001, k, d) == order:
            return 2, k
    raise AssertionError(f"no k gives {order} at d = {d}")


def _assign_bitwise(cuda, b, n, k, d, order=None):
    """The kernel against its plain version on the card at (b, n, k, d),
    two centroids repeated (exact ties go to the lower index), labels and
    distances bit for bit; returns the dispatch record."""
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    gen = torch.Generator(device=cuda).manual_seed(b * 7 + n + k + d)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    c = torch.randn((b, k, d), generator=gen, device=cuda)
    if k > 3:
        c[:, 3] = c[:, 1]
        c[:, -1] = c[:, 1]
    lab, d2 = assign_ops.kmeans_assign(x, c)
    rec = assign_ops.last_dispatch()
    if order is not None:
        assert rec["order"] == order
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_lab) and _same_bits(d2, want_d2)
    if k > 3:
        assert not ((lab == 3) | (lab == k - 1)).any()
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("d", [41, 44, 63, 64, 100, 128])
def test_assign_kernel_bitwise_in_one_chain_above_40(cuda, d):
    """The one-chain order above d = 40, which the register-resident
    unit does not build: the tiled unit serves it, bit for bit."""
    rec = _assign_bitwise(cuda, 2, 3001, 50, d, "chain")
    assert rec["unit"] == "kmeans_assign_tiled"


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["four", "chain", "swapped", "vector",
                                   "gemv"])
@pytest.mark.parametrize("d", [129, 130, 256, 257, 512, 1000])
def test_assign_kernel_bitwise_in_every_order_above_128(cuda, d, order):
    """Every dot order above d = 128 (one chain restarted every 512
    columns at d = 1000, the one-centroid loops), through the tiled
    unit, bit for bit with the plain version."""
    b, k = _order_k(order, d)
    rec = _assign_bitwise(cuda, b, 3001, k, d, order)
    assert rec["unit"] == "kmeans_assign_tiled"


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["four", "chain", "vector", "gemv"])
@pytest.mark.parametrize("d", [1025, 2049])
def test_assign_kernel_bitwise_past_1024(cuda, d, order):
    """Past d = 1024: the norms' window tree of two levels, one chain over
    three and five 512-column blocks, the vector loop not unrolled."""
    b, k = _order_k(order, d)
    _assign_bitwise(cuda, b, 501, k, d, order)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 20, 28, 64, 500, 1024])
@pytest.mark.parametrize("d", [64, 256])
def test_assign_kernel_bitwise_by_k_and_lanes(cuda, d, k, b):
    """k from one centroid to 1,024 over one to three lanes, at a width
    inside the register-resident units' and one beyond it: whichever
    unit serves, labels (ties included) and distances bit for bit."""
    _assign_bitwise(cuda, b, 1003, k, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,d", [(2, 9, 1, 5), (2, 1, 1, 6),
                                     (3, 2, 2, 5), (2, 2, 1, 7),
                                     (1, 2, 20, 5)])
def test_assign_kernel_bitwise_in_the_norms_lane_order(cuda, b, n, k, d):
    """One centroid or one point a lane: the norms' vector rows are the
    lanes (``core.ordered.norm_vector_form``), and two rows at d = 5 add
    the fifth square by a multiply-add; every unit follows."""
    _assign_bitwise(cuda, b, n, k, d)


# --------------------------------- resumed sweeps and coalesced requests
def _fresh_engine(backend="auto"):
    from repro_torch.experiments import ExperimentEngine
    engine = ExperimentEngine(device="cuda", backend=backend)
    engine.build(SWEEP_APPS)
    engine.memo.cols_for(engine.configs)
    return engine


def _same_tables(a, b):
    tree_a, meta_a = a.memo.state()
    tree_b, meta_b = b.memo.state()
    assert meta_a == meta_b
    for k in ("mask", "cpi", "charges", "hit_count", "miss_count",
              "ledger_regions", "ledger_instr"):
        assert (tree_a[k] == tree_b[k]).all(), k


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,policy", [("rfv", "centroid"),
                                           ("dg", "centroid")])
def test_resumed_sweep_equals_uninterrupted_on_the_card(cuda, tmp_path,
                                                        scheme, policy):
    """A supervised sweep killed three times (one fault of each kind,
    each firing) through the kernels equals the uninterrupted run through
    the kernels and the uninterrupted run through the plain versions, bit
    for bit, in rows and memo tables."""
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import (SweepSpec, run_sweep_resumable,
                                         supervise_sweep)
    from repro_torch.runtime.faults import FAULT_KINDS, FaultPlan
    spec = SweepSpec(apps=SWEEP_APPS, config_indices=(0, 3, 6),
                     plan=SamplingPlan.from_strings(scheme, policy))
    plan = FaultPlan.random(2, len(SWEEP_APPS) * 3, kills=3)
    assert sorted(e.kind for e in plan.events) == sorted(FAULT_KINDS)
    engines = []

    def make(mesh):
        engines.append(_fresh_engine())
        return engines[-1]

    got, report = supervise_sweep(make, spec, tmp_path / "f", faults=plan,
                                  app_block=1, config_block=1)
    assert report.restarts == 3
    assert [a["error"].split()[1] for a in report.attempts[:-1]] == \
        [e.kind for e in plan.events]
    for backend in ("auto", "plain"):
        engine = _fresh_engine(backend)
        want = run_sweep_resumable(engine, spec, tmp_path / backend,
                                   app_block=1, config_block=1)
        for r, w in zip(got.rows, want.rows):
            assert (r.estimate, r.err_pct, r.n_units) == \
                (w.estimate, w.err_pct, w.n_units)
        _same_tables(engines[-1], engine)


@pytest.mark.cuda
def test_coalesced_equals_serial_on_the_card(cuda):
    """Coalesced requests (captured group graphs, replayed on a second
    batch) through the kernels equal the same requests run one by one
    through the plain versions, bit for bit: rows, tables, charges,
    counters and ledgers."""
    from repro_torch.core.sampling.plan import (Centroid, DaleniusGurney,
                                                RandomUnit, RFVClusters,
                                                SamplingPlan)
    from repro_torch.experiments import SweepSpec, run_sweep
    from repro_torch.serving import batcher, run_coalesced_sweeps
    specs = [SweepSpec(apps=SWEEP_APPS, config_indices=(0, 1, 2),
                       plan=SamplingPlan(RFVClusters(), RandomUnit()),
                       selection_seed=s) for s in (1, 2, 3)]
    specs += [SweepSpec(apps=SWEEP_APPS, config_indices=(3, 4, 5, 6),
                        plan=SamplingPlan(DaleniusGurney(), Centroid()))] * 2
    kernel, plain = _fresh_engine(), _fresh_engine("plain")
    captures = batcher.program_captures()
    for rnd in range(2):
        got = run_coalesced_sweeps(kernel, specs)
        want = [run_sweep(plain, s) for s in specs]
        for g, w in zip(got, want):
            assert list(g.column("estimate")) == list(w.column("estimate"))
            assert list(g.column("n_units")) == list(w.column("n_units"))
        _same_tables(kernel, plain)
    assert batcher.program_captures() == captures + 2


# ------------------------------------------------------------ the app mesh
@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 6, 7, 8])
@pytest.mark.parametrize("n,k", [(17, 12), (20, 17), (36, 20), (84, 36),
                                 (100, 88), (915, 20)])
def test_assign_kernel_bitwise_in_the_norms_row_order(cuda, d, n, k):
    """At d = 5 to 8 a squared norm's order depends on its row's place
    (``core.ordered.norm_vector_rows``): the kernel's point and centroid
    norms follow it, bit for bit with the plain version, on rows chosen so
    that the two orders differ."""
    from repro_torch.core.ordered import sum_sq
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
    gen = torch.Generator(device=cuda).manual_seed(n * d + k)
    pool = torch.randn((40 * (n + k), d), generator=gen, device=cuda) \
        * 10.0 ** (2 * torch.rand((40 * (n + k), d), generator=gen,
                                  device=cuda) - 1)
    in_order = torch.zeros(pool.shape[0], device=cuda)
    for j in range(d):
        in_order = in_order + pool[:, j] * pool[:, j]
    pool = pool[sum_sq(pool) != in_order]
    x = pool[:2 * n].reshape(2, n, d)
    c = pool[2 * n:2 * n + 2 * k].reshape(2, k, d)
    lab, d2 = assign_ops.kmeans_assign(x, c)
    want_lab, want_d2 = kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_lab)
    assert _same_bits(d2, want_d2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n,d", [(120000, 16), (6861, 39), (30000, 15)])
def test_segment_kernel_bitwise_at_the_mesh_local_shapes(cuda, b, n, d):
    """``segment_stats`` at one shard's lanes of the sharded build's BBV
    and RFV updates (the weights riding as the last column, weight-0 rows
    labelled -1) and at a distributed k-means shard: bit for bit with the
    plain version."""
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(b * n + d)
    x = torch.randn((b, n, d), generator=gen, device=cuda)
    labels = torch.randint(0, 20, (b, n), generator=gen, device=cuda,
                           dtype=torch.int32)
    labels[:, n - n // 7:] = -1
    got = segment_ops.segment_stats(x, labels, 20)
    want = segment_stats_ref(x, labels, 20)
    for g, w in zip(got, want):
        assert _same_bits(g, w)


def _mesh_engine(mesh):
    from repro_torch.experiments import ExperimentEngine
    engine = ExperimentEngine(device="cuda", mesh=mesh)
    engine.build(SWEEP_APPS)
    engine.memo.cols_for(engine.configs)
    return engine


@pytest.mark.cuda
def test_sharded_build_and_sweeps_equal_unsharded_on_the_card(cuda):
    """A build over a 3-shard mesh of the card, and its staged and fused
    sweeps (each shard's graph replayed on a second sweep), equal the
    unsharded engine's bit for bit; each shard launches both kernels."""
    import dataclasses
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import SweepSpec, run_sweep
    from repro_torch.launch.mesh import make_app_mesh
    mesh = make_app_mesh(devices=["cuda"] * 3)
    base = _fresh_engine()
    for ops in (assign_ops, segment_ops):
        ops.reset_launch_count()
    sharded = _mesh_engine(mesh)
    for ops in (assign_ops, segment_ops):
        assert set(ops.launch_counts_by_shard()) == {0, 1, 2}
    for a, b in zip(base.build(SWEEP_APPS), sharded.build(SWEEP_APPS)):
        for f in ("bbv_labels", "bbv_centroids", "bbv_feats", "rfv_labels",
                  "rfv_centroids", "dg_labels", "census_mat"):
            assert _same_bits(getattr(a, f), getattr(b, f)), f
    for rnd in range(2):
        for scheme, policy in (("rfv", "centroid"), ("bbv", "random")):
            spec = SweepSpec(apps=SWEEP_APPS, selection_seed=rnd,
                             plan=SamplingPlan.from_strings(scheme, policy))
            for s in (spec, dataclasses.replace(spec, fused=False)):
                g, w = run_sweep(sharded, s), run_sweep(base, s)
                assert list(g.column("estimate")) == \
                    list(w.column("estimate"))
            _same_tables(sharded, base)


@pytest.mark.cuda
def test_sharded_trials_equal_unsharded_on_the_card(cuda):
    """Trials over a (2, 2) ``("app", "trial")`` mesh of the card: every
    leaf (the float moments folded in the unsharded block order) and every
    per-trial array bit for bit."""
    from repro_torch.experiments import TrialSpec, run_trials
    from repro_torch.launch.mesh import make_app_trial_mesh
    base = _fresh_engine()
    spec = TrialSpec(trials=4096, chunk_size=1024, keep_trials=True,
                     schemes=("random", "rfv"))
    want = run_trials(base, spec, apps=SWEEP_APPS)
    got = run_trials(base, spec, apps=SWEEP_APPS,
                     mesh=make_app_trial_mesh(2, devices=["cuda"] * 4))
    for s in spec.schemes:
        for g, w in zip(got.stats[s].leaves(), want.stats[s].leaves()):
            assert _same_bits(g, w)
        for f in ("estimates", "errors", "half_widths"):
            assert getattr(got, f)[s].tobytes() == \
                getattr(want, f)[s].tobytes()


# --------------------------------------------------------------- the trainer
TRAIN_ARCHS = ["olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b",
               "seamless-m4t-large-v2"]


def _smoke_lm(arch="llama3.2-3b", seed=1):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import init_params
    cfg = get_config(arch, smoke=True)
    return cfg, init_params(cfg, generator=torch.Generator().manual_seed(seed),
                            device="cpu")


def _card_step_equals_cpu_step(cuda, arch, seq=64, own_grads=False):
    """With ``own_grads`` the card's new parameters are held against the
    CPU's AdamW step on the card's own gradients, with no element exempt,
    instead of against the CPU's whole step."""
    import copy
    from repro_torch.data import make_pipeline
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import GradTransform
    from repro_torch.train.step import make_train_fn

    class Stash(GradTransform):
        def apply(self, grads, ef):
            return grads, grads

    lr = 1e-3
    cfg, cpu_model = _smoke_lm(arch)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    start = copy.deepcopy(cpu_model)
    opt = AdamW(lr=lr, compress=Stash())
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        batch = make_pipeline(cfg, seq, 4, seed=3, device=dev).batch(0)
        _, state, loss = make_train_fn(cfg, opt)(model, opt.init(model),
                                                 batch)
        out[dev] = (float(loss), state.ef)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    want = cpu_model
    if own_grads:
        plain = AdamW(lr=lr)
        plain.apply_({n: g.cpu() for n, g in out["cuda"][1].items()},
                     plain.init(start), start)
        want = start
    for (name, a), b in zip(card_model.named_parameters(), want.parameters()):
        g_cpu, g_card = out["cpu"][1][name], out["cuda"][1][name].cpu()
        assert float((g_card - g_cpu).abs().max()) <= \
            1e-4 * float(g_cpu.abs().max()), name
        a, b = a.detach().cpu(), b.detach()
        far = (a - b).abs() > 1e-4 * b.abs() + lr * 1e-3
        if own_grads:
            assert not bool(far.any()), name
            continue
        near_zero = g_cpu.abs() <= 1e-4 * g_cpu.abs().max()
        assert bool(near_zero[far].all()), name
        assert int(far.sum()) <= 1e-3 * far.numel(), name


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpus(cuda):
    """One float32 smoke-size train step from the same weights and batch:
    loss rtol 1e-4, every gradient within 1e-4 of its leaf's max |g|, the
    new parameters to rtol 1e-4 (plus lr x 1e-3) except elements whose
    gradient lies within 1e-4 of the leaf's max of zero, where Adam's
    first update (about +-lr) may take either sign: at most 0.1 % of a
    leaf."""
    _card_step_equals_cpu_step(cuda, "llama3.2-3b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_train_step_on_the_card_equals_the_cpus(cuda, arch):
    """As the dense family's, for the MoE, hybrid, SSM and enc-dec smoke
    models, on 128 tokens (RWKV-6's chunk loop over two chunks, past the
    hybrid's 64-token window): loss rtol 1e-4, every gradient within
    1e-4 of its leaf's max |g|; the new parameters to rtol 1e-4 (plus lr
    x 1e-3), no element exempt, against the CPU's AdamW step on the
    card's own gradients. (Against the CPU's whole step, RWKV-6's
    ``layers.0.tm.w_lora_a`` parts at 3 elements above 1e-4 of the
    leaf's max |g|: after the clip those gradients lie within a few
    Adam eps, where lr·g/(|g| + eps) is steep in g.)"""
    _card_step_equals_cpu_step(cuda, arch, seq=128, own_grads=True)


@pytest.mark.cuda
def test_flash_attention_refuses_inputs_that_require_grad_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 4, 256, 128), generator=gen, device=cuda,
                    dtype=torch.bfloat16).requires_grad_(True)
    k = torch.randn((1, 2, 256, 128), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    before = flash_ops.launch_count()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q, k, k)
    assert flash_ops.launch_count() == before
    with torch.no_grad():
        flash_ops.flash_attention(q, k, k)
    assert flash_ops.launch_count() == before + 1


def _train_loop_resumes(cuda, tmp_path, arch):
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    cfg = get_config(arch, smoke=True)
    kw = dict(steps=8, batch=4, seq=64, lr=5e-3, ckpt_every=5, device=cuda,
              log=lambda s: None)
    before = flash_ops.launch_count()
    full = train(cfg, ckpt_dir=tmp_path / "a", **kw)
    assert full.losses[7] < full.losses[0]
    train(cfg, ckpt_dir=tmp_path / "b", **kw)
    shutil.rmtree(tmp_path / "b" / "step_7")
    again = train(cfg, ckpt_dir=tmp_path / "b", **kw)
    assert again.start == 5
    for step in range(5, 8):
        assert abs(again.losses[step] - full.losses[step]) <= \
            1e-4 * abs(full.losses[step])
    assert flash_ops.launch_count() == before


@pytest.mark.cuda
def test_launch_train_loop_runs_on_the_card(cuda, tmp_path):
    """The CLI's loop on the card: the loss descends over 8 steps, a run
    resumed from step 4's checkpoint follows the uninterrupted one to rtol
    1e-4 (the reference's bound), and no flash kernel is launched."""
    _train_loop_resumes(cuda, tmp_path, "llama3.2-3b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_launch_train_loop_runs_on_the_card(cuda, tmp_path, arch):
    """As the dense family's, for the MoE, hybrid, SSM and enc-dec smoke
    models."""
    _train_loop_resumes(cuda, tmp_path, arch)


# ----------------------------------------------------- the other LM families
FAMILY_ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
                "rwkv6-7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_the_card_equal_the_cpus(cuda, arch):
    """Each family's smoke model (float32) from the same weights on the
    card and on the CPU: forward logits to rtol/atol 1e-4 — the MoE
    prefill through the float32 flash kernel, the hybrid and SSM with no
    flash launch — and 8 decode steps' logits to 1e-4. An MoE token may
    route otherwise on the card only where the CPU's k-th and (k+1)-th
    router scores lie within 1e-5 relative (counted); its sequence's
    later rows are then not compared."""
    import copy
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import (decode_fn, forward_fn,
                                             init_params, make_decode_state)
    cfg = get_config(arch, smoke=True)
    cpu_model = init_params(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    before = flash_ops.launch_count()
    with moe_mod.record_routing() as card_routes:
        card = forward_fn(cfg)(card_model, {"tokens": toks.to(cuda)}).cpu()
    launched = flash_ops.launch_count() - before
    assert launched == (cfg.n_layers if cfg.family == "moe" else 0)
    with moe_mod.record_routing() as cpu_routes:
        want = forward_fn(cfg)(cpu_model, {"tokens": toks})
    keep_rows = torch.ones(toks.shape, dtype=torch.bool)
    parted = 0
    for rc, rw in zip(card_routes, cpu_routes):
        differ = (rc.expert.cpu().sort(-1).values
                  != rw.expert.sort(-1).values).any(-1)
        assert bool((rw.margin[differ] <= 1e-5).all())
        parted += int(differ.sum())
        first = differ.reshape(toks.shape).int().cummax(-1).values.bool()
        keep_rows &= ~first
    torch.testing.assert_close(card[keep_rows], want[keep_rows], rtol=1e-4,
                               atol=1e-4)
    print(f"{arch}: {parted} routings parted at near-ties")

    caches = {dev: make_decode_state(cfg, 2, 16, device=dev)
              for dev in ("cpu", cuda)}
    for t in range(8):
        got, caches[cuda] = decode_fn(cfg)(card_model, toks[:, t:t + 1].to(
            cuda), caches[cuda], t)
        ref, caches["cpu"] = decode_fn(cfg)(cpu_model, toks[:, t:t + 1],
                                            caches["cpu"], t)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b"] + FAMILY_ARCHS)
def test_serve_loop_on_the_card_equals_the_cpus(cuda, arch):
    """``generate`` on the card, whose steps replay one captured decode
    graph, against the eager loop on the CPU from the same weights
    (float32 smoke size; 79 positions, so the hybrid's 64-slot ring
    wraps): the first generated logits to rtol/atol 1e-4 and every
    row's first token equal; over the 19 greedy steps after it, at most
    one row of four may part (counted), where a float32 rounding flips a
    near-tie argmax and the rows then follow different tokens."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.registry import init_params
    cfg = get_config(arch, smoke=True)
    cpu_model = init_params(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    prompts = make_prompts(cfg, 4, 60, seed=1, device="cpu")
    want = generate(cpu_model, cfg, prompts, gen=20, cache_len=80)
    got = generate(card_model, cfg, prompts.to(cuda), gen=20, cache_len=80)
    torch.testing.assert_close(got.first_logits.cpu(), want.first_logits,
                               rtol=1e-4, atol=1e-4)
    ties = 0
    for row in range(4):
        differ = (got.tokens[row].cpu() != want.tokens[row]).nonzero()
        if len(differ):
            ties += 1
            assert int(differ[0]) > 0, "the first token parted"
    print(f"{arch}: {ties} of 4 rows part at later steps")
    assert ties <= 1


# ------------------------------------------------------- sharded training
def _duck(data):
    import types
    return types.SimpleNamespace(axis_names=("data",), shape={"data": data})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b"] + TRAIN_ARCHS)
def test_sharded_step_on_the_card_equals_the_unsharded(cuda, arch):
    """One float32 smoke-size step of 4 x 128 tokens on the (2, 2) mesh
    naming the card four times against the unsharded step on the card
    under data 2 (the same MoE groups), from the same weights: loss rtol
    1e-5, every gradient within 1e-4 of its leaf's max |g|, and the new
    parameters to rtol 1e-4 (plus lr x 1e-3), no element exempt, against
    the unsharded AdamW step on the sharded step's own gradients (against
    the unsharded whole step, elements whose clipped gradients lie within
    a few Adam eps may part: RWKV-6's ``layers.0.tm.w_lora_a`` does, as
    in the card-vs-CPU step); on the (1, 1) mesh, the unsharded step bit
    for bit. No kernel is launched."""
    import copy
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs)
    from repro_torch.distributed.spmd import ShardedModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import GradTransform
    from repro_torch.train.step import make_train_fn

    class Stash(GradTransform):
        def apply(self, grads, ef):
            return grads, grads

    lr = 1e-3
    cfg, cpu_model = _smoke_lm(arch)
    model = copy.deepcopy(cpu_model).to(cuda)
    batch = make_pipeline(cfg, 128, 4, seed=3, device=cuda).batch(0)
    opt = AdamW(lr=lr, compress=Stash())
    before = flash_ops.launch_count()
    for dp, mp in ((2, 2), (1, 1)):
        mesh = make_host_mesh(mp, devices=[cuda] * (dp * mp))
        plain = copy.deepcopy(model)
        with activation_sharding(_duck(dp)):
            _, pstate, ploss = make_train_fn(cfg, opt)(plain, opt.init(plain),
                                                       batch)
        sm = ShardedModel(copy.deepcopy(model), mesh, param_specs(model, mesh),
                          opt_state_specs(model, mesh))
        with activation_sharding(mesh):
            _, sstate, sloss = make_train_fn(cfg, opt, mesh=mesh)(
                sm, opt.init(sm), batch)
        if dp == 1:
            assert torch.equal(sloss, ploss)
            for (name, a), b in zip(sm.named_parameters(), plain.parameters()):
                assert torch.equal(a, b), name
            continue
        assert abs(float(sloss) - float(ploss)) <= 1e-5 * abs(float(ploss))
        grads = {n: sh.gather(cuda) for n, sh in sstate.ef.items()}
        for name, g in pstate.ef.items():
            assert float((grads[name] - g).abs().max()) <= \
                1e-4 * float(g.abs().max()), name
        own = copy.deepcopy(model)
        plain_opt = AdamW(lr=lr)
        plain_opt.apply_(grads, plain_opt.init(own), own)
        for (name, a), b in zip(sm.named_parameters(), own.parameters()):
            far = (a - b).abs() > 1e-4 * b.abs() + lr * 1e-3
            assert not bool(far.any()), name
    assert flash_ops.launch_count() == before


@pytest.mark.cuda
def test_sharded_bf16_full_width_loop_on_the_card(cuda):
    """``launch.train`` at ``llama3.2-3b``'s full width on 2 of its 28
    layers, bf16, 2 steps of 8 x 1024 on the (2, 2) mesh naming the card
    four times, against the same loop unsharded from the same weights:
    losses rtol 3e-2 (bf16), every weight within the two steps' Adam
    bound of the unsharded run's (twice the lr sum times 1 + 0.1 |w|,
    plus a bf16 unit a step), peak under 80 GB, no kernel launched."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import WARMUP_STEPS, train
    from repro_torch.models.registry import init_params
    from repro_torch.optim import cosine_with_warmup

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    kw = dict(steps=2, batch=8, seq=1024, lr=3e-3, device=cuda,
              log=lambda s: None)
    before = flash_ops.launch_count()
    base = train(cfg, params=copy.deepcopy(params), **kw)
    want = {n: p.detach().float().cpu()
            for n, p in base.params.named_parameters()}
    want_losses = [base.losses[s] for s in range(2)]
    del base
    torch.cuda.reset_peak_memory_stats()
    run = train(cfg, params=params, mesh_devices=[cuda] * 4,
                model_parallel=2, **kw)
    assert torch.cuda.max_memory_allocated() < 80e9
    assert run.params.mesh.shape == {"data": 2, "model": 2}
    schedule = cosine_with_warmup(3e-3, WARMUP_STEPS, 2)
    lr_sum = sum(float(schedule(torch.tensor(s))) for s in (1, 2))
    for name, p in run.params.named_parameters():
        a, b = p.detach().float().cpu(), want[name]
        room = 2 * lr_sum * (1 + 0.1 * b.abs()) + 2 * 2.0 ** -7 * b.abs()
        assert bool(((a - b).abs() <= room).all()), name
    for s in range(2):
        assert abs(run.losses[s] - want_losses[s]) <= 3e-2 * want_losses[s]
    assert flash_ops.launch_count() == before


# -------------------------------------- tensor-parallel compute on "model"
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_collectives_on_the_card(cuda, dtype):
    """Each collective of ``distributed.tp`` on the card against the
    whole-tensor computation it stands for, forward and backward, bit for
    bit (the sums over ranks in rank order, in float32)."""
    from repro_torch.distributed import tp
    from repro_torch.launch.mesh import make_host_mesh

    ranks = 4
    g = tp.Group(make_host_mesh(ranks, devices=[cuda] * ranks))
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    def total(t):
        acc = t[0].float().clone()
        for r in range(1, t.shape[0]):
            acc.add_(t[r])
        return acc.to(t.dtype)

    def run(fn, x):
        x = x.detach().clone().requires_grad_(True)
        y = fn(x)
        gy = randn(*y.shape)
        (gx,) = torch.autograd.grad(y, x, gy)
        return y, gy, gx

    part, partial = randn(ranks, 3, 2, 5), randn(ranks, 3, 2 * ranks, 5)
    whole = torch.cat(list(part), dim=1)
    y, gy, gx = run(lambda x: tp.gather_to_ranks(x, g, 1), part)
    assert all(torch.equal(y[r], whole) for r in range(ranks))
    assert torch.equal(gx, tp.split_ranks(total(gy), 1, ranks))
    y, gy, gx = run(lambda x: tp.scatter_sum(x, g, 1), partial)
    assert torch.equal(y, tp.split_ranks(total(partial), 1, ranks))
    assert all(torch.equal(gx[r], torch.cat(list(gy), 1))
               for r in range(ranks))
    y, gy, gx = run(lambda x: tp.reduce_from_ranks(x, g), partial)
    assert torch.equal(y, total(partial))
    y, gy, gx = run(lambda x: tp.copy_to_ranks(x, g), whole)
    assert torch.equal(gx, total(gy))
    y, gy, gx = run(lambda x: tp.split_to_ranks(x, g, 1), whole)
    assert torch.equal(gx, torch.cat(list(gy), 1))
    y, gy, gx = run(lambda x: tp.gather_from_ranks(x, g, 1), part)
    assert torch.equal(y, whole)
    assert torch.equal(tp.max_from_ranks(partial, g), partial.amax(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dp,mp,over", [
    ("llama3.2-3b", 1, 4, {"n_heads": 6, "n_kv_heads": 2, "vocab": 510}),
    ("olmoe-1b-7b", 2, 4, {}), ("seamless-m4t-large-v2", 1, 4, {})])
def test_tp_step_on_the_card_equals_the_unsharded(cuda, arch, dp, mp, over):
    """One float32 smoke-size tensor-parallel step of 4 x 128 tokens on a
    mesh naming the card dp x mp times (the query-row fallback,
    replicated K/V and sequence-sharded logits for the dense config;
    experts over 4 ranks; the enc-dec model) against the unsharded step
    on the card under data dp: loss rtol 1e-5, every gradient within
    1e-4 of its leaf's max |g|; its layouts are ``constraint_spec``'s.
    No kernel is launched."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs)
    from repro_torch.distributed.spmd import ShardedModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import GradTransform
    from repro_torch.train.step import make_train_fn

    class Stash(GradTransform):
        def apply(self, grads, ef):
            return grads, grads

    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    model = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    batch = make_pipeline(cfg, 128, 4, seed=3, device=cuda).batch(0)
    opt = AdamW(lr=1e-3, compress=Stash())
    before = flash_ops.launch_count()
    plain = copy.deepcopy(model)
    with ctx.activation_sharding(_duck(dp)):
        _, pstate, ploss = make_train_fn(cfg, opt)(plain, opt.init(plain),
                                                   batch)
    mesh = make_host_mesh(mp, devices=[cuda] * (dp * mp))
    sm = ShardedModel(copy.deepcopy(model), mesh, param_specs(model, mesh),
                      opt_state_specs(model, mesh))
    with ctx.activation_sharding(mesh):
        _, sstate, sloss = make_train_fn(cfg, opt, mesh=mesh)(
            sm, opt.init(sm), batch)
        group = sm.last_step["group"]
        for kind, shape, dim in group.layouts:
            spec = ctx.constraint_spec(shape, kind)
            assert dim == next((i for i, e in enumerate(spec)
                                if e == "model"), None), (kind, shape)
    assert abs(float(sloss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    for name, g in pstate.ef.items():
        got = sstate.ef[name].gather(cuda)
        assert float((got - g).abs().max()) <= 1e-4 * float(g.abs().max()), \
            name
    assert flash_ops.launch_count() == before


# ------------------------------- tensor-parallel recurrent blocks, and C.7
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_recurrent_tp_step_on_the_card_equals_the_cpus(cuda, arch):
    """The hybrid's and the SSM's float32 smoke-size step of 4 x 128
    tokens (past the hybrid's 64-token window, two RWKV chunks) on the
    (2, 2) mesh, computed per model rank, on the card against the same
    step on the CPU from the same weights: loss rtol 1e-4, every gradient
    within 1e-4 of its leaf's max |g|, and the new weights within rtol
    1e-4 (plus lr x 1e-3) of the CPU's AdamW step on the card's own
    gradients. No kernel is launched."""
    import copy
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs)
    from repro_torch.distributed.spmd import ShardedModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import GradTransform
    from repro_torch.train.step import make_train_fn

    class Stash(GradTransform):
        def apply(self, grads, ef):
            return grads, grads

    lr = 1e-3
    cfg, cpu_model = _smoke_lm(arch)
    opt = AdamW(lr=lr, compress=Stash())
    batch = make_pipeline(cfg, 128, 4, seed=3, device="cpu").batch(0)
    before = flash_ops.launch_count()
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_host_mesh(2, devices=[dev] * 4)
        model = copy.deepcopy(cpu_model).to(dev)
        sm = ShardedModel(model, mesh, param_specs(model, mesh),
                          opt_state_specs(model, mesh))
        with activation_sharding(mesh):
            _, state, loss = make_train_fn(cfg, opt, mesh=mesh)(
                sm, opt.init(sm), {k: v.to(dev) for k, v in batch.items()})
        assert sm.last_step["group"] is not None
        out[str(dev)] = (float(loss), {
            n: sh.gather("cpu") for n, sh in state.ef.items()}, {
            n: p.detach().cpu() for n, p in sm.named_parameters()})
    (cl, cg, _), (gl, gg, gw) = out["cpu"], out[str(cuda)]
    assert abs(gl - cl) <= 1e-4 * abs(cl)
    for name, g in cg.items():
        assert float((gg[name] - g).abs().max()) <= \
            1e-4 * float(g.abs().max()), name
    own = copy.deepcopy(cpu_model)
    plain = AdamW(lr=lr)
    plain.apply_(gg, plain.init(own), own)
    for name, p in own.named_parameters():
        far = (gw[name] - p.detach()).abs() > 1e-4 * p.detach().abs() \
            + lr * 1e-3
        assert not bool(far.any()), name
    assert flash_ops.launch_count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dp,mp", [("llama3.2-3b", 2, 4),
                                        ("recurrentgemma-2b", 2, 2),
                                        ("rwkv6-7b", 4, 2)])
def test_adamw_on_pieces_is_the_whole_leaf_step_on_the_card(cuda, arch, dp,
                                                           mp):
    """ROADMAP C.7 on the card: from the same random gradients, two
    clipped AdamW steps on the pieces of a mesh naming the card dp x mp
    times (``apply_shards_``, a leaf's pieces as one stack) give the
    whole-leaf step's weights (``apply_``) bit for bit, with and without
    int8 compression (the clip norm sums each gradient leaf gathered
    whole, as the whole-leaf step sums it)."""
    import copy
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW, Int8EF

    _, cpu_model = _smoke_lm(arch)
    model = copy.deepcopy(cpu_model).to(cuda)
    mesh = make_host_mesh(mp, devices=[cuda] * (dp * mp))
    gen = torch.Generator(device=cuda).manual_seed(5)
    for compress in (None, Int8EF()):
        opt = AdamW(lr=1e-2, clip_norm=1.0, compress=compress)
        plain = copy.deepcopy(model)
        sm = spmd.ShardedModel(copy.deepcopy(model), mesh,
                               param_specs(model, mesh),
                               opt_state_specs(model, mesh))
        pstate, sstate = opt.init(plain), opt.init(sm)
        for _ in range(2):
            grads = {n: torch.randn(p.shape, generator=gen, device=cuda)
                     * 3 for n, p in plain.named_parameters()}
            pieces = {n: spmd.Sharded.place(g, sm.moment_layouts[n])
                      for n, g in grads.items()}
            pstate = opt.apply_(grads, pstate, plain)
            sstate = opt.apply_shards_(pieces, sstate, sm)
            for (name, a), b in zip(sm.named_parameters(),
                                    plain.parameters()):
                assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_traced_and_real_flops_are_equal_on_the_card(cuda, kind):
    """The cost model's trace (fake CUDA tensors on the card's program)
    and the same program run on the card, both under ``CostMode``: equal
    FLOPs, the prefill's through the flash kernel (its formula counted
    once a real launch); a trace launches nothing."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.device import tracing
    from repro_torch.launch.cost_analysis import CostMode
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_prefill_fn, make_train_fn
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              dtype=torch.bfloat16)

    before = flash_ops.launch_count()
    with tracing("cuda") as dev:
        assert dev.type == "cuda"
        params = init_params(cfg, device=dev, abstract=True)
        toks = torch.zeros((4, 256), dtype=torch.int32, device=dev)
        opt = AdamW(lr=1e-3)
        state = opt.init(params, abstract=True)
        run = (lambda: make_prefill_fn(cfg)(params, {"tokens": toks})) \
            if kind == "prefill" else (lambda: make_train_fn(
                cfg, opt, microbatches=2)(params, state,
                                         {"tokens": toks, "labels": toks}))
        with CostMode() as fake:
            run()
    assert flash_ops.launch_count() == before
    params = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 256), dtype=torch.int32,
                         device=cuda)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    run = (lambda: make_prefill_fn(cfg)(params, {"tokens": toks})) \
        if kind == "prefill" else (lambda: make_train_fn(
            cfg, opt, microbatches=2)(params, state,
                                     {"tokens": toks, "labels": toks}))
    with CostMode() as real:
        run()
    flash = cfg.n_layers if kind == "prefill" else 0
    assert flash_ops.launch_count() == before + flash
    assert real.trace.calls("repro_torch.flash_attention") \
        == fake.trace.calls("repro_torch.flash_attention") == flash
    assert real.trace.flops == fake.trace.flops


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dp,mp,rows,s_max,overrides", [
    pytest.param("llama3.2-3b", 2, 2, 4, 32, {}, id="llama3.2-3b"),
    pytest.param("rwkv6-7b", 2, 2, 4, 32, {}, id="rwkv6-7b"),
    pytest.param("llama3.2-3b", 1, 3, 4, 96, {}, id="llama3.2-3b-seq"),
    pytest.param("rwkv6-7b", 1, 4, 4, 32, {"rwkv_head_dim": 128},
                 id="rwkv6-7b-value-width"),
    pytest.param("rwkv6-7b", 2, 1, 1, 32, {}, id="rwkv6-7b-batch-1")])
def test_sharded_serving_on_the_card_equals_the_unsharded(
        cuda, arch, dp, mp, rows, s_max, overrides):
    """The sharded prefill and three sharded decode steps on a mesh
    naming the card, float32 at smoke size, against the unsharded steps
    on the card: logits within 1e-4, tokens equal, every cache leaf
    within 1e-4 of its largest magnitude after each step. (2, 2): the caches by
    heads; (1, 3): the KV caches by sequence; two RWKV heads of 128 on
    (1, 4): the state by value width; one row on (2, 1): every data rank
    computes it (no prefill: the sharded prefill refuses rows the data
    ranks do not divide), each rank's tokens equal."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import cache_specs, param_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import init_params, make_decode_state
    from repro_torch.train.step import make_prefill_fn, make_serve_fn
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    params = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(1))
    mesh = make_host_mesh(mp, devices=["cuda:0"] * (dp * mp))
    specs = param_specs(params, mesh, serving=True)
    model = spmd.ShardedModel(copy.deepcopy(params), mesh, specs, specs)
    toks = torch.randint(0, cfg.vocab, (rows, 128), dtype=torch.int32,
                         device=cuda)
    if rows % dp == 0:
        want = make_prefill_fn(cfg, backend="plain")(params,
                                                     {"tokens": toks})
        got = make_prefill_fn(cfg, mesh=mesh)(model, {"tokens": toks})
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    caches = make_decode_state(cfg, rows, s_max)
    whole = copy.deepcopy(caches)
    sharded = spmd.ShardedCaches(whole, cache_specs(cfg, whole, mesh), mesh)
    if overrides:
        assert sharded.model_dims[0] == 4
    elif mp == 3:
        assert sharded.model_dims[0] == 3
    plain, step = make_serve_fn(cfg), make_serve_fn(cfg, mesh=mesh)
    for t in range(3):
        nu, caches = plain(params, toks[:, t:t + 1], caches, t)
        ns, _ = step(model, toks[:, t:t + 1], sharded, t)
        assert torch.equal(ns, nu)
        assert model.last_step["data_ranks"] == dp
        for got in model.last_step["tokens"][1:] if rows % dp else ():
            assert torch.equal(got, ns[:, 0])
        leaves = [[leaf for f in tree if f is not None
                   for leaf in (f if isinstance(f, tuple) else (f,))]
                  for tree in (sharded.gather(), caches)]
        for g, w in zip(*leaves):
            scale = max(float(w.float().abs().max()), 1.0)
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
