"""The port's flash-attention wrapper and attention routes against the
reference's, on the CPU.

On the CPU the wrapper runs its plain version (``flash_attention_ref``);
these tests hold it against the reference's Pallas kernel run in
interpret mode (as ``tests/test_kernels.py`` runs it) and against the
reference's oracle ``attention_ref`` with repeated kv heads, at the five
shapes of that test in both types. The model's CPU attention route
(``models.attention._attend``: ``attention_ref``, or the streaming
``_attend_chunked`` past 2048 keys) is held against the reference's
``_attend`` (the non-causal branch and ``mha_attend``:
``tests/test_torch_encdec.py``). Tolerances are the reference test's: 2e-3 in float32, 3e-2
in bf16 (atol and rtol). The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as port_attention
from repro_torch.models.convert import tensor_from_numpy

SHAPES = [(1, 4, 2, 256, 256, 64), (2, 8, 4, 300, 300, 32),
          (1, 4, 1, 1, 512, 64), (1, 2, 2, 1, 700, 128),
          (1, 4, 4, 512, 512, 128)]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _inputs(shape, dtype, seed):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.normal(size=s), DTYPES[dtype])
              for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    return arrays, [tensor_from_numpy(np.asarray(a)) for a in arrays]


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("against", ["pallas_interpret", "attention_ref"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_flash_matches_reference(shape, dtype, against):
    (q, k, v), (tq, tk, tv) = _inputs(shape, dtype, seed=sum(shape))
    before = ops.launch_count()
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert ops.launch_count() == before       # the CPU takes the plain one
    if against == "pallas_interpret":
        want = jax_flash(q, k, v)
    else:
        group = shape[1] // shape[2]
        want = jax_ref(q, jnp.repeat(k, group, axis=1),
                       jnp.repeat(v, group, axis=1), causal=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("shape", [(1, 4, 2, 300, 300, 64),
                                   (1, 2, 1, 2100, 2100, 32),
                                   (1, 2, 2, 40, 2100, 32)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_model_cpu_route_matches_reference(shape, dtype):
    """Past 2048 keys both take the streaming-softmax route."""
    (q, k, v), (tq, tk, tv) = _inputs(shape, dtype, seed=shape[4])
    want = jax_attention._attend(q, k, v, window=None)
    got = port_attention._attend(tq, tk, tv, window=None)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", ["non_causal", "sq_gt_skv", "heads",
                                  "d_over_128", "d_not_8"])
def test_flash_wrapper_raises(case):
    """Bad shapes raise ``ValueError`` on both branches: a causal call
    with sq > skv, and (``non_causal``, which otherwise takes any sq) a
    call with no key column."""
    b, hq, hkv, sq, skv, d = {"non_causal": (1, 2, 2, 8, 0, 64),
                              "sq_gt_skv": (1, 2, 2, 9, 8, 64),
                              "heads": (1, 3, 2, 8, 8, 64),
                              "d_over_128": (1, 2, 2, 8, 8, 136),
                              "d_not_8": (1, 2, 2, 8, 8, 60)}[case]
    q = torch.zeros((b, hq, sq, d))
    kv = torch.zeros((b, hkv, skv, d))
    with pytest.raises(ValueError):
        ops.flash_attention(q, kv, kv, causal=case != "non_causal")


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__2ba04ffe_23_flash_attention_sm90_cu_6107570414flash_fwd_sm90ILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16xxxiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__2ba04ffe_23_flash_attention_sm90_cu_6107570414flash_fwd_sm90ILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16xxxiiiiiif
    0 bytes stack frame, 24 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__2ba04ffe_23_flash_attention_sm90_cu_6107570414flash_fwd_sm90ILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16xxxiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__2ba04ffe_23_flash_attention_sm90_cu_6107570414flash_fwd_sm90ILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16xxxiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
"""


def test_variants_parse_ptxas_report():
    """The P hi/lo against single-rounded P comparison reads registers
    and spills per ``flash_fwd_sm90<DP>`` instance from ``ptxas -v``."""
    from repro_torch.kernels.flash_attention.variants import parse_ptxas
    assert parse_ptxas(_PTXAS_LOG) == {
        "128": {"registers": 168, "spill_stores": 24, "spill_loads": 40},
        "64": {"registers": 168, "spill_stores": 0, "spill_loads": 0}}



# ---------------------------------------------------------------- layout
def _projection_views(shape, dtype, seed):
    """q, k, v as the model makes them: ``(b, s, h, d)`` tensors viewed
    ``(b, h, s, d)``; and contiguous copies of the same values."""
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    views = [torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
        np.float32)).to(dtype).transpose(1, 2)
        for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    return views, [t.contiguous() for t in views]


@pytest.mark.parametrize("shape", [(1, 4, 2, 256, 256, 64),
                                   (2, 6, 2, 130, 300, 40),
                                   (1, 3, 1, 7, 200, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_views_equal_contiguous_bitwise(shape, dtype):
    """The projections' layout, read in place, gives the same bits as
    contiguous inputs; the output is the (b, hq, sq, d) view of a
    contiguous (b, sq, hq, d) tensor."""
    views, flat = _projection_views(shape, dtype, seed=sum(shape))
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views)
    want = ops.flash_attention(*flat)
    assert torch.equal(got, want)
    assert got.shape == views[0].shape and got.dtype == dtype
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("case", ["last_dim_strided", "row_stride_not_8",
                                  "head_stride_not_8", "unaligned_base"])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_wrapper_rejects_layout(case, which):
    b, h, s, d = 1, 2, 16, 64
    base = torch.zeros((b, h, s, d))
    if case == "last_dim_strided":
        bad = torch.zeros((b, h, s, 2 * d))[..., ::2]
    elif case == "row_stride_not_8":
        bad = torch.zeros((b, h, s, d + 4))[..., :d]
    elif case == "head_stride_not_8":
        bad = torch.zeros((b, h, s * d + 4))[..., :s * d].reshape(b, h, s, d)
    else:
        bad = torch.zeros(b * h * s * d + 2)[2:].reshape(b, h, s, d)
    args = {"q": base, "k": base, "v": base}
    args[which] = bad
    assert bad.shape == base.shape
    with pytest.raises(ValueError):
        ops.flash_attention(args["q"], args["k"], args["v"])


def test_tensor_map_args_prefill_layout():
    """The LM's prefill q: (4, 4096, 24, 128) bf16 viewed (b, h, s, d)."""
    q = torch.empty((4, 4096, 24, 128), dtype=torch.bfloat16).transpose(1, 2)
    dims, strides, box = ops.tensor_map_args(q.shape, q.stride())
    assert dims == (128, 24, 4096, 4)
    assert strides == (128 * 2, 24 * 128 * 2, 4096 * 24 * 128 * 2)
    assert box == (64, 1, 128, 1)


@pytest.mark.parametrize("bshd,contiguous_bhsd,box_cols", [
    ((1, 300, 3, 40), False, 64), ((2, 130, 8, 8), False, 32),
    ((3, 1, 4, 32), False, 32), ((1, 700, 1, 128), True, 64),
    ((2, 5, 6, 72), True, 64)])
def test_tensor_map_args_ragged(bshd, contiguous_bhsd, box_cols):
    """Ragged lengths and widths: every byte stride is a positive multiple
    of 16 (size-1 dimensions take a contiguous tensor's stride), and the
    map addresses the same element as the tensor's own strides."""
    b, s, h, d = bshd
    t = torch.empty(bshd, dtype=torch.bfloat16).transpose(1, 2)
    if contiguous_bhsd:
        t = t.contiguous()
    dims, strides, box = ops.tensor_map_args(t.shape, t.stride())
    assert dims == (d, h, s, b)
    assert box == (box_cols, 1, 128, 1)
    assert all(st > 0 and st % 16 == 0 for st in strides)
    for size, st, own in zip((h, s, b), strides,
                             (t.stride(1), t.stride(2), t.stride(0))):
        if size > 1:
            assert st == 2 * own


def _emulate_bf16_kernel(q, k, v, *, split: bool, tile: int = 128):
    """The bf16 kernel's arithmetic, in float32 on the CPU: 128-key tiles;
    S from the bf16 operands, summed in float32; online softmax in the
    log2 domain; P rounded to bf16 hi (and, with ``split``, its residual
    to bf16 lo), each times V summed in float32; l from the float32 P.
    Returns the float32 output before its bf16 rounding."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale_log2 = torch.tensor(1.0 / math.sqrt(d) * math.log2(math.e),
                              dtype=torch.float32)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    rows = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for kv0 in range(0, skv, tile):
        kt, vt = kf[:, :, kv0:kv0 + tile], vf[:, :, kv0:kv0 + tile]
        x = torch.matmul(qf, kt.transpose(-1, -2)) * scale_log2
        cols = kv0 + torch.arange(kt.shape[2])[None, :]
        x = torch.where(cols <= rows, x, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.matmul(hi, vt)
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            acc = acc + torch.matmul(lo, vt)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)


def test_bf16_kernel_arithmetic_within_tolerance(record_property):
    """At (1, 2/1, 2048, 64) the hi/lo split of P stays within 0.1 of the
    card's bf16 tolerance against the plain version (both before the
    output's bf16 rounding); the single-rounded P's share is recorded."""
    rng = np.random.default_rng(2048)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((1, 2, 2048, 64), (1, 1, 2048, 64),
                         (1, 1, 2048, 64)))
    want = flash_attention_ref(q.float(), k.float(), v.float())
    rtol, atol = 8e-3, 1e-3
    share = {}
    for split in (True, False):
        got = _emulate_bf16_kernel(q, k, v, split=split)
        share[split] = float(((got - want).abs()
                              / (atol + rtol * want.abs())).max())
    record_property("hi_lo_share", share[True])
    record_property("single_rounded_share", share[False])
    print(f"share of the bf16 tolerance: hi/lo split {share[True]:.4g}, "
          f"single-rounded P {share[False]:.4g}")
    assert share[True] <= 0.1
    assert share[True] < share[False]
