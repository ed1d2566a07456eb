"""The port's flash-attention wrapper and attention routes against the
reference's, on the CPU.

On the CPU the wrapper runs its plain version (``flash_attention_ref``);
these tests hold it against the reference's Pallas kernel run in
interpret mode (as ``tests/test_kernels.py`` runs it) and against the
reference's oracle ``attention_ref`` with repeated kv heads, at the five
shapes of that test in both types. The model's CPU attention route
(``models.attention._attend``: ``attention_ref``, or the streaming
``_attend_chunked`` past 2048 keys) is held against the reference's
``_attend``. Tolerances are the reference test's: 2e-3 in float32, 3e-2
in bf16 (atol and rtol). The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention import ops
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
    b, hq, hkv, sq, skv, d = {"sq_gt_skv": (1, 2, 2, 9, 8, 64),
                              "heads": (1, 3, 2, 8, 8, 64),
                              "d_over_128": (1, 2, 2, 8, 8, 136),
                              "d_not_8": (1, 2, 2, 8, 8, 60)}.get(
        case, (1, 2, 2, 8, 8, 64))
    q = torch.zeros((b, hq, sq, d))
    kv = torch.zeros((b, hkv, skv, d))
    with pytest.raises(NotImplementedError if case == "non_causal"
                       else ValueError):
        ops.flash_attention(q, kv, kv, causal=case != "non_causal")


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__20936d09_18_flash_attention_cu_3a0ef7b99flash_fwdILi128E13__nv_bfloat16EEvPKT0_S4_S4_PS2_iiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__20936d09_18_flash_attention_cu_3a0ef7b99flash_fwdILi128E13__nv_bfloat16EEvPKT0_S4_S4_PS2_iiiiif
    32 bytes stack frame, 36 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__20936d09_18_flash_attention_cu_3a0ef7b99flash_fwdILi64EfEEvPKT0_S3_S3_PS1_iiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__20936d09_18_flash_attention_cu_3a0ef7b99flash_fwdILi64EfEEvPKT0_S3_S3_PS1_iiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
"""


def test_variants_parse_ptxas_report():
    """The register-budget comparison reads registers and spills per
    ``flash_fwd<DP, T>`` instance from ``ptxas -v``."""
    from repro_torch.kernels.flash_attention.variants import parse_ptxas
    assert parse_ptxas(_PTXAS_LOG) == {
        "128/bf16": {"registers": 128, "spill_stores": 36,
                     "spill_loads": 64},
        "64/f32": {"registers": 127, "spill_stores": 0, "spill_loads": 0}}
