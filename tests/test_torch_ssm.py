"""The port's SSM family (RWKV-6) against the reference's, on the CPU.

``rwkv6-7b`` at smoke size (4 layers, d_model 256, 8 heads of 32,
float32), weights drawn by the reference and carried over by
``params_from_numpy``, tokens from numpy (``tests/lm_family_checks.py``).

Tolerances: float32 logits, losses, decode steps and states to rtol/atol
1e-4; the bf16 variant to 3e-2; the port's chunked form against its own
step form to the reference's own bound for that pair
(``tests/test_models.py``: rtol 1e-3, atol 1e-4). Greedy serve tokens
exact except counted near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.configs import get_config as jax_get_config
from repro.models import rwkv6 as jax_rwkv
from repro.models.common import KeyGen
from repro_torch.configs import get_config
from repro_torch.models import registry as TR
from repro_torch.models import rwkv6 as port_rwkv
from repro_torch.models.convert import tensor_from_numpy

ARCH = "rwkv6-7b"


@pytest.mark.parametrize("smoke_size", [True, False])
def test_config_matches_reference(smoke_size):
    F.check_config(ARCH, smoke_size)


def test_forward_and_loss_match_reference():
    F.check_forward_and_loss(ARCH, seq=128)


def test_decode_steps_match_reference():
    F.check_decode(ARCH)


def test_serve_loop_greedy_tokens_match_reference():
    F.check_serve(ARCH)


def test_port_decode_matches_port_forward():
    F.check_decode_matches_forward(ARCH, seq=128)


def test_bf16_forward_matches_reference():
    F.check_bf16_forward(ARCH)


def test_params_round_trip():
    F.check_round_trip(ARCH)


def test_init_scales_follow_reference():
    F.check_init_scales(ARCH)


def _time_mix_pair(seed=1):
    cfg = jax_get_config(ARCH, smoke=True)
    params = jax_rwkv.init_rwkv_time_mix(
        cfg, KeyGen(jax.random.PRNGKey(seed), False))
    port = port_rwkv.RwkvTimeMix(get_config(ARCH, smoke=True), device="cpu")
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(tensor_from_numpy(np.asarray(params[name])))
    return cfg, params, port


def _state(rng, b, cfg, scale):
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return (rng.normal(size=(b, h, dh, dh)).astype(np.float32) * scale,
            rng.normal(size=(b, cfg.d_model)).astype(np.float32) * scale)


@pytest.mark.parametrize("carried", [False, True])
def test_chunked_equals_step(carried):
    """As ``tests/test_models.py`` holds the reference (b 2, s 96, chunk
    32), here from a zero or a carried state: the chunked form's output
    and state against 96 single steps."""
    _, _, port = _time_mix_pair()
    ct = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    b, s = 2, 96
    x = torch.from_numpy(rng.normal(size=(b, s, ct.d_model))
                         .astype(np.float32) * 0.5)
    s0, x0 = _state(rng, b, ct, 0.5 if carried else 0.0)
    st0 = port_rwkv.RwkvState(torch.from_numpy(s0), torch.from_numpy(x0))
    out_c, st_c = port_rwkv.rwkv_time_mix_chunked(port, x, ct, st0,
                                                  chunk=32)
    st, outs = st0, []
    for t in range(s):
        o, st = port_rwkv.rwkv_time_mix_step(port, x[:, t:t + 1], ct, st)
        outs.append(o)
    torch.testing.assert_close(out_c, torch.cat(outs, dim=1), rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(st_c.s, st.s, rtol=1e-3, atol=1e-4)
    assert torch.equal(st_c.x_prev, st.x_prev)


def test_chunked_from_a_carried_state_matches_reference():
    cfg, params, port = _time_mix_pair(seed=3)
    ct = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 128, cfg.d_model)).astype(np.float32) * 0.5
    s0, x0 = _state(rng, 2, cfg, 0.5)
    out_j, st_j = jax_rwkv.rwkv_time_mix_chunked(
        params, jnp.asarray(x), cfg,
        jax_rwkv.RwkvState(jnp.asarray(s0), jnp.asarray(x0)))
    out_t, st_t = port_rwkv.rwkv_time_mix_chunked(
        port, torch.from_numpy(x), ct,
        port_rwkv.RwkvState(torch.from_numpy(s0), torch.from_numpy(x0)))
    F.close(out_t, out_j)
    F.close(st_t.s, st_j.s)
    F.close(st_t.x_prev, st_j.x_prev)


def test_prefill_needs_whole_chunks_and_decode_one_token():
    ct = get_config(ARCH, smoke=True)
    model = TR.init_params(ct, device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TR.forward_fn(ct)(model, {"tokens": torch.zeros((1, 50),
                                                        dtype=torch.long)})
    caches = TR.make_decode_state(ct, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        TR.decode_fn(ct)(model, torch.zeros((1, 2), dtype=torch.long),
                         caches, 0)
