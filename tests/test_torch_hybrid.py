"""The port's hybrid family (RG-LRU + local attention) against the
reference's, on the CPU.

``recurrentgemma-2b`` at smoke size (6 layers: two (R, R, A) supers and
no tail, d_model 256, rnn_width 256, window 64, MQA, float32), weights
drawn by the reference and carried over by ``params_from_numpy``, tokens
from numpy (``tests/lm_family_checks.py``); a 7-layer variant adds a
tail layer.

Tolerances: float32 logits, losses, decode steps and caches to rtol/atol
1e-4 (the log-depth scan associates the recurrence's products otherwise
than XLA's ``associative_scan``, a float32 rounding apart); the bf16
variant to 3e-2. The ring buffer's positions are exact; greedy serve
tokens exact except counted near-ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.configs import get_config as jax_get_config
from repro.models import rglru as jax_rglru
from repro.models.common import KeyGen
from repro_torch.configs import get_config
from repro_torch.models import rglru as port_rglru
from repro_torch.models import registry as TR
from repro_torch.models.convert import tensor_from_numpy

ARCH = "recurrentgemma-2b"


@pytest.mark.parametrize("smoke_size", [True, False])
def test_config_matches_reference(smoke_size):
    F.check_config(ARCH, smoke_size)


@pytest.mark.parametrize("n_layers", [6, 7])
def test_forward_and_loss_match_reference(n_layers, monkeypatch):
    if n_layers != 6:
        _with_layers(monkeypatch, n_layers)
    F.check_forward_and_loss(ARCH)


def _with_layers(monkeypatch, n_layers):
    """Both packages' smoke config with ``n_layers`` (7: a tail layer)."""
    import repro.configs.base as jb
    import repro_torch.configs.base as tb
    for base in (jb, tb):
        entry = dict(base._REGISTRY[ARCH])
        smoke = entry["smoke"]
        entry["smoke"] = (lambda s=smoke: dataclasses.replace(
            s(), n_layers=n_layers))
        monkeypatch.setitem(base._REGISTRY, ARCH, entry)


def test_decode_steps_match_reference():
    F.check_decode(ARCH)


@pytest.mark.parametrize("s_max", [128, 40])
def test_decode_wraps_the_ring_buffer(s_max):
    """90 steps past the window of 64: with ``s_max`` 128 the ring holds
    64 slots and wraps; with 40 it holds 40, fewer than the window, and
    wraps twice. Logits each step, then the caches and ring positions."""
    caches = F.check_decode(ARCH, steps=90, s_max=s_max, seed=6)
    win = min(64, s_max)
    assert caches.kv[0].shape[3] == win
    want = np.full(win, -1)
    for pos in range(90):
        want[pos % win] = pos
    for rp in caches.ring_pos:
        np.testing.assert_array_equal(rp.numpy(), want)


def test_decode_with_a_tail_matches_reference(monkeypatch):
    _with_layers(monkeypatch, 7)
    F.check_decode(ARCH, steps=8)


def test_serve_loop_greedy_tokens_match_reference():
    F.check_serve(ARCH)


def test_port_decode_matches_port_forward():
    """Teacher-forced decode equals the parallel forward, past the window
    (80 tokens, window 64)."""
    F.check_decode_matches_forward(ARCH, seq=80)


def test_bf16_forward_matches_reference():
    F.check_bf16_forward(ARCH)


def test_params_round_trip():
    F.check_round_trip(ARCH)


def test_init_scales_follow_reference():
    F.check_init_scales(ARCH)


def test_decode_takes_one_token_a_step():
    ct = get_config(ARCH, smoke=True)
    model = TR.init_params(ct, device="cpu")
    caches = TR.make_decode_state(ct, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        TR.decode_fn(ct)(model, torch.zeros((1, 2), dtype=torch.long),
                         caches, 0)


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 300, 16))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 300, 16)).astype(np.float32))
    h, want = torch.zeros(2, 16), []
    for t in range(300):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(port_rglru.linear_scan(a, b),
                               torch.stack(want, dim=1), rtol=1e-5,
                               atol=1e-5)


def _rglru_pair(seed=2):
    cfg = jax_get_config(ARCH, smoke=True)
    params = jax_rglru.init_rglru(cfg, KeyGen(jax.random.PRNGKey(seed),
                                              False))
    port = port_rglru.RGLRU(get_config(ARCH, smoke=True), device="cpu")
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(tensor_from_numpy(np.asarray(params[name])))
    return cfg, params, port


def test_rglru_block_from_a_carried_state_matches_reference():
    """The prefill form from a nonzero state (h0 folded into the first
    element, the conv carry), and a step after it."""
    cfg, params, port = _rglru_pair()
    rng = np.random.default_rng(4)
    b, s, w = 2, 48, cfg.rnn_width
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32) * 0.3
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    c0 = rng.normal(size=(b, 3, w)).astype(np.float32)
    out_j, st_j = jax_rglru.rglru_block(
        params, jnp.asarray(x), cfg,
        jax_rglru.RglruState(jnp.asarray(h0), jnp.asarray(c0)))
    ct = get_config(ARCH, smoke=True)
    out_t, st_t = port_rglru.rglru_block(
        port, torch.from_numpy(x), ct,
        port_rglru.RglruState(torch.from_numpy(h0), torch.from_numpy(c0)))
    F.close(out_t, out_j)
    F.close(st_t.h, st_j.h)
    F.close(st_t.conv, st_j.conv)
    x1 = x[:, :1] * 2
    out_j, st_j = jax_rglru.rglru_step(params, jnp.asarray(x1), cfg, st_j)
    out_t, st_t = port_rglru.rglru_step(port, torch.from_numpy(x1), ct,
                                        st_t)
    F.close(out_t, out_j)
    F.close(st_t.h, st_j.h)
