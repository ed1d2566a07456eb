"""The port's MoE trainer against the reference's, on the CPU.

``olmoe-1b-7b`` at smoke size (4 layers, d_model 256, 8 experts, top-2,
float32; bf16 where named), batches of 4 x 64 tokens, lr 1e-3: the
reference draws the weights (``PRNGKey(0)``) and the port takes them
through ``params_from_numpy`` (``tests/lm_family_checks.py``, whose
training section holds the checks).

Tolerances, and why:

* float32, at 1 and 2 microbatches, three AdamW steps, each port step
  started from the reference's state before it: losses rtol 1e-5; every
  gradient within 1e-4 of its leaf's max |g| (the backward of the
  sort-based routing, the ``(e, cap)`` gather and the combine, summed in
  other orders); the weights within 3·lr·1e-3, except elements at a
  near-zero gradient, where Adam's first update may take either sign
  (``check_train_steps``); the port's free run's losses rtol 1e-5;
* bf16, one step against the reference's compiled step: loss 3e-2 (the
  family's serving tolerance), each weight within a flipped Adam step,
  at most 10 % of a leaf past one bf16 unit (``check_bf16_step``);
* remat on and off: bitwise;
* checkpoints: a reference float32 checkpoint resumes to the reference's
  next loss at rtol 1e-5; a port checkpoint restores in the reference
  bitwise, with the reference's keys;
* routing in the training forward: each layer's routing from each
  package's own scores is the reference's (experts exactly, gates 1e-6,
  slots and drops exactly up to the first near-tie), except tokens at a
  near-tie (two of the top k+1 scores within 1e-5 relative), which are
  counted and printed. The gradient check above makes no exception for
  them: it holds every leaf, so a near-tie broken the other way than the
  reference broke it would fail it there, not be excused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.data.synthetic import make_pipeline as jax_make_pipeline
from repro.models import attention as jax_attention
from repro.models import transformer as JT
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.data import make_pipeline
from repro_torch.models import moe as port_moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW
from repro_torch.train.step import make_train_fn

ARCH = "olmoe-1b-7b"


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    F.check_train_steps(ARCH, microbatches)


def test_bf16_train_step_matches_reference():
    F.check_bf16_step(ARCH)


def test_remat_on_equals_off_bitwise():
    F.check_remat_bitwise(ARCH)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    F.check_reference_checkpoint_resumes(ARCH, tmp_path)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    F.check_port_checkpoint_restores(ARCH, tmp_path)


def _reference_layer_scores(cfg, params, tokens):
    """The reference's float32 router scores ``(t, e)`` at each MoE
    layer of its forward, run op by op on each layer's slice."""
    x = params["embed"][jnp.asarray(tokens)]
    positions = jnp.arange(x.shape[1])
    layers = params["layers"]
    scores = []
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda a, i=i: a[i], layers)
        h = jax_rms_norm(x, layer["ln1"], cfg.norm_eps)
        xa = x + jax_attention.attention(layer["attn"], h, cfg, positions)
        h2 = jax_rms_norm(xa, layer["ln2"], cfg.norm_eps)
        scores.append(np.asarray((h2.reshape(-1, cfg.d_model)
                                  @ layer["ffn"]["router"]
                                  ).astype(jnp.float32)))
        x = JT._block_fwd(cfg, layer, x, positions)
    return scores


@pytest.mark.parametrize("microbatches", [1, 2])
def test_training_routing_matches_reference(microbatches):
    """The routings a train step's forward makes (one a layer and
    microbatch: the backward's rematerialised layers log none) against
    the reference's from its own scores, near-ties counted."""
    cj, ct = F.train_configs(ARCH)
    pj, tree = F.reference_weights(cj)
    model = params_from_numpy(ct, tree, device="cpu")
    opt = AdamW(lr=F.TRAIN_LR)
    batch = make_pipeline(ct, F.TRAIN_SEQ, F.TRAIN_BATCH,
                          device="cpu").batch(0)
    with port_moe.record_routing() as log:
        make_train_fn(ct, opt, microbatches=microbatches)(
            model, opt.init(model), batch)
    assert len(log) == ct.n_layers * microbatches
    toks = jax_make_pipeline(cj, F.TRAIN_SEQ, F.TRAIN_BATCH).batch(0)[
        "tokens"]
    np.testing.assert_array_equal(np.asarray(toks), batch["tokens"].numpy())
    per = F.TRAIN_BATCH // microbatches
    ties_seen = dropped = 0
    for m in range(microbatches):
        part = np.asarray(toks)[m * per:(m + 1) * per]
        for layer, scores in enumerate(_reference_layer_scores(cj, pj,
                                                               part)):
            got = log[m * ct.n_layers + layer]
            want = F.reference_routing(scores, cj)
            ties = F.near_ties(scores, cj.moe_topk)
            F.assert_routing(got, want, ties)
            ties_seen += int(ties.sum())
            dropped += int((~want[3]).sum())
    print(f"{ARCH} training routing, {microbatches} microbatch(es): "
          f"{ties_seen} token-layers at a near-tie; {dropped} pairs "
          "dropped for capacity")


def test_dropped_pairs_get_no_gradient():
    """A pair past its expert's capacity adds nothing: with one expert
    overflowing, the gate of every dropped pair has a zero gradient and
    the expert rows of no dropped pair are read (their gradient is the
    kept pairs' alone)."""
    cj, ct = F.train_configs(ARCH)
    _, tree = F.reference_weights(cj)
    layer = params_from_numpy(ct, tree, device="cpu").layers[0].ffn
    with torch.no_grad():
        layer.router[:, 3] += 0.5              # expert 3 overflows
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 48, ct.d_model)).astype(np.float32))
    r = port_moe.route(layer, x, ct)
    assert int((~r.keep).sum()) > 0
    gate = r.gate.detach().requires_grad_(True)
    e, d = ct.moe_experts, ct.d_model
    ye = torch.randn((e, r.cap, d), generator=torch.Generator()
                     .manual_seed(0), requires_grad=True)
    routed = port_moe.Routing(r.expert, gate, r.slot, r.keep, r.cap,
                              r.margin)
    out = port_moe.combine(ye, routed)
    g_gate, g_ye = torch.autograd.grad(out.square().sum(), (gate, ye))
    assert torch.all(g_gate[~r.keep] == 0)
    assert torch.all(g_gate[r.keep] != 0)
    used = torch.zeros((e, r.cap), dtype=torch.bool)
    used[r.expert[r.keep], r.slot[r.keep]] = True
    assert torch.all(g_ye[~used] == 0) and torch.all(
        g_ye[used].abs().sum(-1) > 0)
