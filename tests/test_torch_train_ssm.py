"""The port's SSM (RWKV-6) trainer against the reference's, on the CPU.

``rwkv6-7b`` at smoke size (4 layers, d_model 256, 8 heads of 32,
float32; bf16 where named), lr 1e-3. The train steps, float32 and bf16,
take batches of 4 x 128 tokens: two 64-token chunks, so the second
chunk's outputs read the state the first one leaves and the backward
runs through the chunk loop's carried state (at 64 tokens the state
starts at zero and its last value never reaches the loss); the remat
and checkpoint checks take 4 x 64. The reference draws the weights
(``PRNGKey(0)``), the port takes them through ``params_from_numpy``
(``tests/lm_family_checks.py``, whose training section holds the
checks).

Tolerances, and why:

* float32, at 1 and 2 microbatches, three AdamW steps, each port step
  started from the reference's state before it: losses rtol 1e-5; every
  gradient within 1e-4 of its leaf's max |g| (the chunked form's
  batched products and its loop over the two chunks, carrying the
  state, against the reference's ``lax.scan`` over chunks, through the
  factored exponentials and ``_project``'s clamps); the weights within
  3·lr·1e-3 except elements at a near-zero gradient, where Adam's first
  update may take either sign (``check_train_steps``); the port's free
  run's losses rtol 1e-5;
* bf16, one step against the reference's step run op by op
  (``jax.disable_jit``: its compiled bf16 forward parts from its own
  layers by more than bf16's step, ROADMAP.md), at 2 layers and 2
  chunks: loss 3e-2, each weight within a flipped Adam step, at most 10 %
  of a leaf past one bf16 unit (``check_bf16_step``, which says why);
* remat on and off: bitwise;
* checkpoints: a reference float32 checkpoint resumes to the reference's
  next loss at rtol 1e-5; a port checkpoint restores in the reference
  bitwise, with the reference's keys;
* a longer sequence (4 chunks, bf16, the port alone): finite loss and
  gradients, and the clamped decay's leaves all get a gradient.
"""

import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro_torch.data import make_pipeline
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.rwkv6 import CHUNK

ARCH = "rwkv6-7b"
TWO_CHUNKS = 2 * CHUNK


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    F.check_train_steps(ARCH, microbatches, seq=TWO_CHUNKS)


def test_bf16_train_step_matches_reference_op_by_op():
    F.check_bf16_step(ARCH, jit=False, seq=TWO_CHUNKS, n_layers=2)


def test_remat_on_equals_off_bitwise():
    F.check_remat_bitwise(ARCH)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    F.check_reference_checkpoint_resumes(ARCH, tmp_path)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    F.check_port_checkpoint_restores(ARCH, tmp_path)


def test_gradients_through_four_chunks_are_finite():
    """bf16 over 256 tokens (4 chunks of the state loop): the loss and
    every gradient finite, and every leaf of the decay path (the LoRA,
    its bias, the mixes) with a non-zero gradient."""
    cj, ct = F.train_configs(ARCH, "bfloat16")
    _, tree = F.reference_weights(cj)
    model = params_from_numpy(ct, tree, device="cpu")
    batch = make_pipeline(ct, 256, 2, device="cpu").batch(0)
    plist = list(model.parameters())
    for p in plist:
        p.requires_grad_(True)
    loss = PT.lm_loss(model, batch, ct, backend="plain")
    grads = torch.autograd.grad(loss, plist)
    assert np.isfinite(float(loss))
    for (name, _), g in zip(model.named_parameters(), grads):
        assert bool(torch.isfinite(g).all()), name
        if ".tm." in name and name.rsplit(".", 1)[-1] in (
                "w_lora_a", "w_lora_b", "w_bias", "mix_w"):
            assert bool((g != 0).any()), name
