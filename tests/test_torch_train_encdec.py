"""The port's enc-dec trainer (``seamless-m4t-large-v2``) against the
reference's, on the CPU.

Smoke size: 2 encoder and 2 decoder layers, d_model 256, 4 heads of 64,
float32 (bf16 where named); batches of 4 x 64 tokens with 64 source
frames (``SyntheticEncDec``), lr 1e-3. The reference draws the weights
(``PRNGKey(0)``), the port takes them through ``params_from_numpy``
(``tests/lm_family_checks.py``, whose training section holds the
checks).

Tolerances, and why:

* float32, at 1 and 2 microbatches (the source frames split with the
  tokens), three AdamW steps, each port step started from the
  reference's state before it: losses rtol 1e-5; every gradient within
  1e-4 of its leaf's max |g| (both rematerialised stacks, the
  cross-attention's backward into the encoder); the weights within
  3·lr·1e-3 except elements at a near-zero gradient, where Adam's first
  update may take either sign (``check_train_steps``); the port's free
  run's losses rtol 1e-5;
* bf16, one step against the reference's compiled step: loss 3e-2, each
  weight within a flipped Adam step, at most 10 % of a leaf past one
  bf16 unit (``check_bf16_step``, which says why);
* remat on and off: bitwise;
* checkpoints: a reference float32 checkpoint resumes to the reference's
  next loss at rtol 1e-5; a port checkpoint restores in the reference
  bitwise, with the reference's keys;
* the training batches at ``--seq 1024``: 256 source frames, bitwise the
  reference's.
"""

import numpy as np
import pytest

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.data.synthetic import make_pipeline as jax_make_pipeline
from repro_torch.data import make_pipeline

ARCH = "seamless-m4t-large-v2"


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


def test_training_batches_at_seq_1024_hold_256_frames():
    cj, ct = F.train_configs(ARCH)
    want = jax_make_pipeline(cj, 1024, 2).batch(5)
    got = make_pipeline(ct, 1024, 2, device="cpu").batch(5)
    assert tuple(got["src_embeds"].shape) == (2, 256, ct.d_model)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]))
