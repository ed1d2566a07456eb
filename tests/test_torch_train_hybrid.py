"""The port's hybrid (RG-LRU, Griffin) trainer against the reference's,
on the CPU.

``recurrentgemma-2b`` at smoke size (d_model 256, rnn width 256, 4
heads of 64, MQA, window 64, float32; bf16 where named), lr 1e-3. The
float32 train steps take batches of 4 x 128 tokens, so the 64-token
local window excludes keys and its mask's backward is held too; the
other checks take 4 x 64. The train checks run at 7 layers (2 supers, which
are rematerialised, and a tail of one recurrent layer, which is not, as
the reference has it); the port checkpoint's at the config's 6 (an
empty tail, ``{}`` in the reference's tree). The reference draws the
weights (``PRNGKey(0)``), the port takes them through
``params_from_numpy`` (``tests/lm_family_checks.py``, whose training
section holds the checks).

Tolerances, and why:

* float32, at 1 and 2 microbatches, three AdamW steps, each port step
  started from the reference's state before it: losses rtol 1e-5; every
  gradient within 1e-4 of its leaf's max |g| (the log-step
  ``linear_scan``'s backward against ``associative_scan``'s, which
  associate the products differently; ``clamp_min`` against
  ``jnp.maximum``, equal except at exact ties); the weights within
  3·lr·1e-3 except elements at a near-zero gradient, where Adam's first
  update may take either sign (``check_train_steps``); the port's free
  run's losses rtol 1e-5;
* bf16, one step against the reference's step run op by op
  (``jax.disable_jit``: its compiled bf16 forward parts from its own
  layers by more than bf16's step, ROADMAP.md), at 3 layers (one super) to
  keep it short: loss 3e-2, each weight within a
  flipped Adam step, at most 10 % of a leaf past one bf16 unit
  (``check_bf16_step``, which says why);
* remat on and off: bitwise;
* checkpoints: a reference float32 checkpoint resumes to the reference's
  next loss at rtol 1e-5; a port checkpoint restores in the reference
  bitwise, with the reference's keys.
"""

import pytest

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse

ARCH = "recurrentgemma-2b"
WITH_TAIL = {"n_layers": 7}
PAST_THE_WINDOW = 128


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    F.check_train_steps(ARCH, microbatches, seq=PAST_THE_WINDOW,
                        **WITH_TAIL)


def test_bf16_train_step_matches_reference_op_by_op():
    F.check_bf16_step(ARCH, jit=False, n_layers=3)


def test_remat_on_equals_off_bitwise():
    F.check_remat_bitwise(ARCH, **WITH_TAIL)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    F.check_reference_checkpoint_resumes(ARCH, tmp_path, **WITH_TAIL)


@pytest.mark.parametrize("layers", [6, 7])
def test_port_checkpoint_restores_in_the_reference(tmp_path, layers):
    """With and without a tail (6 layers: the reference's ``tail`` is
    ``{}``)."""
    F.check_port_checkpoint_restores(ARCH, tmp_path, n_layers=layers)
