"""The port's sharded train step of the hybrid (RG-LRU), SSM (RWKV-6)
and enc-dec families against the reference's, on the CPU: two steps on
the (2, 2) mesh, each from the reference's state before it, against the
reference's steps under data degree 2 (the runner and its tolerances:
``tests/lm_family_checks.py``'s sharded section and
``tests/test_torch_train_sharded.py``'s docstring). The SSM's and the
hybrid's steps take 128 tokens, as their unsharded train tests do: two
RWKV chunks, and past the hybrid's 64-token local window.
"""

import pytest

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse


@pytest.mark.parametrize("arch,seq", [("recurrentgemma-2b", 128),
                                      ("rwkv6-7b", 128),
                                      ("seamless-m4t-large-v2", 64)])
def test_family_sharded_step_matches_reference(arch, seq):
    F.check_sharded_against_reference(arch, 2, 2, seq=seq)
