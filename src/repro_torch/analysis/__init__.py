"""torchlint: the port's static gate, the reference's jaxlint
(``repro.analysis``) redesigned for PyTorch code.

The port leans on conventions that only a card run would otherwise
catch, while the tests run on the CPU: the bodies recorded into CUDA
graphs never round-trip to the host or branch in Python on a tensor; a
replay's outputs are the graph's own buffers, valid until the next
replay; every ``repro_torch.prng`` key is consumed by one draw; one
``PrecisionPolicy`` owns the dtypes of the estimator pipeline; the
kernels are batch-native. This package checks them as an AST pass —
standard library only (``ast``, ``re``, ``json``), importing neither
torch nor jax nor the reference package — so the gate runs in a few
seconds anywhere.

Rule packs
----------
* ``rules_trace``     — TL001 host-sync-in-capture, TL005
  tensor-branch-in-capture, TL006 vmap-of-kernel-op (shared
  capture-reachability analysis, ``context``).
* ``rules_prng``      — TL002 prng-key-reuse.
* ``rules_precision`` — TL003 raw-dtype-literal, TL004
  read-after-replay.
* ``rules_repo``      — TL100 api-surface, TL101 missing-docstring,
  TL102 broken-doc-link.

Entry point: ``python -m repro_torch.analysis`` (``--list-rules``,
``--json``, ``--select``, ``--baseline``, ``--update-baseline``,
``--root``). Suppression (``# torchlint: disable=TL003``, or
``disable-file=``) and the grandfathering baseline
(``lint_baseline_torch.json``, every entry justified) are described in
the README's section on the port.
"""

from .driver import main, run_lint
from .findings import Finding
from .registry import RULES, register_rule

# importing the packs registers their rules with the driver registry
from . import rules_trace, rules_prng, rules_precision, rules_repo  # noqa: E402,F401 isort:skip

__all__ = ["main", "run_lint", "Finding", "RULES", "register_rule"]
