"""Request preparation and program-shape grouping for the sweep service.

Counterpart of ``repro.serving.coalesce``. A sweep request (``SweepSpec``)
is coalescible when it runs through the fused program (a stratified plan,
``fused=True``, no Monte-Carlo study riding on it). ``prepare_sweep``
resolves exactly the inputs ``run_fused_sweep`` would use for it (the
engine build, the stacked population view, the plan's ``StratumBank``,
the staged policy's uniforms), and ``coalesce_key`` reduces them to the
hashable key the batcher groups by: the plan (the traced code), the
config tuple, and every trailing array shape. Requests sharing a key
stack along the app axis with no re-padding, so each lane's inputs are
its serial dispatch's, bit for bit.

``StratumBank``s are kept per (stratifier, apps) by the engine
(``ExperimentEngine.stratum_bank``), so repeat requests reuse one bank and
the batcher's cached group inputs stay valid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.sampling import plan as sampling_plan
from ..experiments.engine import ExperimentEngine, SweepStack
from ..experiments.sweep import SweepSpec

__all__ = ["PreparedSweep", "coalesce_key", "coalescible", "prepare_sweep",
           "resolve_bank"]


def coalescible(spec) -> bool:
    """True when the batcher may stack this request into a fused group:
    stratified ``fused=True`` sweeps without a riding Monte-Carlo study.
    Everything else (phase-1 SRS, staged, ``trials=``) runs serially
    through ``run_sweep`` in the same tick."""
    return (isinstance(spec, SweepSpec) and spec.plan is not None
            and spec.fused and spec.trials is None)


@dataclasses.dataclass
class PreparedSweep:
    """One request's resolved dispatch inputs (``prepare_sweep``): what
    ``run_fused_sweep`` derives per sweep, so the batcher can stack them
    into a group dispatch or run the request serially."""

    spec: SweepSpec
    stack: SweepStack
    bank: sampling_plan.StratumBank
    cfg_is: tuple
    cfgs: tuple
    truth: torch.Tensor                     # (A, C) census truth, f64
    uniforms: Optional[np.ndarray]          # (A, L) staged-rng draws

    @property
    def num_apps(self) -> int:
        """App-axis width this request adds to a stacked group."""
        return int(self.bank.weights.shape[0])


def resolve_bank(engine: ExperimentEngine, stratifier,
                 apps: tuple) -> sampling_plan.StratumBank:
    """``stratifier.resolve`` over the built ``apps``, one bank per
    (engine, stratifier, apps): the engine keeps it."""
    return engine.stratum_bank(stratifier, tuple(apps))


def prepare_sweep(engine: ExperimentEngine, spec: SweepSpec
                  ) -> PreparedSweep:
    """Resolve one coalescible request's dispatch inputs, as
    ``run_sweep``/``run_fused_sweep`` do: engine build and stacked view,
    config subset and census truth, the plan's ``StratumBank``, and for
    ``uses_uniforms`` policies the staged draws from
    ``spec.selection_seed`` (so coalesced picks equal staged picks)."""
    engine.build(spec.apps)
    stack = engine.stack(spec.apps)
    cfg_is = (tuple(range(len(engine.configs)))
              if spec.config_indices is None else spec.config_indices)
    cfgs = tuple(engine.configs[i] for i in cfg_is)
    truth = stack.truth[:, list(cfg_is)]
    bank = resolve_bank(engine, spec.plan.stratifier, spec.apps)
    uniforms = None
    if spec.plan.policy.uses_uniforms:
        a_n, n_strata = bank.weights.shape
        uniforms = np.random.default_rng(spec.selection_seed).random(
            (a_n, n_strata))
    return PreparedSweep(spec=spec, stack=stack, bank=bank, cfg_is=cfg_is,
                         cfgs=cfgs, truth=truth, uniforms=uniforms)


def _opt_shape(arr) -> Optional[tuple]:
    """Trailing shape of an optional array (None stays None: the program
    branches on absent inputs)."""
    return None if arr is None else tuple(arr.shape[1:])


def coalesce_key(prep: PreparedSweep) -> tuple:
    """The hashable program-shape key requests group by: same
    ``SamplingPlan``, same config tuple, same trailing shapes of every
    bank and stack array, and the same presence of the optional inputs
    (pool, features, centroids, uniforms). Within a group, concatenation
    adds rows verbatim: every lane computes as in its serial dispatch."""
    bank = prep.bank
    return (prep.spec.plan, prep.cfgs,
            _opt_shape(bank.labels), _opt_shape(bank.weights),
            _opt_shape(bank.baseline), _opt_shape(bank.pool),
            _opt_shape(bank.feats), _opt_shape(bank.centroids),
            _opt_shape(prep.stack.feats),
            prep.uniforms is None)
