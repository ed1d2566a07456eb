"""Sampling designs and estimators (the ported subset).

``plan`` holds the composable design objects — ``SamplingPlan`` =
``Stratifier`` x ``SelectionPolicy`` x ``Estimator`` — and their registry;
``tables`` the batched stratified statistics the sweep reads; ``selection``,
``stratified`` and ``two_phase`` the scalar estimators of sampled
evaluation (centroid picks, stratum summaries, the eq. (5)/(6) CI).
"""

from . import plan, tables
from .dalenius import dalenius_gurney_strata, stratum_products
from .plan import (BBVClusters, Centroid, DaleniusGurney, Estimator,
                   RFVClusters, SamplingPlan, SelectionPolicy, Stratifier,
                   WeightedPoint, make_policy, make_stratifier,
                   register_policy, register_stratifier)
from .selection import select_centroid, weighted_point_estimate
from .srs import draw_srs, srs_estimate, srs_required_n
from .stratified import StratumSummary, summarize_strata
from .tables import StratumTables, stratum_tables, tables_from_summaries
from .two_phase import two_phase_estimate, two_phase_estimate_tables
from .types import Estimate, critical_value, critical_values

__all__ = [
    "plan", "tables",
    "SamplingPlan", "Stratifier", "SelectionPolicy", "Estimator",
    "BBVClusters", "RFVClusters", "DaleniusGurney", "Centroid",
    "WeightedPoint", "register_stratifier", "register_policy",
    "make_stratifier", "make_policy",
    "dalenius_gurney_strata", "stratum_products",
    "draw_srs", "srs_estimate", "srs_required_n",
    "Estimate", "critical_value", "critical_values",
    "select_centroid", "weighted_point_estimate",
    "StratumSummary", "summarize_strata",
    "StratumTables", "stratum_tables", "tables_from_summaries",
    "two_phase_estimate", "two_phase_estimate_tables",
]
