"""Sampling estimators and designs (paper Appendix A and the Fig. 14 flow).

``plan`` holds the composable design objects — ``SamplingPlan`` =
``Stratifier`` x ``SelectionPolicy`` x ``Estimator`` — and their registry;
``tables`` the batched stratified statistics (``StratumTables``); the
scalar estimators (``stratified``, ``two_phase``, ``collapsed``,
``allocation``, ``selection``, ``srs``) are one-lane views over it;
``design`` is the end-to-end ``TwoPhaseFlow``.
"""

from . import plan, tables
from .allocation import (neyman_allocation, proportional_allocation,
                         required_total_neyman, required_total_proportional)
from .collapsed import collapsed_strata_estimate
from .dalenius import dalenius_gurney_strata, stratum_products
from .design import Stratification, TwoPhaseFlow
from .plan import (BBVClusters, Centroid, CollapsedPairsCI, DaleniusGurney,
                   Estimator, RandomUnit, RankedSetUnit, RFVClusters,
                   SamplingPlan, SelectionPolicy, Stratifier, StratumMean,
                   TwoPhaseCI, WeightedPoint, make_policy, make_stratifier,
                   register_policy, register_stratifier, registered_policies,
                   registered_stratifiers)
from .selection import (select_centroid, select_mean, select_random,
                        weighted_point_estimate)
from .srs import draw_srs, srs_estimate, srs_required_n
from .stratified import (StratumSummary, satterthwaite_df,
                         stratified_estimate,
                         stratified_estimate_from_samples, stratified_mean,
                         stratified_variance, summarize_strata)
from .tables import StratumTables, stratum_tables, tables_from_summaries
from .two_phase import (phase2_sizes_for_margin, two_phase_estimate,
                        two_phase_estimate_tables)
from .types import Estimate, critical_value, critical_values

__all__ = [
    "plan", "tables",
    "SamplingPlan", "Stratifier", "SelectionPolicy", "Estimator",
    "BBVClusters", "RFVClusters", "DaleniusGurney",
    "Centroid", "StratumMean", "RandomUnit", "RankedSetUnit",
    "WeightedPoint", "CollapsedPairsCI", "TwoPhaseCI",
    "register_stratifier", "register_policy",
    "registered_stratifiers", "registered_policies",
    "make_stratifier", "make_policy",
    "TwoPhaseFlow", "Stratification",
    "dalenius_gurney_strata", "stratum_products",
    "proportional_allocation", "neyman_allocation",
    "required_total_neyman", "required_total_proportional",
    "collapsed_strata_estimate",
    "draw_srs", "srs_estimate", "srs_required_n",
    "Estimate", "critical_value", "critical_values",
    "select_random", "select_centroid", "select_mean",
    "weighted_point_estimate",
    "StratumSummary", "summarize_strata", "stratified_mean",
    "stratified_variance", "stratified_estimate",
    "stratified_estimate_from_samples", "satterthwaite_df",
    "StratumTables", "stratum_tables", "tables_from_summaries",
    "two_phase_estimate", "two_phase_estimate_tables",
    "phase2_sizes_for_margin",
]
