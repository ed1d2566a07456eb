"""Sampling designs and estimators (the port's staged-sweep subset).

``plan`` holds the composable design objects — ``SamplingPlan`` =
``Stratifier`` x ``SelectionPolicy`` x ``Estimator`` — and their registry;
``tables`` the batched stratified statistics the sweep reads.
"""

from . import plan, tables
from .dalenius import dalenius_gurney_strata, stratum_products
from .plan import (BBVClusters, Centroid, DaleniusGurney, Estimator,
                   RFVClusters, SamplingPlan, SelectionPolicy, Stratifier,
                   WeightedPoint, make_policy, make_stratifier,
                   register_policy, register_stratifier)
from .srs import draw_srs, srs_estimate, srs_required_n
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
]
