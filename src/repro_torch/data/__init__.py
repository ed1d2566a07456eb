"""Synthetic data pipelines of the port."""

from .synthetic import SyntheticEncDec, SyntheticLM, make_pipeline

__all__ = ["SyntheticLM", "SyntheticEncDec", "make_pipeline"]
