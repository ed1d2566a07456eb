"""Synthetic data pipelines of the port."""

from .synthetic import SyntheticLM, make_pipeline

__all__ = ["SyntheticLM", "make_pipeline"]
