"""Clustering for stratification: k-means, random projection, standardize."""

from .kmeans import (KMeansBank, KMeansResult, best_of, kmeans, kmeans_bank,
                     kmeans_batch)
from .random_projection import projection_matrix, random_project
from .standardize import Standardizer

__all__ = [
    "kmeans", "kmeans_batch", "kmeans_bank", "best_of",
    "KMeansResult", "KMeansBank",
    "random_project", "projection_matrix", "Standardizer",
]
