"""Clustering for stratification: k-means, random projection, standardize."""

from .distributed import distributed_kmeans
from .kmeans import (KMeansBank, KMeansResult, best_of, kmeans, kmeans_bank,
                     kmeans_batch, kmeans_multi_seed)
from .random_projection import projection_matrix, random_project
from .standardize import Standardizer

__all__ = [
    "kmeans", "kmeans_batch", "kmeans_multi_seed", "kmeans_bank",
    "best_of", "distributed_kmeans",
    "KMeansResult", "KMeansBank",
    "random_project", "projection_matrix", "Standardizer",
]
