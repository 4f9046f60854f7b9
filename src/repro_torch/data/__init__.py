"""Synthetic datasets and quality metrics (a copy of ``repro.data.datasets``'
numpy-only generators)."""

from repro_torch.data.datasets import exact_knn, gaussian_mixture, make_queries, recall
