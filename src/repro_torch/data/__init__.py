"""Synthetic datasets, exact ground truth and quality metrics, and the
synthetic LM data of the trainer (copies of the JAX package's numpy-only
``repro.data``)."""

from repro_torch.data.datasets import (
    GENERATORS,
    Dataset,
    correlated,
    exact_knn,
    gaussian_mixture,
    make_dataset,
    make_queries,
    mean_relative_error,
    recall,
    uniform,
    zipf_mixture,
)
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM

__all__ = [
    "LMDataConfig",
    "SyntheticLM",
    "Dataset",
    "GENERATORS",
    "exact_knn",
    "gaussian_mixture",
    "correlated",
    "uniform",
    "zipf_mixture",
    "make_dataset",
    "make_queries",
    "recall",
    "mean_relative_error",
]
