"""Clustering evaluation of the imputed cohorts (counterpart of
``vae_los_angeles_tpu/evaluation/clustering``, the reference's
``src/clustering_evaluation``)."""

from vae_los_angeles_torch.evaluation.clustering.metrics_utils import (  # noqa: F401
    calculate_neighborhood_hit,
)
