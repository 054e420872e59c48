"""Clustering-quality metrics (counterpart of
``vae_los_angeles_tpu/evaluation/clustering/metrics_utils.py``, the
reference's ``src/clustering_evaluation/metrics_utils.py:4-41``)."""

from __future__ import annotations

from vae_los_angeles_torch.ops.cluster_metrics import neighborhood_hit


def calculate_neighborhood_hit(features, labels, k: int = 5, device=None) -> float:
    """Neighbourhood Hit: the mean fraction of each point's k nearest
    neighbours (self excluded) sharing its label; 0.0 below k + 1 rows.

    Always the device path (`ops.cluster_metrics.neighborhood_hit`, on the
    card unless ``device="cpu"``): ``EVAL_BACKEND`` is not read, as the
    port has no host route. Unlike the JAX function, a failure raises
    instead of printing a warning and scoring 0.0."""
    return neighborhood_hit(features, labels, k=k, device=device)
