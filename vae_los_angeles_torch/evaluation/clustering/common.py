"""Shared clustering-evaluation helpers (counterpart of
``vae_los_angeles_tpu/evaluation/clustering/common.py``): feature assembly,
the PCA and t-SNE reduction, the member-batched cohort analysis, the 2-D
scatter plot and the silhouette and neighbourhood-hit scores.

Everything numeric runs on the device (the card unless ``device="cpu"``):
the scaling and the Gram PCA (`ops.pca`), the exact t-SNE (`ops.tsne`) and
the fused silhouette and hit (`ops.cluster_metrics`). ``EVAL_BACKEND`` is
not read: the port has no sklearn route. The scatter plot imports
matplotlib where it draws (`evaluation.plotting`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation import tables
from vae_los_angeles_torch.evaluation.plotting import pyplot
from vae_los_angeles_torch.ops import cluster_metrics
from vae_los_angeles_torch.ops.knn import _to_device
from vae_los_angeles_torch.ops.pca import (PCA, _pca_gram, pca_scores_members, standardize,
                                           standardize_members)
from vae_los_angeles_torch.ops.tsne import TSNE, tsne_fit_transform_members

# Short labels for the 24 TCGA primary sites (reference
# cluster_imputation_methods.py:34-59)
CLASS_SHORT_LABELS = {
    "Hematopoietic and reticuloendothelial systems": "Hemato",
    "Bronchus and lung": "Lung",
    "Breast": "Breast",
    "Kidney": "Kidney",
    "Brain": "Brain",
    "Colon": "Colon",
    "Corpus uteri": "Corpus",
    "Skin": "Skin",
    "Prostate gland": "Prostate",
    "Stomach": "Stomach",
    "Bladder": "Bladder",
    "Liver and intrahepatic bile ducts": "Liver",
    "Pancreas": "Pancreas",
    "Ovary": "Ovary",
    "Uterus, NOS": "Uterus",
    "Cervix uteri": "Cervix",
    "Esophagus": "Esophagus",
    "Adrenal gland": "Adrenal",
    "Other and ill-defined sites": "Other",
    "Other and unspecified parts of tongue": "Tongue",
    "Connective, subcutaneous and other soft tissues": "Connective",
    "Larynx": "Larynx",
    "Rectum": "Rectum",
    "Other and ill-defined sites in lip, oral cavity and pharynx": "Oral/Pharynx",
}


def prepare_features(df, columns):
    """Concatenate the feature columns named in ``columns`` (those the
    table has) into one float32 matrix; None when it has none. ``df`` is a
    DataFrame of list columns or a dict of arrays."""
    features = [tables.column(df, col).astype(np.float32) for col in columns
                if tables.has(df, col)]
    if not features:
        return None
    return np.concatenate(features, axis=1)


def _tsne_input(scaled):
    """The t-SNE's input: PCA-50 scores of the scaled features above 50
    dimensions, else the scaled features (either with a member axis)."""
    n, d = scaled.shape[-2:]
    if d > 50:
        return _pca_gram(scaled, min(50, n, d))[0]
    return scaled


def perform_dimensionality_reduction(features, method="both", n_components=2, random_state=42,
                                     device=None):
    """StandardScaler → PCA(2) and/or t-SNE(2), the t-SNE on the PCA-50
    scores above 50 dimensions (reference cluster_reconstructed.py:140-187),
    on the device; returns numpy (pca, tsne) for "both"."""
    dev = resolve_device(device)
    scaled = standardize(_to_device(features, dev))
    results = {}
    if method in ("pca", "both"):
        pca = PCA(n_components=n_components, random_state=random_state, device=dev)
        results["pca"] = pca.fit_transform(scaled)
        print(f"  PCA explained variance: {pca.explained_variance_ratio_.sum():.4f}")
    if method in ("tsne", "both"):
        tsne = TSNE(n_components=n_components, random_state=random_state,
                    perplexity=min(30, len(features) - 1), device=dev)
        results["tsne"] = tsne.fit_transform(_tsne_input(scaled))
    if method == "both":
        return results["pca"], results["tsne"]
    return results[method]


def _score_dict(orig, pca, tsne):
    return {"orig_silhouette": orig[0], "orig_nh": orig[1], "pca_silhouette": pca[0],
            "pca_nh": pca[1], "tsne_silhouette": tsne[0], "tsne_nh": tsne[1]}


def analyze_cohort_population(features_list, labels, n_components: int = 2,
                              random_state: int = 42, device=None):
    """Scaler → PCA(2) (and PCA-50 before the t-SNE) → t-SNE → the fused
    silhouette and hit on the original, PCA and t-SNE spaces, for M
    same-shaped feature spaces of one cohort (the imputation methods), each
    stage over the member axis: one set of launches for all members instead
    of one a method. Returns ``[(pca_2d, tsne_2d, scores or None)]`` a
    member, the scores as `cluster_scores` gives them."""
    dev = resolve_device(device)
    stacked = torch.stack([_to_device(f, dev) for f in features_list])
    m, n, d = stacked.shape
    scaled = standardize_members(stacked)
    pca2, evr = pca_scores_members(scaled, min(n_components, n, d))
    for i, r in enumerate(evr.cpu().numpy()):
        print(f"  PCA explained variance (member {i}): {r.sum():.4f}")
    tsne2, _ = tsne_fit_transform_members(_tsne_input(scaled), n_components=n_components,
                                          perplexity=min(30, n - 1), device=dev)
    pca2_host = pca2.cpu().numpy()
    if len(np.unique(labels)) <= 1:
        return [(pca2_host[i], tsne2[i], None) for i in range(m)]
    scores = [cluster_metrics.cluster_scores_members(space, labels, device=dev)
              for space in (scaled, pca2, tsne2)]
    return [(pca2_host[i], tsne2[i], _score_dict(*(s[i] for s in scores))) for i in range(m)]


def plot_clusters_2d(features_2d, labels, title, filename, label_encoder=None, figsize=(12, 10),
                     marker_size=50, alpha=0.7):
    """Scatter plot of a 2-D embedding coloured by primary site."""
    plt = pyplot()
    if plt is None:
        return
    labels = np.asarray(labels)
    plt.figure(figsize=figsize)
    cmap = plt.get_cmap("tab20")
    for i, lab in enumerate(np.unique(labels)):
        mask = labels == lab
        if label_encoder is not None:
            name = label_encoder.inverse_transform([lab])[0]
            name = CLASS_SHORT_LABELS.get(name, name)
        else:
            name = lab
        plt.scatter(features_2d[mask, 0], features_2d[mask, 1], s=marker_size, alpha=alpha,
                    label=str(name), color=cmap(i % 20))
    plt.xlabel("Component 1", fontsize=12)
    plt.ylabel("Component 2", fontsize=12)
    plt.title(title, fontsize=14, fontweight="bold")
    plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left", frameon=True, fontsize=9)
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    plt.savefig(filename, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"✓ Plot saved to: {filename}")


def cluster_scores(features, labels, pca_features, tsne_features, device=None):
    """Silhouette and neighbourhood hit on the original (scaled once on the
    device), PCA and t-SNE spaces (reference cluster_reconstructed.py:296-
    318), each space's pair from one fused pass; None with a single label."""
    if len(np.unique(labels)) <= 1:
        return None
    dev = resolve_device(device)
    scaled = standardize(_to_device(features, dev))
    return _score_dict(*(cluster_metrics.cluster_scores(space, labels, device=dev)
                         for space in (scaled, pca_features, tsne_features)))
