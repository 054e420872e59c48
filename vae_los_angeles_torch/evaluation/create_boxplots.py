"""EDA boxplots of the highest- and lowest-variance genes and CpG probes
(counterpart of ``vae_los_angeles_tpu/evaluation/create_boxplots.py``, the
reference's ``create_boxplots.py``).

    python -m vae_los_angeles_torch.evaluation.create_boxplots

The variances and the chosen columns are numpy on the host (four
(samples × 10) slices are all that is drawn). ``main(data=(tpm, beta,
gene_names, probe_ids))`` takes arrays in place of ``processed_data.pkl``
and ``feature_names.pkl``; the plots import matplotlib where they draw.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.evaluation.plotting import pyplot

PLOTS = (
    # (matrix, highest, title, y label, x label, file)
    ("rna", True, "RNA Transcription Across Samples (Top 10 Genes with Highest Variance)",
     "log1p(TPM)", "Gene", "rna_genes_distribution_highest_variance.png"),
    ("rna", False, "RNA Transcription Across Samples (Top 10 Genes with Lowest Variance)",
     "log1p(TPM)", "Gene", "rna_genes_distribution_lowest_variance.png"),
    ("dna", True, "DNA Methylation Across Samples (Top 10 CpG Islands with Highest Variance)",
     "Beta Value", "CpG Island", "dna_cpg_distribution_highest_variance.png"),
    ("dna", False, "DNA Methylation Across Samples (Top 10 CpG Islands with Lowest Variance)",
     "Beta Value", "CpG Island", "dna_cpg_distribution_lowest_variance.png"),
)


def _variance_boxplot(matrix, names, idx, title, ylabel, xlabel, filename):
    plt = pyplot()
    if plt is None:
        return
    plt.figure(figsize=(15, 8))
    data = [matrix[:, i] for i in idx]
    plt.boxplot(data, tick_labels=[names[i] for i in idx], patch_artist=True)
    plt.title(title)
    plt.ylabel(ylabel)
    plt.xlabel(xlabel)
    plt.xticks(rotation=45, ha="right")
    plt.tight_layout()
    plt.savefig(filename)
    plt.close()


def _lowest_nonzero_variance_idx(variances, n=10):
    nonzero = np.where(variances > 0)[0]
    if len(nonzero) >= n:
        order = nonzero[np.argsort(variances[nonzero])]
        return order[:n]
    return np.argsort(variances)[:n]


def variance_indices(matrix):
    """(the 10 highest-variance columns, the 10 lowest of nonzero
    variance), as the JAX module picks them."""
    variances = np.var(matrix, axis=0)
    return np.argsort(variances)[-10:], _lowest_nonzero_variance_idx(variances)


def _inputs(cfg, data):
    if data is not None:
        tpm, beta, gene_names, probe_ids = data
        return np.asarray(tpm), np.asarray(beta), gene_names, probe_ids
    import pandas as pd  # only here: the card's machine has no pandas

    df = pd.read_pickle(os.path.join(cfg.data_dir, "processed_data.pkl"))
    with open(os.path.join(cfg.data_dir, "feature_names.pkl"), "rb") as f:
        feature_names = pickle.load(f)
    return (np.vstack(df["tpm_unstranded"].values),
            np.vstack([np.array(x) for x in df["beta_value"].values]),
            feature_names["gene_names"], feature_names["probe_ids"])


def main(cfg: Optional[Config] = None, data=None):
    """Write the four boxplots into ``cfg.plots_dir``; returns {file name:
    the chosen column indices}."""
    cfg = cfg or Config.from_env()
    os.makedirs(cfg.plots_dir, exist_ok=True)
    rna_matrix, dna_matrix, gene_names, probe_ids = _inputs(cfg, data)
    chosen = {}
    for key, matrix, names in (("rna", rna_matrix, gene_names), ("dna", dna_matrix, probe_ids)):
        high, low = variance_indices(matrix)
        for _, highest, title, ylabel, xlabel, filename in (p for p in PLOTS if p[0] == key):
            idx = high if highest else low
            chosen[filename] = idx
            _variance_boxplot(matrix, names, idx, title, ylabel, xlabel,
                              os.path.join(cfg.plots_dir, filename))
    print(
        "Boxplots for highest and lowest variance genes/CpGs created and saved "
        f"in the '{cfg.plots_dir}' directory."
    )
    return chosen


if __name__ == "__main__":
    main()
