"""Clustering evaluation of the VAE-reconstructed unmatched cohorts
(counterpart of
``vae_los_angeles_tpu/evaluation/clustering/cluster_reconstructed.py``, the
reference's ``src/clustering_evaluation/cluster_reconstructed.py``).

    python -m vae_los_angeles_torch.evaluation.clustering.cluster_reconstructed

Finds the latest reconstruction pickles by ctime, joins each cohort's
measured and reconstructed modality into one feature matrix, reduces it
with PCA and t-SNE, scores silhouette and neighbourhood hit by primary site
on the original, PCA and t-SNE spaces, saves scatter plots coloured by site
and writes a text summary report. ``main(data=(rna_table, dna_table,
known_sites))`` takes the dicts `reconstruct_unmatched.main(data=...)`
returns and the matched table's site codes (the codes stand for the names;
a cohort row of a code the matched table lacks is dropped, as the label
encoder drops an unseen name on the pickle path). Runs on the card unless
the CPU is asked for.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.splits import SiteCodes
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation import tables
from vae_los_angeles_torch.evaluation.clustering.common import (cluster_scores,
                                                                perform_dimensionality_reduction,
                                                                plot_clusters_2d,
                                                                prepare_features)
from vae_los_angeles_torch.training import checkpoint

COHORTS = (("RNA-only", ["tpm_unstranded", "reconstructed_beta_value"]),
           ("DNA-only", ["beta_value", "reconstructed_tpm_unstranded"]))


def find_latest_reconstruction_files(data_dir="data"):
    rna_files = glob.glob(os.path.join(data_dir, "rna_with_reconstructed_dna_*.pkl"))
    dna_files = glob.glob(os.path.join(data_dir, "dna_with_reconstructed_rna_*.pkl"))
    rna_file = max(rna_files, key=os.path.getctime) if rna_files else None
    dna_file = max(dna_files, key=os.path.getctime) if dna_files else None
    return rna_file, dna_file


def analyze_cohort(df, label_encoder, cohort_name, feature_columns, run_timestamp,
                   plots_dir="plots", device=None):
    """One cohort's reduction, scores and plots; returns its result dict,
    or None when it has no rows, features or site labels to score."""
    print("\n" + "=" * 80)
    print(f"ANALYZING {cohort_name.upper()} SAMPLES")
    print("=" * 80)
    if tables.has(df, "primary_site"):
        n0 = tables.n_rows(df)
        df = tables.select(df, np.isin(tables.column(df, "primary_site"),
                                       label_encoder.classes_))
        if tables.n_rows(df) < n0:
            print(f"  Filtered out {n0 - tables.n_rows(df)} unknown-site samples")
    if tables.n_rows(df) == 0:
        print("⚠ No samples to analyze")
        return None

    features = prepare_features(df, feature_columns)
    if features is None:
        print("⚠ Could not prepare features")
        return None
    print(f"Feature matrix shape: {features.shape}")

    if tables.has(df, "primary_site_encoded"):
        labels = tables.column(df, "primary_site_encoded")
    elif tables.has(df, "primary_site"):
        labels = label_encoder.transform(tables.column(df, "primary_site"))
    else:
        print("⚠ No primary site labels found; skipping")
        return None

    pca_features, tsne_features = perform_dimensionality_reduction(features, device=device)
    scores = cluster_scores(features, labels, pca_features, tsne_features, device=device)
    if scores is None:
        print("⚠ Only one site label; skipping score/plots")
        return None
    print(f"  Original  - Silhouette: {scores['orig_silhouette']:.3f}, "
          f"NH: {scores['orig_nh']:.3f}")
    print(f"  PCA       - Silhouette: {scores['pca_silhouette']:.3f}, "
          f"NH: {scores['pca_nh']:.3f}")
    print(f"  t-SNE     - Silhouette: {scores['tsne_silhouette']:.3f}, "
          f"NH: {scores['tsne_nh']:.3f}")

    out_dir = os.path.join(plots_dir, "clustering")
    tag = cohort_name.lower().replace("-", "_")
    plot_clusters_2d(
        pca_features, labels,
        f"PCA: {cohort_name} (reconstructed)\nSilh: {scores['pca_silhouette']:.3f} "
        f"| NH: {scores['pca_nh']:.3f}",
        os.path.join(out_dir, f"{tag}_pca_reconstructed_{run_timestamp}.png"),
        label_encoder=label_encoder,
    )
    plot_clusters_2d(
        tsne_features, labels,
        f"t-SNE: {cohort_name} (reconstructed)\nSilh: {scores['tsne_silhouette']:.3f} "
        f"| NH: {scores['tsne_nh']:.3f}",
        os.path.join(out_dir, f"{tag}_tsne_reconstructed_{run_timestamp}.png"),
        label_encoder=label_encoder,
    )
    return {"cohort": cohort_name, "n_samples": tables.n_rows(df), **scores}


def write_summary_report(results, run_timestamp, plots_dir="plots"):
    """Text summary report (reference :375-420)."""
    out_dir = os.path.join(plots_dir, "clustering")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"clustering_summary_{run_timestamp}.txt")
    with open(path, "w") as f:
        f.write("CLUSTERING EVALUATION OF RECONSTRUCTED DATA\n")
        f.write("=" * 60 + "\n\n")
        for rec in results:
            if rec is None:
                continue
            f.write(f"Cohort: {rec['cohort']} ({rec['n_samples']} samples)\n")
            for space in ("orig", "pca", "tsne"):
                f.write(
                    f"  {space:>5s}: silhouette={rec[f'{space}_silhouette']:.4f} "
                    f"NH={rec[f'{space}_nh']:.4f}\n"
                )
            f.write("\n")
    print(f"✓ Summary report saved to: {path}")
    return path


def _cohort_tables(cfg, data):
    """(label encoder, [RNA-only table or None, DNA-only table or None])."""
    if data is not None:
        rna, dna, known_sites = data
        return SiteCodes(known_sites), [rna, dna]
    import pandas as pd  # only here: the card's machine has no pandas

    with open(os.path.join(cfg.data_dir, "label_encoder.pkl"), "rb") as f:
        label_encoder = pickle.load(f)
    found = []
    for path, (name, _) in zip(find_latest_reconstruction_files(cfg.data_dir), COHORTS):
        if path:
            print(f"\nLoading {name} reconstruction from: {path}")
        found.append(pd.read_pickle(path) if path else None)
    return label_encoder, found


def main(cfg: Optional[Config] = None, data=None, device=None):
    """Both cohorts' analysis and the summary report; ``data`` is
    ``(rna_table, dna_table, known_sites)`` (either table may be None), None
    reads the latest pickles. Returns the cohorts' result dicts (None for a cohort that was
    not scored)."""
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)
    run_timestamp = checkpoint.new_run_id()
    print("=" * 80)
    print("CLUSTERING EVALUATION OF RECONSTRUCTED DATA")
    print("=" * 80)

    label_encoder, found = _cohort_tables(cfg, data)
    results = []
    for df, (name, columns) in zip(found, COHORTS):
        if df is None:
            print(f"\n⚠ No {name.split('-')[0]} reconstruction files found")
            continue
        results.append(analyze_cohort(df, label_encoder, name, columns, run_timestamp,
                                      cfg.plots_dir, device))

    if any(r is not None for r in results):
        write_summary_report(results, run_timestamp, cfg.plots_dir)
    print("\nClustering evaluation complete!")
    return results


if __name__ == "__main__":
    main()
