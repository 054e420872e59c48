"""Clustering evaluation of mean, kNN and site-conditioned kNN imputation of
the unmatched cohorts (counterpart of
``vae_los_angeles_tpu/evaluation/clustering/cluster_imputation_methods.py``,
the reference's ``src/clustering_evaluation/cluster_imputation_methods.py``).

    python -m vae_los_angeles_torch.evaluation.clustering.cluster_imputation_methods

The imputers are fitted on the matched training table; each method imputes
the missing modality of the RNA-only and DNA-only cohorts, then the
reduction, scores and plots of `cluster_reconstructed` run for each
(method, cohort). The methods of one cohort share its rows, labels and
feature shape, so they run as one population (`analyze_cohort_grouped`:
every stage over a member axis, one member as well as three);
``CLUSTER_VMAP`` and ``EVAL_BACKEND`` are not read. `analyze_samples` is
the plain per-method function the population is tested against.

The kNN imputers are the port's (`ops.knn.KNNRegressor`,
``ConditionedKNNRegressor``), on the card unless the CPU is asked for.
``main(data=(matched, rna_only, dna_only))`` takes the three parts of
`data.synthetic.unmatched_cohorts` (the site codes stand for the names; the
matched sites are the known ones); None reads the pickles with pandas.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.splits import SiteCodes
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation import tables
from vae_los_angeles_torch.evaluation.clustering.common import (analyze_cohort_population,
                                                                cluster_scores,
                                                                perform_dimensionality_reduction,
                                                                plot_clusters_2d,
                                                                prepare_features)
from vae_los_angeles_torch.ops.knn import ConditionedKNNRegressor, KNNRegressor
from vae_los_angeles_torch.training import checkpoint


def _train_arrays(train_df):
    return (tables.column(train_df, "tpm_unstranded").astype(np.float32),
            tables.column(train_df, "beta_value").astype(np.float32))


def apply_mean_imputation(train_df, rna_only_df, dna_only_df):
    """Column-mean imputation fitted on the training table (reference
    :259-294).

    The JAX package's documented deviation from the reference, kept here
    (and in the two kNN variants): the reference queries its log1p-trained
    imputers with RAW unmatched TPM and then applies np.log1p again to
    imputed RNA that is already in log1p space. Here the unmatched TPM is
    log1p'd before querying (as `reconstruct_unmatched` treats the same
    cohort) and imputed RNA stays in the log1p space it was predicted in, so
    every RNA representation in the comparison shares one scale."""
    print("\nAPPLYING MEAN IMPUTATION")
    train_rna, train_dna = _train_arrays(train_df)
    rna_mean = train_rna.mean(axis=0)
    dna_mean = train_dna.mean(axis=0)

    rna_only_imputed = dna_only_imputed = None
    if rna_only_df is not None:
        rna_only_imputed = tables.with_columns(rna_only_df, imputed_beta_value=np.tile(
            dna_mean, (tables.n_rows(rna_only_df), 1)))
    if dna_only_df is not None:
        # rna_mean is a mean of log1p'd training vectors: already log space
        dna_only_imputed = tables.with_columns(dna_only_df, imputed_tpm_unstranded=np.tile(
            rna_mean, (tables.n_rows(dna_only_df), 1)))
    return rna_only_imputed, dna_only_imputed


def apply_knn_imputation(train_df, rna_only_df, dna_only_df, n_neighbors=5, device=None):
    """Cross-modal kNN imputation (reference :297-337)."""
    print(f"\nAPPLYING KNN IMPUTATION (k={n_neighbors})")
    train_rna, train_dna = _train_arrays(train_df)

    rna_only_imputed = dna_only_imputed = None
    if rna_only_df is not None:
        # the unmatched cohort ships raw TPM; bring the queries into the
        # imputer's log1p training space
        rna_val = np.log1p(tables.column(rna_only_df, "tpm_unstranded").astype(np.float32))
        knn_dna = KNNRegressor(n_neighbors=n_neighbors, n_jobs=-1, device=device)
        knn_dna.fit(train_rna, train_dna)
        rna_only_imputed = tables.with_columns(rna_only_df,
                                               imputed_beta_value=knn_dna.predict(rna_val))
    if dna_only_df is not None:
        dna_val = tables.column(dna_only_df, "beta_value").astype(np.float32)
        knn_rna = KNNRegressor(n_neighbors=n_neighbors, n_jobs=-1, device=device)
        knn_rna.fit(train_dna, train_rna)
        # predictions are in the log1p space the imputer was trained in
        dna_only_imputed = tables.with_columns(dna_only_df,
                                               imputed_tpm_unstranded=knn_rna.predict(dna_val))
    return rna_only_imputed, dna_only_imputed


def apply_conditioned_knn_imputation(train_df, rna_only_df, dna_only_df, label_encoder,
                                     n_neighbors=5, device=None):
    """Site-conditioned kNN imputation (reference :340-417): the site is
    the last feature column; the cohorts are filtered to known sites."""
    print(f"\nAPPLYING CONDITIONED KNN IMPUTATION (k={n_neighbors})")
    train_rna, train_dna = _train_arrays(train_df)
    train_sites = tables.column(train_df, "primary_site_encoded")[:, np.newaxis]
    train_rna_cond = np.hstack((train_rna, train_sites))
    train_dna_cond = np.hstack((train_dna, train_sites))

    def encode_sites(df):
        if tables.has(df, "primary_site_encoded"):
            return tables.column(df, "primary_site_encoded")
        return label_encoder.transform(tables.column(df, "primary_site"))

    def known(df):
        return tables.select(df, np.isin(tables.column(df, "primary_site"),
                                         label_encoder.classes_))

    rna_only_imputed = dna_only_imputed = None
    if rna_only_df is not None and tables.has(rna_only_df, "primary_site"):
        valid = known(rna_only_df)
        if tables.n_rows(valid) > 0:
            rna_val = np.log1p(tables.column(valid, "tpm_unstranded").astype(np.float32))
            rna_val_cond = np.hstack((rna_val, encode_sites(valid)[:, np.newaxis]))
            knn = ConditionedKNNRegressor(n_neighbors=n_neighbors, device=device)
            knn.fit(train_rna_cond, train_dna)
            rna_only_imputed = tables.with_columns(valid,
                                                   imputed_beta_value=knn.predict(rna_val_cond))
    if dna_only_df is not None and tables.has(dna_only_df, "primary_site"):
        valid = known(dna_only_df)
        if tables.n_rows(valid) > 0:
            dna_val = tables.column(valid, "beta_value").astype(np.float32)
            dna_val_cond = np.hstack((dna_val, encode_sites(valid)[:, np.newaxis]))
            knn = ConditionedKNNRegressor(n_neighbors=n_neighbors, device=device)
            knn.fit(train_dna_cond, train_rna)
            dna_only_imputed = tables.with_columns(
                valid, imputed_tpm_unstranded=knn.predict(dna_val_cond))
    return rna_only_imputed, dna_only_imputed


def _analysis_inputs(df, label_encoder, sample_type):
    """(features, labels) of one (method, cohort) table, or None: the filter
    and feature-assembly half of `analyze_samples`."""
    if tables.has(df, "primary_site"):
        df = tables.select(df, np.isin(tables.column(df, "primary_site"), label_encoder.classes_))
    if tables.n_rows(df) == 0:
        print("⚠ No samples with valid primary_site found")
        return None
    if sample_type == "RNA-only":
        features = prepare_features(df, ["tpm_unstranded", "imputed_beta_value"])
    else:
        features = prepare_features(df, ["beta_value", "imputed_tpm_unstranded"])
    if features is None:
        print("⚠ Could not prepare features")
        return None
    if tables.has(df, "primary_site_encoded"):
        labels = tables.column(df, "primary_site_encoded")
    else:
        labels = label_encoder.transform(tables.column(df, "primary_site"))
    return features, labels


def _report_and_plot(scores, pca_features, tsne_features, labels, label_encoder, run_timestamp,
                     method_name, sample_type, plots_dir):
    """The print, plot and result-dict half of `analyze_samples`."""
    if scores is None:
        print("⚠ Not enough distinct labels; skipping plots")
        return None
    print(
        f"  Original - Silh: {scores['orig_silhouette']:.3f} NH: {scores['orig_nh']:.3f} | "
        f"PCA - Silh: {scores['pca_silhouette']:.3f} NH: {scores['pca_nh']:.3f} | "
        f"t-SNE - Silh: {scores['tsne_silhouette']:.3f} NH: {scores['tsne_nh']:.3f}"
    )
    out_dir = os.path.join(plots_dir, "clustering")
    tag = sample_type.lower().replace("-", "_")
    mtag = method_name.lower().replace(" ", "_")
    plot_clusters_2d(
        pca_features, labels,
        f"PCA: {sample_type} samples ({method_name} imputation)\n"
        f"PCA Silh: {scores['pca_silhouette']:.3f} | NH: {scores['pca_nh']:.3f}",
        os.path.join(out_dir, f"{tag}_pca_{mtag}_{run_timestamp}.png"),
        label_encoder=label_encoder,
    )
    plot_clusters_2d(
        tsne_features, labels,
        f"t-SNE: {sample_type} samples ({method_name} imputation)\n"
        f"t-SNE Silh: {scores['tsne_silhouette']:.3f} | NH: {scores['tsne_nh']:.3f}",
        os.path.join(out_dir, f"{tag}_tsne_{mtag}_{run_timestamp}.png"),
        label_encoder=label_encoder,
    )
    return {"method": method_name, "cohort": sample_type, **scores}


def analyze_samples(df, label_encoder, run_timestamp, method_name, sample_type,
                    plots_dir="plots", device=None):
    """One (method, cohort)'s PCA, t-SNE, scores and plots (reference
    :420-527), one method at a time: the plain function that a member of
    `analyze_cohort_grouped`'s population is tested against."""
    print(f"\nANALYZING {sample_type.upper()} SAMPLES ({method_name})")
    inputs = _analysis_inputs(df, label_encoder, sample_type)
    if inputs is None:
        return None
    features, labels = inputs
    print(f"Feature matrix shape: {features.shape}")
    pca_features, tsne_features = perform_dimensionality_reduction(features, device=device)
    scores = cluster_scores(features, labels, pca_features, tsne_features, device=device)
    return _report_and_plot(scores, pca_features, tsne_features, labels, label_encoder,
                            run_timestamp, method_name, sample_type, plots_dir)


def analyze_cohort_grouped(entries, label_encoder, run_timestamp, sample_type, plots_dir="plots",
                           device=None):
    """Every imputation method of one cohort as one population
    (`common.analyze_cohort_population`, one member or more). ``entries``
    is [(method name, table)]; `_analysis_inputs` filters each table to the
    cohort's known-site rows, so the methods share the feature shape and
    labels (a ValueError if not). Returns the result dicts (None for a
    method that was not scored) in their order."""
    prepared = []
    for method_name, df in entries:
        print(f"\nANALYZING {sample_type.upper()} SAMPLES ({method_name})")
        inputs = _analysis_inputs(df, label_encoder, sample_type)
        if inputs is not None:
            print(f"Feature matrix shape: {inputs[0].shape}")
        prepared.append((method_name, inputs))
    live = [(m, x[0], x[1]) for m, x in prepared if x is not None]
    if not live:
        return [None] * len(prepared)
    features, labels = live[0][1], live[0][2]
    if any(f.shape != features.shape or not np.array_equal(lab, labels) for _, f, lab in live):
        raise ValueError(f"{sample_type}: the methods' feature shapes or labels differ")
    print(f"\n[{sample_type}] {len(live)} methods as one population")
    scored = iter(analyze_cohort_population([f for _, f, _ in live], labels, device=device))
    results = []
    for method_name, inputs in prepared:
        if inputs is None:
            results.append(None)
            continue
        pca2, tsne2, scores = next(scored)
        results.append(_report_and_plot(scores, pca2, tsne2, labels, label_encoder,
                                        run_timestamp, method_name, sample_type, plots_dir))
    return results


def _tables(cfg, data):
    """(label encoder, training table, RNA-only table or None, DNA-only
    table or None)."""
    if data is not None:
        (tpm, beta, site), (raw_tpm, rna_site), (dna_beta, dna_site) = data
        train = {"tpm_unstranded": tpm, "beta_value": beta, "primary_site": site,
                 "primary_site_encoded": site}
        rna = {"tpm_unstranded": raw_tpm, "primary_site": rna_site,
               "primary_site_encoded": rna_site}
        dna = {"beta_value": dna_beta, "primary_site": dna_site,
               "primary_site_encoded": dna_site}
        return SiteCodes(site), train, rna, dna
    import pandas as pd  # only here: the card's machine has no pandas

    train_df = pd.read_pickle(os.path.join(cfg.data_dir, "processed_data.pkl"))
    with open(os.path.join(cfg.data_dir, "label_encoder.pkl"), "rb") as f:
        label_encoder = pickle.load(f)
    cohorts = [os.path.join(cfg.data_dir, f"{m}_only_unmatched.pkl") for m in ("rna", "dna")]
    return (label_encoder, train_df,
            *(pd.read_pickle(p) if os.path.exists(p) else None for p in cohorts))


def main(cfg: Optional[Config] = None, data=None, device=None):
    """The three methods on both unmatched cohorts; returns the scored
    (method, cohort) result dicts, or None without unmatched samples."""
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)
    run_timestamp = checkpoint.new_run_id()
    print("=" * 80)
    print("DIMENSIONALITY REDUCTION VISUALIZATION FOR IMPUTATION METHODS")
    print("=" * 80)

    label_encoder, train_df, rna_only_df, dna_only_df = _tables(cfg, data)
    if rna_only_df is None and dna_only_df is None:
        print("\n⚠ No unmatched samples found! Run scripts/prepare_data.py first.")
        return None

    methods = [
        ("Mean", apply_mean_imputation(train_df, rna_only_df, dna_only_df)),
        ("KNN", apply_knn_imputation(train_df, rna_only_df, dna_only_df, device=device)),
        ("Conditioned KNN", apply_conditioned_knn_imputation(
            train_df, rna_only_df, dna_only_df, label_encoder, device=device)),
    ]
    rna_entries = [(name, rna_imp) for name, (rna_imp, _) in methods
                   if rna_imp is not None and tables.n_rows(rna_imp) > 0]
    dna_entries = [(name, dna_imp) for name, (_, dna_imp) in methods
                   if dna_imp is not None and tables.n_rows(dna_imp) > 0
                   and tables.has(dna_imp, "primary_site")]
    results = []
    for entries, sample_type in ((rna_entries, "RNA-only"), (dna_entries, "DNA-only")):
        if entries:
            results.extend(analyze_cohort_grouped(entries, label_encoder, run_timestamp,
                                                  sample_type, cfg.plots_dir, device))
    print("\nVisualization analysis complete!")
    return [r for r in results if r is not None]


if __name__ == "__main__":
    main()
