"""Directional-VAE imputation against the mean baseline (counterpart of
``vae_los_angeles_tpu/evaluation/compare_directional_imputation.py``).

Loads both directional checkpoints through the run-id files, imputes DNA
from RNA and RNA from DNA on the shared validation split (served by the
fused kernels on the card, or their plain versions when the CPU is asked
for), scores them, the mean baseline (the validation table's column means)
and the kNN baseline (k = 5, fitted on the training table, `ops.knn` on the
same device) with MAE/MSE/RMSE/R²/cosine/per-sample Pearson, prints the
reference's table and writes ``comparison_results.json`` and
``comparison_results.csv`` into ``plots/directional_comparison_<id>/``,
and with both models the JAX module's three plots (`plot_comparison`,
`plot_correlation_distributions`, `create_interactive_plot`), which import
matplotlib or plotly where they draw; without them a line says so.

    python -m vae_los_angeles_torch.evaluation.compare_directional_imputation
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation.loading import load_dna2rna, load_rna2dna
from vae_los_angeles_torch.evaluation.plotting import plotly_go, pyplot
from vae_los_angeles_torch.ops.knn import KNNRegressor
from vae_los_angeles_torch.ops.metrics import compute_imputation_metrics, pearson_per_sample
from vae_los_angeles_torch.training import checkpoint


def get_mean_imputation_predictions(val_tpm, val_beta):
    """Mean vectors fitted on the validation table."""
    rna_mean_pred = np.tile(val_tpm.mean(axis=0), (len(val_tpm), 1))
    dna_mean_pred = np.tile(val_beta.mean(axis=0), (len(val_beta), 1))
    return rna_mean_pred.astype(np.float32), dna_mean_pred.astype(np.float32)


def get_knn_predictions(train_tpm, train_beta, val_tpm, val_beta, n_neighbors=5, device=None):
    """Cross-modal kNN baselines fitted on the training table: (RNA from
    DNA, DNA from RNA). ``n_jobs=-1`` is passed as the reference does and
    ignored."""
    knn_rna = KNNRegressor(n_neighbors=n_neighbors, n_jobs=-1, device=device)
    rna_knn_pred = knn_rna.fit(train_beta, train_tpm).predict(val_beta)
    knn_dna = KNNRegressor(n_neighbors=n_neighbors, n_jobs=-1, device=device)
    dna_knn_pred = knn_dna.fit(train_tpm, train_beta).predict(val_tpm)
    return rna_knn_pred, dna_knn_pred


def compute_metrics(y_true, y_pred, modality_name, model_name, device=None):
    """Reference-format record, with the per-sample Pearson list."""
    rec = compute_imputation_metrics(y_true, y_pred, modality_name, model_name, device)
    r, valid = pearson_per_sample(np.asarray(y_true), np.asarray(y_pred))
    rec["_pearson_all"] = r[valid].tolist()
    return rec


def plot_comparison(rna_true, dna_true, dna_vae, rna_vae, dna_mean, rna_mean, dna_knn, rna_knn,
                    output_dir, n_samples=3, seed=42):
    """True against predicted values of a few samples, VAE and kNN, both
    directions → ``comparison_sample_{i}.png``."""
    plt = pyplot()
    if plt is None:
        return
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(rna_true), size=min(n_samples, len(rna_true)), replace=False)
    for rank, i in enumerate(idx):
        fig, axes = plt.subplots(2, 2, figsize=(14, 8))
        panels = [("DNA: VAE vs true", dna_true[i], dna_vae[i]),
                  ("DNA: kNN vs true", dna_true[i], dna_knn[i]),
                  ("RNA: VAE vs true", rna_true[i], rna_vae[i]),
                  ("RNA: kNN vs true", rna_true[i], rna_knn[i])]
        for ax, (title, truth, pred) in zip(axes.ravel(), panels):
            ax.scatter(truth, pred, s=2, alpha=0.4)
            lo = float(min(truth.min(), pred.min()))
            hi = float(max(truth.max(), pred.max()))
            ax.plot([lo, hi], [lo, hi], "r--", linewidth=1)
            ax.set_title(title)
            ax.set_xlabel("true")
            ax.set_ylabel("predicted")
        fig.suptitle(f"Sample {i}")
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, f"comparison_sample_{rank}.png"), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)


def plot_correlation_distributions(dna_metrics, rna_metrics, output_dir):
    """The two VAEs' per-sample Pearson histograms →
    ``pearson_distributions.png``."""
    plt = pyplot()
    if plt is None:
        return
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, rec, name in ((axes[0], dna_metrics, "RNA→DNA"), (axes[1], rna_metrics, "DNA→RNA")):
        ax.hist(rec["_pearson_all"], bins=30, alpha=0.8)
        ax.axvline(rec["PearsonMean"], color="r", linestyle="--",
                   label=f"mean={rec['PearsonMean']:.3f}")
        ax.set_title(f"{name}: per-sample Pearson r")
        ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "pearson_distributions.png"), dpi=150,
                bbox_inches="tight")
    plt.close(fig)


def create_interactive_plot(results, output_dir):
    """Bars of each metric by modality and model →
    ``interactive_comparison.html`` (plotly)."""
    go = plotly_go()
    if go is None:
        return
    from plotly.subplots import make_subplots

    metrics = ["MAE", "MSE", "RMSE", "R2", "CosineSimilarity", "PearsonMean"]
    fig = make_subplots(rows=2, cols=3, subplot_titles=metrics)
    for k, metric in enumerate(metrics):
        fig.add_trace(go.Bar(x=[f"{r['Modality'][:3]}:{r['Model']}" for r in results],
                             y=[r[metric] for r in results], showlegend=False),
                      row=k // 3 + 1, col=k % 3 + 1)
    fig.update_layout(title="Directional imputation comparison", height=700)
    filename = os.path.join(output_dir, "interactive_comparison.html")
    fig.write_html(filename)
    print(f"Interactive plot saved to {filename}")


def save_results(results, output_dir):
    """``comparison_results.csv`` and ``.json``; keys starting with ``_``
    stay out."""
    clean = [{k: v for k, v in rec.items() if not k.startswith("_")} for rec in results]
    fields = list(dict.fromkeys(k for rec in clean for k in rec))
    csv_filename = os.path.join(output_dir, "comparison_results.csv")
    with open(csv_filename, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(clean)
    print(f"Results saved to {csv_filename}")
    json_filename = os.path.join(output_dir, "comparison_results.json")
    with open(json_filename, "w") as f:
        json.dump(clean, f, indent=2)
    print(f"Results also saved to {json_filename}")
    return clean


def main(cfg: Optional[Config] = None, data=None, root: str = ".", device=None):
    """``data`` is ``(tpm, beta, site)`` arrays; None reads
    ``cfg.data_dir/processed_data.pkl``. Run-id files are read from
    ``root``. Serves on the card unless ``device="cpu"`` or
    ``cfg.platform == "cpu"`` asks for the CPU. Returns the records, or
    None when no model loads."""
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)
    output_dir = os.path.join(cfg.plots_dir, f"directional_comparison_{checkpoint.new_run_id()}")
    os.makedirs(output_dir, exist_ok=True)

    if data is None:
        dataset = MultiModalDataset.from_pickle(os.path.join(cfg.data_dir, "processed_data.pkl"))
    else:
        dataset = MultiModalDataset.from_numpy(*data)
    tr_idx, va_idx = train_val_indices(len(dataset), cfg.train_test_split, cfg.random_seed)
    train_tpm, train_beta = dataset.tpm_data[tr_idx], dataset.beta_data[tr_idx]
    rna_true, dna_true = dataset.tpm_data[va_idx], dataset.beta_data[va_idx]
    val_site = dataset.primary_site[va_idx]

    rna2dna_model = load_rna2dna(cfg=cfg, root=root, device=device)
    dna2rna_model = load_dna2rna(cfg=cfg, root=root, device=device)
    if rna2dna_model is None and dna2rna_model is None:
        print("Error: No models loaded. Please train both models first.")
        return None

    print("\nComputing baseline imputation predictions...")
    rna_mean_pred, dna_mean_pred = get_mean_imputation_predictions(rna_true, dna_true)
    rna_knn_pred, dna_knn_pred = get_knn_predictions(train_tpm, train_beta, rna_true, dna_true,
                                                     device=device)

    results = []
    dna_vae_pred = rna_vae_pred = None
    if rna2dna_model is not None:
        dev = rna2dna_model.device
        dna_vae_pred, _, _ = rna2dna_model(rna=rna_true, site=val_site)
        results.append(compute_metrics(dna_true, dna_vae_pred, "DNA methylation", "RNA2DNAVAE", dev))
        results.append(
            compute_metrics(dna_true, dna_mean_pred, "DNA methylation", "Mean Imputation", dev)
        )
        results.append(
            compute_metrics(dna_true, dna_knn_pred, "DNA methylation", "k-NN Imputation", dev)
        )
    if dna2rna_model is not None:
        dev = dna2rna_model.device
        rna_vae_pred, _, _ = dna2rna_model(dna=dna_true, site=val_site)
        results.append(compute_metrics(rna_true, rna_vae_pred, "RNA expression", "DNA2RNAVAE", dev))
        results.append(
            compute_metrics(rna_true, rna_mean_pred, "RNA expression", "Mean Imputation", dev)
        )
        results.append(
            compute_metrics(rna_true, rna_knn_pred, "RNA expression", "k-NN Imputation", dev)
        )

    print("\n" + "=" * 80)
    print("DIRECTIONAL VAE IMPUTATION COMPARISON RESULTS")
    print("=" * 80)
    for rec in results:
        print(
            f"{rec['Modality']:>16s} | {rec['Model']:>16s} | MAE={rec['MAE']:.4f} "
            f"MSE={rec['MSE']:.4f} R2={rec['R2']:.4f} Pearson={rec['PearsonMean']:.4f}"
        )

    if dna_vae_pred is not None and rna_vae_pred is not None:
        plot_comparison(rna_true, dna_true, dna_vae_pred, rna_vae_pred, dna_mean_pred,
                        rna_mean_pred, dna_knn_pred, rna_knn_pred, output_dir)
        plot_correlation_distributions(results[0], results[3], output_dir)
        create_interactive_plot(results, output_dir)

    save_results(results, output_dir)
    print(f"\nComparison complete! All results saved to {output_dir}/")
    return results


if __name__ == "__main__":
    main()
