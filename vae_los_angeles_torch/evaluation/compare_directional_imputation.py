"""Directional-VAE imputation against the mean baseline (counterpart of
``vae_los_angeles_tpu/evaluation/compare_directional_imputation.py``).

Loads both directional checkpoints through the run-id files, imputes DNA
from RNA and RNA from DNA on the shared validation split (served by the
fused kernels on the card, or their plain versions when the CPU is asked
for), scores them and the mean baseline (the
validation table's column means) with MAE/MSE/RMSE/R²/cosine/per-sample
Pearson, prints the reference's table and writes ``comparison_results.json``
and ``comparison_results.csv`` into ``plots/directional_comparison_<id>/``.

Not ported yet: the kNN baselines (they wait for ``ops/knn.py``) and the
plots (the card's machine has no matplotlib).

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
from vae_los_angeles_torch.ops.metrics import compute_imputation_metrics, pearson_per_sample
from vae_los_angeles_torch.training import checkpoint


def get_mean_imputation_predictions(val_tpm, val_beta):
    """Mean vectors fitted on the validation table."""
    rna_mean_pred = np.tile(val_tpm.mean(axis=0), (len(val_tpm), 1))
    dna_mean_pred = np.tile(val_beta.mean(axis=0), (len(val_beta), 1))
    return rna_mean_pred.astype(np.float32), dna_mean_pred.astype(np.float32)


def compute_metrics(y_true, y_pred, modality_name, model_name, device=None):
    """Reference-format record, with the per-sample Pearson list."""
    rec = compute_imputation_metrics(y_true, y_pred, modality_name, model_name, device)
    r, valid = pearson_per_sample(np.asarray(y_true), np.asarray(y_pred))
    rec["_pearson_all"] = r[valid].tolist()
    return rec


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
    _, va_idx = train_val_indices(len(dataset), cfg.train_test_split, cfg.random_seed)
    rna_true, dna_true = dataset.tpm_data[va_idx], dataset.beta_data[va_idx]
    val_site = dataset.primary_site[va_idx]

    rna2dna_model = load_rna2dna(cfg=cfg, root=root, device=device)
    dna2rna_model = load_dna2rna(cfg=cfg, root=root, device=device)
    if rna2dna_model is None and dna2rna_model is None:
        print("Error: No models loaded. Please train both models first.")
        return None

    print("\nComputing baseline imputation predictions...")
    rna_mean_pred, dna_mean_pred = get_mean_imputation_predictions(rna_true, dna_true)

    results = []
    if rna2dna_model is not None:
        dev = rna2dna_model.device
        dna_vae_pred, _, _ = rna2dna_model(rna=rna_true, site=val_site)
        results.append(compute_metrics(dna_true, dna_vae_pred, "DNA methylation", "RNA2DNAVAE", dev))
        results.append(
            compute_metrics(dna_true, dna_mean_pred, "DNA methylation", "Mean Imputation", dev)
        )
    if dna2rna_model is not None:
        dev = dna2rna_model.device
        rna_vae_pred, _, _ = dna2rna_model(dna=dna_true, site=val_site)
        results.append(compute_metrics(rna_true, rna_vae_pred, "RNA expression", "DNA2RNAVAE", dev))
        results.append(
            compute_metrics(rna_true, rna_mean_pred, "RNA expression", "Mean Imputation", dev)
        )

    print("\n" + "=" * 80)
    print("DIRECTIONAL VAE IMPUTATION COMPARISON RESULTS")
    print("=" * 80)
    for rec in results:
        print(
            f"{rec['Modality']:>16s} | {rec['Model']:>16s} | MAE={rec['MAE']:.4f} "
            f"MSE={rec['MSE']:.4f} R2={rec['R2']:.4f} Pearson={rec['PearsonMean']:.4f}"
        )

    save_results(results, output_dir)
    print(f"\nComparison complete! All results saved to {output_dir}/")
    return results


if __name__ == "__main__":
    main()
