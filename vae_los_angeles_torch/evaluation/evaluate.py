"""Evaluation of the tri-modal MultiModalVAE (counterpart of
``vae_los_angeles_tpu/evaluation/evaluate.py``, the reference's missing
``evaluate.py``):

    python -m vae_los_angeles_torch.evaluation.evaluate

  * ``get_run_id()`` → the latest tri-modal run id;
  * ``load_model_and_data()`` → (model, val_data, run_id), the model callable
    as ``model(a=..., b=..., site=...)`` (the contract ``downstream_task.py``
    imports);
  * ``main()`` → DNA imputed from RNA alone and RNA from DNA alone on the
    canonical validation split, their MSE, MAE, cosine similarity and
    Pearson r, written to ``plots/evaluation_results.json`` as
    ``{"run_id", "results": [two records]}``.

Every function takes ``data=(tpm, beta, site)`` arrays in place of
``processed_data.pkl`` and ``label_encoder.pkl`` (either package's, read by
``data.artifacts``: the port's pandas-free ones on the card). The model serves on the card
unless the CPU is asked for. The two plots (`plot_reconstruction_examples`,
`plot_correlation_distributions`) import matplotlib where they draw; the
card's machine has none, and a line says so.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.evaluation.loading import LoadedMultiModalVAE, load_multimodal
from vae_los_angeles_torch.evaluation.plotting import pyplot
from vae_los_angeles_torch.ops.metrics import compute_imputation_metrics, pearson_per_sample
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.training import checkpoint


def get_run_id(model_name: str = "multivae", root: str = ".") -> Optional[str]:
    """Latest run id via the run-id file."""
    return checkpoint.get_run_id(model_name, root)


def load_val_split(cfg: Optional[Config] = None, data=None):
    """(dataset, label encoder or None, train indices, validation indices):
    the canonical 80/20 split every consumer re-derives. ``data`` is
    ``(tpm, beta, site)`` arrays; None reads ``cfg.data_dir``'s pickle and
    label encoder."""
    cfg = cfg or Config.from_env()
    label_encoder = None
    if data is None:
        dataset = MultiModalDataset.from_pickle(os.path.join(cfg.data_dir, "processed_data.pkl"))
        label_encoder = artifacts.read_pickle(os.path.join(cfg.data_dir, "label_encoder.pkl"))
    else:
        dataset = MultiModalDataset.from_numpy(*data)
    tr_idx, va_idx = train_val_indices(len(dataset), cfg.train_test_split, cfg.random_seed)
    return dataset, label_encoder, tr_idx, va_idx


def load_model_and_data(cfg: Optional[Config] = None, data=None, root: str = ".", device=None):
    """(model, val_data, run_id) — the contract downstream_task.py imports."""
    cfg = cfg or Config.from_env()
    model = load_multimodal(cfg=cfg, root=root, device=device)
    if model is None:
        raise FileNotFoundError(
            "no trained MultiModalVAE checkpoint; run `python -m vae_los_angeles_torch.train` "
            "first")
    dataset, _, _, va_idx = load_val_split(cfg, data)
    val_data = (dataset.tpm_data[va_idx], dataset.beta_data[va_idx],
                dataset.primary_site[va_idx])
    return model, val_data, model.run_id


def evaluate_model(model: LoadedMultiModalVAE, tpm: np.ndarray, beta: np.ndarray):
    """Cross-modal reconstruction metrics in the reference's record format:
    returns (records, DNA imputed from RNA, RNA imputed from DNA)."""
    _, est_dna, _, _, _ = model(a=tpm)
    est_rna, _, _, _, _ = model(b=beta)
    records = [
        compute_imputation_metrics(beta, est_dna, "DNA methylation", "MultiModalVAE",
                                   model.device),
        compute_imputation_metrics(tpm, est_rna, "RNA expression", "MultiModalVAE",
                                   model.device),
    ]
    return records, est_dna, est_rna


@comm.writes_files
def plot_reconstruction_examples(tpm, beta, est_rna, est_dna, plots_dir="plots", n_samples=3,
                                 seed=42):
    """True against reconstructed values of a few validation samples →
    ``reconstruction_example_{i}.png``, from the reconstructions
    `evaluate_model` computed."""
    plt = pyplot()
    if plt is None:
        return
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(tpm), size=min(n_samples, len(tpm)), replace=False)
    os.makedirs(plots_dir, exist_ok=True)
    for rank, i in enumerate(idx):
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, truth, pred, name in ((axes[0], tpm[i], est_rna[i], "RNA (log1p TPM)"),
                                      (axes[1], beta[i], est_dna[i], "DNA (β-value)")):
            ax.scatter(truth, pred, s=3, alpha=0.4)
            lo = float(min(truth.min(), pred.min()))
            hi = float(max(truth.max(), pred.max()))
            ax.plot([lo, hi], [lo, hi], "r--", linewidth=1)
            ax.set_title(f"{name}: cross-modal reconstruction")
            ax.set_xlabel("true")
            ax.set_ylabel("reconstructed")
        fig.suptitle(f"Validation sample {i}")
        fig.tight_layout()
        path = os.path.join(plots_dir, f"reconstruction_example_{rank}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        print(f"Reconstruction example saved to {path}")


@comm.writes_files
def plot_correlation_distributions(tpm, beta, est_rna, est_dna, plots_dir="plots"):
    """Per-sample Pearson histograms of both directions →
    ``pearson_distributions.png``."""
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(plots_dir, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, truth, pred, name in ((axes[0], beta, est_dna, "DNA methylation (from RNA)"),
                                  (axes[1], tpm, est_rna, "RNA expression (from DNA)")):
        r, valid = pearson_per_sample(truth, pred)
        r = r[valid].cpu().numpy()
        ax.hist(r, bins=40, alpha=0.8, edgecolor="black", linewidth=0.3)
        if len(r):  # all-constant predictions: no valid correlation
            ax.axvline(float(r.mean()), color="red", linestyle="--", label=f"mean {r.mean():.3f}")
            ax.legend()
        ax.set_title(f"Per-sample Pearson r: {name}")
        ax.set_xlabel("Pearson r")
        ax.set_ylabel("samples")
    fig.tight_layout()
    path = os.path.join(plots_dir, "pearson_distributions.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Correlation distributions saved to {path}")


@comm.writes_files
def _write_json(path, obj):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def main(cfg: Optional[Config] = None, output_path: Optional[str] = None, data=None,
         device=None, root: str = "."):
    """Evaluate the latest tri-modal run (its run-id file in ``root``) and
    write the JSON; returns the records."""
    cfg = cfg or Config.from_env()
    model, (tpm, beta, _), run_id = load_model_and_data(cfg, data, root, device)
    print(f"Evaluating MultiModalVAE run {run_id} on {len(tpm)} validation samples")
    results, est_dna, est_rna = evaluate_model(model, tpm, beta)
    plot_reconstruction_examples(tpm, beta, est_rna, est_dna, cfg.plots_dir)
    plot_correlation_distributions(tpm, beta, est_rna, est_dna, cfg.plots_dir)
    for rec in results:
        print(
            f"  {rec['Modality']:>16s}: MSE={rec['MSE']:.4f} MAE={rec['MAE']:.4f} "
            f"Cosine={rec['CosineSimilarity']:.4f} Pearson r={rec['PearsonMean']:.4f}"
        )
    output_path = output_path or os.path.join(cfg.plots_dir, "evaluation_results.json")
    _write_json(output_path, {"run_id": run_id, "results": results})
    print(f"Evaluation results saved to {output_path}")
    return results


if __name__ == "__main__":
    main()
