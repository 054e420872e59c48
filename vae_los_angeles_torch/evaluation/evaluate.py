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
``processed_data.pkl`` (pandas, and the label encoder's sklearn, are
imported only where the pickle is read). The model serves on the card
unless the CPU is asked for. Not ported yet: the two plots (the
reconstruction examples and the Pearson histograms; the card's machine has
no matplotlib).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.evaluation.loading import LoadedMultiModalVAE, load_multimodal
from vae_los_angeles_torch.ops.metrics import compute_imputation_metrics
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
        with open(os.path.join(cfg.data_dir, "label_encoder.pkl"), "rb") as f:
            label_encoder = pickle.load(f)
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


def main(cfg: Optional[Config] = None, output_path: Optional[str] = None, data=None,
         device=None, root: str = "."):
    """Evaluate the latest tri-modal run (its run-id file in ``root``) and
    write the JSON; returns the records."""
    cfg = cfg or Config.from_env()
    model, (tpm, beta, _), run_id = load_model_and_data(cfg, data, root, device)
    print(f"Evaluating MultiModalVAE run {run_id} on {len(tpm)} validation samples")
    results, _, _ = evaluate_model(model, tpm, beta)
    print("The reconstruction and correlation plots are not ported (no matplotlib on the card's "
          "machine).")
    for rec in results:
        print(
            f"  {rec['Modality']:>16s}: MSE={rec['MSE']:.4f} MAE={rec['MAE']:.4f} "
            f"Cosine={rec['CosineSimilarity']:.4f} Pearson r={rec['PearsonMean']:.4f}"
        )
    output_path = output_path or os.path.join(cfg.plots_dir, "evaluation_results.json")
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump({"run_id": run_id, "results": results}, f, indent=2)
    print(f"Evaluation results saved to {output_path}")
    return results


if __name__ == "__main__":
    main()
