"""Downstream task: primary-site classification from measured against
imputed modalities (counterpart of
``vae_los_angeles_tpu/evaluation/downstream.py``, the reference's
``downstream_task.py``).

    python -m vae_los_angeles_torch.evaluation.downstream

Take the shared validation split, drop the classes with fewer than 2 rows
and re-encode the labels; impute DNA from RNA alone and RNA from DNA alone
with the tri-modal MultiModalVAE; classify the primary site in 8 feature
scenarios (measured or imputed RNA and DNA, alone or side by side) with a
5-fold stratified split, the deep MLP, balanced class weights a fold and
early stopping on the validation accuracy; average the folds'
classification reports and plot the comparison.

Everything trains on the card unless the CPU is asked for (``device="cpu"``
or ``DEVICE=cpu``): the MLPs as populations (`mlp_classifier`). All
scenarios of one feature width train as one population of scenario × fold
members (`run_scenarios_grouped`: 3 populations, of widths RNA, DNA and
both, for the reference's 40 fits one after another). The JAX package's
``DOWNSTREAM_VMAP`` and ``DOWNSTREAM_GROUP`` are not read: they route round
its vmap abort and its recompilations, neither of which the port has, and
on the card a member of a larger population is its single fit only to fp32
order. `run_classification_scenario` (one scenario's folds) and
`train_and_evaluate_fold` (one fold) stay as plain functions. The host
does the splits, scaling, class weights and reports in numpy
(`data.splits`, `ops.metrics`); the card's machine has no sklearn, pandas
or matplotlib. ``main(data=(tpm, beta, site))`` takes arrays (then
the site codes stand for the class names); the plots import matplotlib
where they draw, and a line says when it is missing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.splits import (LabelCodes, balanced_class_weight, standard_scale,
                                               stratified_kfold_indices)
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation import evaluate as evaluate_mod
from vae_los_angeles_torch.evaluation.plotting import pyplot as _pyplot
from vae_los_angeles_torch.evaluation.loading import load_multimodal
from vae_los_angeles_torch.evaluation.mlp_classifier import (fit_classifier, fit_classifier_folds,
                                                             predict_classes,
                                                             predict_classes_folds)
from vae_los_angeles_torch.ops.metrics import classification_report
from vae_los_angeles_torch.parallel import comm

DEEP = dict(arch="deep", num_epochs=100, batch_size=32, lr=1e-3, weight_decay=1e-4,
            early_stop=True)


def generate_estimated_dna(vae_model, rna_data):
    """DNA imputed from RNA alone (the tri-modal model's second output)."""
    print("Generating estimated DNA methylation data...")
    _, est_dna, _, _, _ = vae_model(a=rna_data)
    return est_dna


def generate_estimated_rna(vae_model, dna_data):
    """RNA imputed from DNA alone (the tri-modal model's first output)."""
    print("Generating estimated RNA data...")
    est_rna, _, _, _, _ = vae_model(b=dna_data)
    return est_rna


def _report(y_true, y_pred, le_new):
    return classification_report(y_true, y_pred, labels=np.arange(len(le_new.classes_)),
                                 target_names=le_new.classes_, zero_division=0)


def train_and_evaluate_fold(X_train, X_val, y_train, y_val, n_classes, class_weights, le_new,
                            seed=0, device=None):
    """One fold: the deep MLP from ``seed``, then its classification report."""
    fit = fit_classifier(X_train, y_train, X_val, y_val, n_classes, class_weights, seed,
                         device=device, **DEEP)
    return _report(y_val, predict_classes(fit.params, X_val, arch="deep"), le_new)


def _aggregate_fold_reports(fold_reports, le_new):
    """Mean and population std across the folds' reports: the accuracy, the
    weighted averages and each class present in a report."""
    aggregated = {}
    accuracies = [r["accuracy"] for r in fold_reports]
    aggregated["accuracy"] = float(np.mean(accuracies))
    aggregated["accuracy_std"] = float(np.std(accuracies))
    for stat in ("precision", "recall", "f1-score"):
        vals = [r["weighted avg"][stat] for r in fold_reports]
        aggregated.setdefault("weighted avg", {})[stat] = float(np.mean(vals))
        aggregated["weighted avg"][f"{stat}_std"] = float(np.std(vals))
    for class_name in le_new.classes_:
        vals = [r[class_name] for r in fold_reports if class_name in r]
        if vals:
            aggregated[class_name] = {stat: float(np.mean([v[stat] for v in vals]))
                                      for stat in ("precision", "recall", "f1-score")}
            for stat in ("precision", "recall", "f1-score"):
                aggregated[class_name][f"{stat}_std"] = float(np.std([v[stat] for v in vals]))
    return aggregated


def fold_class_weights(labels, splits, n_classes):
    """Each fold's balanced class weights from its training labels (1 for a
    class absent there), float32."""
    out = []
    for train_idx, _ in splits:
        y_train = labels[train_idx]
        present = np.unique(y_train)
        cw = np.ones(n_classes, np.float32)
        cw[present] = balanced_class_weight(present, y_train)
        out.append(cw)
    return out


def _print_aggregate(n_folds, aggregated):
    print(f"\nCross-Validation Results ({n_folds} folds):")
    print(f"Accuracy: {aggregated['accuracy']:.4f} ± {aggregated['accuracy_std']:.4f}")
    print(f"Weighted F1-score: {aggregated['weighted avg']['f1-score']:.4f} "
          f"± {aggregated['weighted avg']['f1-score_std']:.4f}")


def run_classification_scenario(features, labels, n_classes, scenario_name, le_new, n_folds=5,
                                seed=42, device=None):
    """One scenario: scaled features, a stratified ``n_folds``-fold split,
    the folds as one population, member f seeded by f; returns the
    aggregated report."""
    print("\n" + "=" * 50)
    print(f"Scenario: {scenario_name}")
    print("=" * 50)
    features_normalized = standard_scale(features)
    splits = stratified_kfold_indices(labels, n_folds, seed)
    fold_cws = fold_class_weights(labels, splits, n_classes)
    print(f"Training all {n_folds} folds as one population")
    folds = [(features_normalized[tr], labels[tr], features_normalized[va], labels[va], cw)
             for (tr, va), cw in zip(splits, fold_cws)]
    fit = fit_classifier_folds(folds, n_classes, device=device, **DEEP)
    preds = predict_classes_folds(fit.params, [features_normalized[va] for _, va in splits])
    fold_reports = [_report(labels[va], preds[i, :len(va)], le_new)
                    for i, (_, va) in enumerate(splits)]
    aggregated = _aggregate_fold_reports(fold_reports, le_new)
    _print_aggregate(n_folds, aggregated)
    return aggregated


def run_scenarios_grouped(scenarios, labels, n_classes, le_new, n_folds=5, seed=42,
                          device=None):
    """Every scenario of one feature width as one population of scenario ×
    fold members: the split depends on the labels alone, so member (s, f)
    takes fold f's rows, class weights and seed f, which is each scenario's
    own `run_classification_scenario`. Returns the aggregated reports in
    the scenarios' order."""
    names = list(scenarios)
    splits = stratified_kfold_indices(labels, n_folds, seed)
    fold_cws = fold_class_weights(labels, splits, n_classes)
    by_width = {}
    for name in names:
        by_width.setdefault(np.shape(scenarios[name])[1], []).append(name)
    metrics_dict = {}
    for width, group in by_width.items():
        print("\n" + "=" * 50)
        print(f"Scenario group (one population, width {width}): " + ", ".join(group))
        print("=" * 50)
        members, member_val = [], []
        for name in group:
            fn = standard_scale(scenarios[name])
            for (tr, va), cw in zip(splits, fold_cws):
                members.append((fn[tr], labels[tr], fn[va], labels[va], cw))
                member_val.append(fn[va])
        seeds = [f for _ in group for f in range(n_folds)]
        fit = fit_classifier_folds(members, n_classes, seeds=seeds, device=device, **DEEP)
        preds = predict_classes_folds(fit.params, member_val)
        for s, name in enumerate(group):
            fold_reports = [_report(labels[va], preds[s * n_folds + f, :len(va)], le_new)
                            for f, (_, va) in enumerate(splits)]
            agg = _aggregate_fold_reports(fold_reports, le_new)
            metrics_dict[name] = agg
            print(f"{name}: accuracy {agg['accuracy']:.4f} ± {agg['accuracy_std']:.4f}, "
                  f"weighted F1 {agg['weighted avg']['f1-score']:.4f}")
    return {name: metrics_dict[name] for name in names}


@comm.writes_files
def plot_comparison(metrics_dict, run_id=None, out_subdir="downstream_task", plots_dir="plots"):
    """Grouped bars of accuracy and the weighted precision, recall and F1 by
    scenario."""
    plt = _pyplot()
    if plt is None:
        return
    names = list(metrics_dict)
    values = {"accuracy": [metrics_dict[n]["accuracy"] for n in names]}
    for stat in ("precision", "recall", "f1-score"):
        values[stat] = [metrics_dict[n]["weighted avg"][stat] for n in names]
    x = np.arange(len(names))
    width = 0.2
    fig, ax = plt.subplots(figsize=(max(10, 2 * len(names)), 6))
    for i, (stat, vals) in enumerate(values.items()):
        ax.bar(x + (i - 1.5) * width, vals, width, label=stat)
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.set_title("Downstream classification: scenario comparison")
    ax.grid(True, axis="y", alpha=0.3)
    out_dir = os.path.join(plots_dir, out_subdir)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{run_id}" if run_id else ""
    path = os.path.join(out_dir, f"scenario_comparison{suffix}.png")
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"Comparison plot saved to {path}")


@comm.writes_files
def plot_per_tissue_comparison(metrics_dict, le_new, run_id=None, out_subdir="downstream_task",
                               plots_dir="plots"):
    """Two panels of per-class F1 by scenario."""
    plt = _pyplot()
    if plt is None:
        return
    classes = list(le_new.classes_)
    names = list(metrics_dict)
    f1 = np.array([[metrics_dict[n].get(c, {}).get("f1-score", 0.0) for c in classes]
                   for n in names]).reshape(len(names), len(classes))
    half = len(classes) // 2
    fig, axes = plt.subplots(2, 1, figsize=(16, 12))
    for panel, cols in enumerate((list(range(half)), list(range(half, len(classes))))):
        x = np.arange(len(cols))
        width = 0.8 / max(len(names), 1)
        for i, n in enumerate(names):
            axes[panel].bar(x + (i - len(names) / 2) * width, f1[i, cols], width, label=n)
        axes[panel].set_xticks(x)
        axes[panel].set_xticklabels([str(classes[c]) for c in cols], rotation=45, ha="right")
        axes[panel].set_ylabel("F1-score")
        axes[panel].grid(True, axis="y", alpha=0.3)
    axes[0].legend(loc="upper right", fontsize=8)
    fig.suptitle("Per-tissue F1 comparison")
    fig.tight_layout()
    out_dir = os.path.join(plots_dir, out_subdir)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{run_id}" if run_id else ""
    path = os.path.join(out_dir, f"per_tissue_f1_comparison{suffix}.png")
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"Per-tissue F1 comparison plot saved to {path}")


def prepare_filtered_val_data(cfg: Optional[Config] = None, return_orig_codes: bool = False,
                              data=None):
    """(RNA, DNA, labels, label codes[, original site codes]) of the
    validation split with the classes of fewer than 2 rows dropped and the
    rest re-encoded (`LabelCodes` of the site names; with ``data=(tpm, beta,
    site)`` arrays, of the site codes). The original codes are what the
    directional models were trained on, so they condition them."""
    dataset, label_encoder, _, va_idx = evaluate_mod.load_val_split(cfg, data)
    val_sites = dataset.primary_site[va_idx]
    unique, counts = np.unique(val_sites, return_counts=True)
    kept_idx = va_idx[np.isin(val_sites, unique[counts >= 2])]
    orig_codes = dataset.primary_site[kept_idx].astype(np.int64)
    names = orig_codes if label_encoder is None else label_encoder.inverse_transform(orig_codes)
    le_new = LabelCodes()
    labels = le_new.fit_transform(names)
    out = (dataset.tpm_data[kept_idx], dataset.beta_data[kept_idx], labels, le_new)
    return out + (orig_codes,) if return_orig_codes else out


def scenarios_of(rna, dna, est_dna, est_rna):
    """The reference's 8 feature scenarios, in its order."""
    return {
        "Orig. RNA": rna,
        "Orig. DNA": dna,
        "Orig. RNA + Est. DNA": np.concatenate([rna, est_dna], axis=1),
        "Orig. DNA + Est. RNA": np.concatenate([dna, est_rna], axis=1),
        "Orig. RNA + Orig. DNA": np.concatenate([rna, dna], axis=1),
        "Est. DNA": est_dna,
        "Est. RNA": est_rna,
        "Est. RNA + Est. DNA": np.concatenate([est_rna, est_dna], axis=1),
    }


def main(cfg: Optional[Config] = None, n_folds: int = 5, data=None, device=None,
         root: str = "."):
    """The 8 scenarios on the latest tri-modal run (its run-id file in
    ``root``); ``data`` is ``(tpm, beta, site)`` arrays, None reads
    ``cfg.data_dir``'s pickle. Runs on the card unless ``device="cpu"`` or
    ``DEVICE=cpu``. Returns {scenario: aggregated report}."""
    cfg = cfg or Config.from_env()
    comm.ensure_group(device, cfg)
    device = resolve_device(device, cfg)
    vae_model = load_multimodal(cfg=cfg, root=root, device=device)
    if vae_model is None:
        raise FileNotFoundError("no trained MultiModalVAE checkpoint; run "
                                "`python -m vae_los_angeles_torch.train` first")
    run_id = vae_model.run_id
    rna_data, dna_data, labels, le_new = prepare_filtered_val_data(cfg, data=data)
    n_classes = len(le_new.classes_)
    scenarios = scenarios_of(rna_data, dna_data, generate_estimated_dna(vae_model, rna_data),
                             generate_estimated_rna(vae_model, dna_data))
    metrics_dict = run_scenarios_grouped(scenarios, labels, n_classes, le_new, n_folds=n_folds,
                                         device=device)
    plot_comparison(metrics_dict, run_id, plots_dir=cfg.plots_dir)
    plot_per_tissue_comparison(metrics_dict, le_new, run_id, plots_dir=cfg.plots_dir)
    print("\n" + "=" * 50)
    print("Downstream task complete.")
    print("=" * 50)
    return metrics_dict


if __name__ == "__main__":
    main()
