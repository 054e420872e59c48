"""Downstream site classification from the directional VAEs (counterpart
of ``vae_los_angeles_tpu/evaluation/downstream_directional.py``, the
reference's ``downstream_task_directional.py``).

    python -m vae_los_angeles_torch.evaluation.downstream_directional

The task of `downstream`, with the imputations of the two directional
models: DNA from RNA2DNAVAE(rna, site), RNA from DNA2RNAVAE(dna, site),
each conditioned on the ORIGINAL site codes the models were trained on (the
reference feeds them the re-encoded labels, which condition on the wrong
sites whenever a class is dropped; the JAX package fixes that, and so does
this). The classifier is the shallow 128-unit MLP, 20 epochs, on one
stratified 80/20 split with the balanced class weights of all the labels;
4 scenarios. With ``USE_PALLAS`` on the card the loaders serve through the
fused kernels: one launch of each for the validation rows.

Scenarios of one feature width train as one population, every member
seeded by ``seed`` (`run_scenarios_vmapped`: widths RNA and RNA + DNA, 2
populations); ``DOWNSTREAM_VMAP`` is not read (`downstream`), and
`run_classification_scenario` trains one scenario alone. Runs on the card
unless the CPU is asked for; ``main(data=(tpm, beta, site))`` takes arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.splits import balanced_class_weight, stratified_train_test_split
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation.downstream import (plot_comparison,
                                                         plot_per_tissue_comparison,
                                                         prepare_filtered_val_data)
from vae_los_angeles_torch.evaluation.loading import load_dna2rna, load_rna2dna
from vae_los_angeles_torch.evaluation.mlp_classifier import (fit_classifier, fit_classifier_folds,
                                                             predict_classes,
                                                             predict_classes_folds)
from vae_los_angeles_torch.ops.metrics import classification_report, format_report
from vae_los_angeles_torch.parallel import comm

SHALLOW = dict(arch="shallow", num_epochs=20, batch_size=32, lr=1e-3, weight_decay=0.0,
               early_stop=False)


def generate_estimated_dna(rna2dna_model, rna_data, sites):
    print("Generating estimated DNA methylation data...")
    est_dna, _, _ = rna2dna_model(rna=rna_data, site=sites)
    return est_dna


def generate_estimated_rna(dna2rna_model, dna_data, sites):
    print("Generating estimated RNA data...")
    est_rna, _, _ = dna2rna_model(dna=dna_data, site=sites)
    return est_rna


def _report(y_true, y_pred, le_new):
    return classification_report(y_true, y_pred, labels=np.arange(len(le_new.classes_)),
                                 target_names=le_new.classes_, zero_division=0)


def run_classification_scenario(features, labels, n_classes, class_weights, scenario_name,
                                le_new, seed=42, device=None):
    """One scenario: the stratified 80/20 split, the shallow MLP from
    ``seed``, its report (printed in text form too)."""
    print("\n" + "=" * 50)
    print(f"Scenario: {scenario_name}")
    print("=" * 50)
    tr, te = stratified_train_test_split(labels, test_size=0.2, seed=seed)
    fit = fit_classifier(features[tr], labels[tr], features[te], labels[te], n_classes,
                         class_weights, seed, device=device, **SHALLOW)
    report = _report(labels[te], predict_classes(fit.params, features[te], arch="shallow"),
                     le_new)
    print("\nClassification Report:")
    print(format_report(report))
    return report


def run_scenarios_vmapped(scenarios, labels, n_classes, class_weights, le_new, seed=42,
                          device=None):
    """The scenarios of one feature width as one population (the split is
    the same for all, only the features differ), every member seeded by
    ``seed``: each is its `run_classification_scenario`. Returns the
    reports in the scenarios' order."""
    names = list(scenarios)
    tr, te = stratified_train_test_split(labels, test_size=0.2, seed=seed)
    by_width = {}
    for name in names:
        by_width.setdefault(np.shape(scenarios[name])[1], []).append(name)
    metrics_dict = {}
    for width, group in by_width.items():
        print("\n" + "=" * 50)
        print(f"Scenarios (one population, width {width}): " + ", ".join(group))
        print("=" * 50)
        folds = [(scenarios[n][tr], labels[tr], scenarios[n][te], labels[te], class_weights)
                 for n in group]
        fit = fit_classifier_folds(folds, n_classes, seeds=[seed] * len(group), device=device,
                                   **SHALLOW)
        preds = predict_classes_folds(fit.params, [f[2] for f in folds], arch="shallow")
        for i, name in enumerate(group):
            metrics_dict[name] = _report(labels[te], preds[i], le_new)
            print(f"\n{name}: accuracy {metrics_dict[name]['accuracy']:.4f}")
    return {name: metrics_dict[name] for name in names}


def main(cfg: Optional[Config] = None, data=None, device=None, root: str = "."):
    """The 4 scenarios on the latest directional runs (their run-id files in
    ``root``); ``data`` is ``(tpm, beta, site)`` arrays, None reads
    ``cfg.data_dir``'s pickle. Runs on the card unless ``device="cpu"`` or
    ``DEVICE=cpu``. Returns {scenario: report}, or None when a model is
    missing."""
    cfg = cfg or Config.from_env()
    comm.ensure_group(device, cfg)
    device = resolve_device(device, cfg)
    rna2dna_model = load_rna2dna(cfg=cfg, root=root, device=device)
    dna2rna_model = load_dna2rna(cfg=cfg, root=root, device=device)
    if rna2dna_model is None or dna2rna_model is None:
        print("Error: both directional models must be trained first.")
        return None
    rna_data, dna_data, labels, le_new, orig_codes = prepare_filtered_val_data(
        cfg, return_orig_codes=True, data=data)
    n_classes = len(le_new.classes_)
    present = np.unique(labels)
    cw_full = np.ones(n_classes, np.float32)
    cw_full[present] = balanced_class_weight(present, labels)

    print("\n" + "=" * 80)
    print("GENERATING ESTIMATED DATA")
    print("=" * 80)
    est_dna_data = generate_estimated_dna(rna2dna_model, rna_data, orig_codes)
    est_rna_data = generate_estimated_rna(dna2rna_model, dna_data, orig_codes)
    print(f"✓ Estimated DNA shape: {est_dna_data.shape}")
    print(f"✓ Estimated RNA shape: {est_rna_data.shape}")

    scenarios = {
        "Orig. RNA": rna_data,
        "Orig. RNA + Est. DNA": np.concatenate([rna_data, est_dna_data], axis=1),
        "Orig. DNA + Est. RNA": np.concatenate([dna_data, est_rna_data], axis=1),
        "Orig. RNA + Orig. DNA": np.concatenate([rna_data, dna_data], axis=1),
    }
    metrics_dict = run_scenarios_vmapped(scenarios, labels, n_classes, cw_full, le_new,
                                         device=device)

    run_tag = f"{rna2dna_model.run_id}_{dna2rna_model.run_id}"
    plot_comparison(metrics_dict, run_tag, out_subdir="downstream_task_directional",
                    plots_dir=cfg.plots_dir)
    plot_per_tissue_comparison(metrics_dict, le_new, run_tag,
                               out_subdir="downstream_task_directional", plots_dir=cfg.plots_dir)
    print("\nPerformance Summary:")
    for scenario_name, report in metrics_dict.items():
        print(f"\n{scenario_name}:")
        print(f"  Accuracy: {report['accuracy']:.4f}")
        print(f"  Weighted F1: {report['weighted avg']['f1-score']:.4f}")
    print("\nDownstream task complete!")
    return metrics_dict


if __name__ == "__main__":
    main()
