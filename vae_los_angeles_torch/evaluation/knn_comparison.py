"""kNN against site-conditioned kNN against the directional VAEs
(counterpart of ``vae_los_angeles_tpu/evaluation/knn_comparison.py``, the
reference's ``src/knn_comparison/run_comparison.py``).

For both directions: a grid search over {k in 5/10/20/50, weights uniform or
distance, metric euclidean or manhattan} on the shared validation split,
the same grid for the site-conditioned kNN (the site appended as the last
feature column), and the loaded directional VAE, compared on per-sample MSE,
with boxplots and t-SNE scatter plots of the predictions coloured by site.

Everything runs on the card unless the CPU is asked for: the grids through
`ops.knn.knn_grid_mse` (one distance pass a metric serves its 8
combinations), the VAEs through their loaders (with ``USE_PALLAS`` the
fused serving kernels), the embeddings through `ops.tsne.TSNE`. The plots
need matplotlib (and plotly for the HTML ones), which are imported only
where a plot is drawn; without them a line says so and the run goes on.

    python -m vae_los_angeles_torch.evaluation.knn_comparison
"""

from __future__ import annotations

import itertools
import os
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation.evaluate import load_val_split
from vae_los_angeles_torch.evaluation.loading import load_dna2rna, load_rna2dna
from vae_los_angeles_torch.evaluation.plotting import plotly_go as _plotly_go
from vae_los_angeles_torch.evaluation.plotting import pyplot as _pyplot
from vae_los_angeles_torch.ops.knn import ConditionedKNNRegressor, KNNRegressor, knn_grid_mse
from vae_los_angeles_torch.ops.tsne import TSNE

KNN_GRID = {
    "n_neighbors": [5, 10, 20, 50],
    "weights": ["uniform", "distance"],
    "metric": ["euclidean", "manhattan"],
}


def optimize_knn(X_train, y_train, X_val, y_val, name="KNN", model_class=KNNRegressor,
                 device=None):
    """Grid search on the validation split: one `knn_grid_mse` call a metric
    gives every combination's MSE; the combinations are walked in
    ``KNN_GRID`` order, a later one kept only when strictly better, and only
    the winner is fitted. ``model_class`` is `KNNRegressor` or
    `ConditionedKNNRegressor`."""
    if model_class not in (KNNRegressor, ConditionedKNNRegressor):
        raise ValueError(f"model_class must be KNNRegressor or ConditionedKNNRegressor, "
                         f"got {model_class!r}")
    print(f"\nOptimizing {name}...")
    mses = {
        metric: knn_grid_mse(X_train, y_train, X_val, y_val, ks=KNN_GRID["n_neighbors"],
                             modes=KNN_GRID["weights"],
                             conditioned=model_class is ConditionedKNNRegressor,
                             metric=metric, device=device)
        for metric in KNN_GRID["metric"]
    }
    best_mse, best_params = float("inf"), {}
    keys = list(KNN_GRID)
    for combo in itertools.product(*KNN_GRID.values()):
        p = dict(zip(keys, combo))
        p["n_neighbors"] = min(p["n_neighbors"], len(X_train))  # sklearn refuses k > n
        mse = mses[p["metric"]][(p["n_neighbors"], p["weights"])]
        if mse < best_mse:
            best_mse, best_params = mse, p
    print(f"Best {name} params: {best_params} | MSE: {best_mse:.4f}")
    return model_class(**best_params, device=device).fit(X_train, y_train)


def create_boxplots(results, direction, plots_dir="plots"):
    """Per-sample-MSE boxplots, matplotlib and plotly."""
    plt = _pyplot()
    if plt is None:
        return
    out_dir = os.path.join(plots_dir, "comparison")
    os.makedirs(out_dir, exist_ok=True)
    labels = [f"{name}\n(Mean: {np.mean(m):.4f})" for name, m in results.items()]
    plt.figure(figsize=(10, 6))
    plt.boxplot(list(results.values()), tick_labels=labels, patch_artist=True)
    plt.title(f"Reconstruction Error Distribution ({direction})")
    plt.ylabel("Mean Squared Error (per sample)")
    plt.grid(True, axis="y", alpha=0.3)
    plt.xticks(rotation=15)
    plt_path = os.path.join(out_dir, f"boxplot_{direction}.png")
    plt.savefig(plt_path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Saved matplotlib plot to {plt_path}")

    go = _plotly_go()
    if go is None:
        return
    fig = go.Figure()
    for name, mses in results.items():
        fig.add_trace(go.Box(y=np.asarray(mses), name=name, boxpoints="outliers"))
    fig.update_layout(title=f"Reconstruction Error Distribution ({direction})",
                      yaxis_title="Mean Squared Error", xaxis_title="Model",
                      template="plotly_white")
    plotly_path = os.path.join(out_dir, f"boxplot_{direction}.html")
    fig.write_html(plotly_path)
    print(f"Saved plotly plot to {plotly_path}")


def compute_and_plot_tsne(data, site_labels, title, filename_prefix, plots_dir="plots",
                          device=None):
    """t-SNE of the predictions, coloured by site; returns the embedding."""
    print(f"Computing t-SNE for {title}...")
    tsne = TSNE(n_components=2, random_state=42, perplexity=min(30, len(data) - 1),
                device=device)
    emb = tsne.fit_transform(data)
    plt = _pyplot()
    if plt is None:
        return emb
    site_labels = np.asarray(site_labels)
    out_dir = os.path.join(plots_dir, "comparison")
    os.makedirs(out_dir, exist_ok=True)
    plt.figure(figsize=(12, 8))
    for site in np.unique(site_labels):
        sel = site_labels == site
        plt.scatter(emb[sel, 0], emb[sel, 1], label=site, s=100, alpha=0.7)
    plt.title(f"t-SNE: {title}")
    plt.grid(True, alpha=0.3)
    plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
    plt_path = os.path.join(out_dir, f"tsne_{filename_prefix}.png")
    plt.savefig(plt_path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Saved t-SNE plot to {plt_path}")

    go = _plotly_go()
    if go is None:
        return emb
    fig = go.Figure()
    for site in np.unique(site_labels):
        sel = site_labels == site
        fig.add_trace(go.Scatter(x=emb[sel, 0], y=emb[sel, 1], mode="markers", name=str(site),
                                 marker=dict(size=10, opacity=0.8)))
    fig.update_layout(title=f"t-SNE: {title}", template="plotly_white")
    fig.write_html(os.path.join(out_dir, f"tsne_{filename_prefix}.html"))
    return emb


def _run_direction(direction, X_train, y_train, X_val, y_val, site_train, site_val,
                   site_val_labels, vae_model, vae_input_kw, plots_dir, make_tsne=True,
                   device=None):
    """{"KNN (Base)", "KNN (Cond)"[, "VAE (Cond)"]: per-sample MSE} of one
    direction, with its plots."""
    print("\n" + "=" * 50)
    print(f"COMPARISON: {direction.replace('_to_', ' -> ')}")
    print("=" * 50)
    results = {}
    prefix = "rna2dna" if direction == "RNA_to_DNA" else "dna2rna"

    def record(name, preds, tag):
        results[name] = np.mean((preds - y_val) ** 2, axis=1)
        if make_tsne:
            compute_and_plot_tsne(preds, site_val_labels, f"{name} {direction}",
                                  f"{prefix}_{tag}", plots_dir, device)

    knn = optimize_knn(X_train, y_train, X_val, y_val, name="KNN (Base)", device=device)
    record("KNN (Base)", knn.predict(X_val), "knn_base")

    X_train_cond = np.column_stack([X_train, site_train])
    X_val_cond = np.column_stack([X_val, site_val])
    knn_cond = optimize_knn(X_train_cond, y_train, X_val_cond, y_val, name="KNN (Conditioned)",
                            model_class=ConditionedKNNRegressor, device=device)
    record("KNN (Cond)", knn_cond.predict(X_val_cond), "knn_cond")

    if vae_model is not None:
        vae_preds, _, _ = vae_model(site=site_val, **{vae_input_kw: X_val})
        record("VAE (Cond)", vae_preds, "vae_cond")

    create_boxplots(results, direction, plots_dir)
    return results


def main(cfg: Optional[Config] = None, make_tsne: bool = True, data=None, root: str = ".",
         device=None):
    """Both directions on the validation split. ``data`` is ``(tpm, beta,
    site)`` arrays; None reads ``cfg.data_dir``'s pickle and label encoder
    (without one the site labels are the site ids). The run-id files are
    read from ``root``. Runs on the card unless ``device="cpu"`` or
    ``cfg.platform == "cpu"`` asks for the CPU. Returns the two directions'
    {name: per-sample MSE}."""
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)
    dataset, label_encoder, tr_idx, va_idx = load_val_split(cfg, data)
    X_rna_train, X_rna_val = dataset.tpm_data[tr_idx], dataset.tpm_data[va_idx]
    X_dna_train, X_dna_val = dataset.beta_data[tr_idx], dataset.beta_data[va_idx]
    site_train, site_val = dataset.primary_site[tr_idx], dataset.primary_site[va_idx]
    site_val_labels = (site_val if label_encoder is None
                       else label_encoder.inverse_transform(site_val))

    rna2dna_model = load_rna2dna(cfg=cfg, root=root, device=device)
    dna2rna_model = load_dna2rna(cfg=cfg, root=root, device=device)

    results_rna2dna = _run_direction(
        "RNA_to_DNA", X_rna_train, X_dna_train, X_rna_val, X_dna_val, site_train, site_val,
        site_val_labels, rna2dna_model, "rna", cfg.plots_dir, make_tsne, device,
    )
    results_dna2rna = _run_direction(
        "DNA_to_RNA", X_dna_train, X_rna_train, X_dna_val, X_rna_val, site_train, site_val,
        site_val_labels, dna2rna_model, "dna", cfg.plots_dir, make_tsne, device,
    )
    print("\nComparison complete!")
    return results_rna2dna, results_dna2rna


if __name__ == "__main__":
    main()
