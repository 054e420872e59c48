"""k-fold cross-modal imputation benchmark (counterpart of
``vae_los_angeles_tpu/evaluation/cross_modality_cv.py``, the reference's
``vae_cross_modality_cv.py``).

Four model families in both directions on shared KFold indices: the mean
baseline, kNN (one pass a fold serves every swept k), the directional VAE
and the directional AE, with per-fold metrics (Mean R², Global R², MSE, MAE,
Cosine, per-sample Pearson), paired t-tests between the best models, a
summary table and plotly boxplots per metric
(``plots/plotly/cv_results_{metric}.html``).

Every fold of a (direction, family) trains at once as one population
(``parallel.vmap_meta.fit_folds``), each fold with the reference's inner
90/10 early-stopping split (``data.splits.cv_inner_split``) and its plateau
and early-stop schedule; the RNA→DNA VAEs' loss is the hand-written loss
pair. The folds' uneven sizes train as one masked population a family
(``POP_MASK_SIZES``, on by default; ``0`` groups them by exact size). With
unified families (the default wherever the masked populations are on, and on
the CPU) a direction's VAE and AE are the
``*_unified`` task driven twice, ``kl_on = 1`` and ``kl_on = 0``; the VAE
half reuses the standalone VAE sweep's seeds and so equals it, the AE half
is the VAE's trunk with z = mu and no KL term (JAX ``training/tasks.py``).

Everything runs on the card unless the CPU is asked for (``device="cpu"``
or ``DEVICE=cpu``). The card's machine has no pandas: `tidy_results` and
`pairwise_tests` return lists of row dicts (the JAX frames' columns),
``main(data=(tpm, beta, site))`` takes arrays, the ``.pkl`` is read by
``data.artifacts`` (the port's pandas-free form anywhere, the JAX
package's frame where pandas is installed), and plotly is imported only
where it draws; a line says when it is missing.

    python -m vae_los_angeles_torch.evaluation.cross_modality_cv --folds 5 --epochs 3
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import cv_inner_split, kfold_indices
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops.knn import KNNRegressor
from vae_los_angeles_torch.ops.metrics import METRIC_NAMES, compute_cv_metrics
from vae_los_angeles_torch.parallel import comm, vmap_meta
from vae_los_angeles_torch.training import engine

DIRECTIONS = ("RNA -> DNA", "DNA -> RNA")


class MeanRegressor:
    """Predicts the training targets' column means (reference :58-69)."""

    def __init__(self):
        self.mean_vector = None

    def fit(self, X, y):
        self.mean_vector = np.mean(y, axis=0)

    def predict(self, X):
        return np.tile(self.mean_vector, (X.shape[0], 1))


def parse_args(argv=None, device=None):
    p = argparse.ArgumentParser(description="Cross-modality CV benchmark")
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--subset", type=float, default=1.0, help="fraction of the dataset to use")
    p.add_argument("--neighbors", type=int, nargs="+", default=[5, 10])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--data_path", type=str, default="data/processed_data.pkl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--unified-families", action="store_true", default=None,
                   help="train each direction's VAE and AE folds as the *_unified task "
                   "(kl_on 1 and 0); the VAE half equals the separate VAE sweep. Default: "
                   "CV_UNIFIED_FAMILIES (1/0/auto; auto is on with POP_MASK_SIZES or on the "
                   "CPU)")
    p.add_argument("--no-unified-families", dest="unified_families", action="store_false",
                   help="train the VAE and AE families as separate tasks")
    args = p.parse_args(argv)
    args.unified_families = resolve_unified_families(args.unified_families, device)
    return args


def resolve_unified_families(explicit=None, device=None) -> bool:
    """``CV_UNIFIED_FAMILIES``: '1'/'0' force; 'auto' (the default) is the
    JAX package's rule, on wherever the masked populations are
    (``vmap_meta.mask_sizes_enabled``) and on the CPU (``device``, else
    ``DEVICE``); an explicit flag wins."""
    if explicit is not None:
        return bool(explicit)
    env = os.getenv("CV_UNIFIED_FAMILIES", "auto").strip().lower()
    if env in ("1", "true", "on"):
        return True
    if env in ("0", "false", "off"):
        return False
    if env != "auto":
        raise ValueError(f"CV_UNIFIED_FAMILIES={env!r}; valid: 1, 0, auto (default)")
    on_cpu = (torch.device(device).type == "cpu" if device is not None
              else (Config.from_env().platform or "").lower() == "cpu")
    return vmap_meta.mask_sizes_enabled() or on_cpu


def subset_rows(n: int, frac: float) -> np.ndarray:
    """The rows of pandas' ``df.sample(frac=frac, random_state=42)`` of an
    n-row frame, in its order: ``RandomState(42).choice(n, round(frac·n),
    replace=False)``."""
    return np.random.RandomState(42).choice(n, size=round(frac * n), replace=False)


def load_data(data_path, subset=1.0):
    """(tpm, beta, site) of the processed pickle (either package's), a
    ``subset`` of its rows."""
    dataset = MultiModalDataset.from_pickle(data_path)
    return _subset((dataset.tpm_data, dataset.beta_data, dataset.primary_site), subset)


def _subset(data, subset):
    if subset >= 1.0:
        return data
    rows = subset_rows(len(data[0]), subset)
    return tuple(np.asarray(a)[rows] for a in data)


def _aggregate_sweep(direction_name, model, param_name, param_value, elapsed, fold_metrics,
                     quiet=False):
    """One sweep's result record, the schema the summary, `tidy_results`
    and `pairwise_tests` read."""
    aggregated = {"direction": direction_name, "model": model, "param_name": param_name,
                  "param_value": param_value, "time": elapsed, "fold_metrics": fold_metrics}
    for name in fold_metrics:
        aggregated[f"mean_{name}"] = float(np.mean(fold_metrics[name]))
        aggregated[f"std_{name}"] = float(np.std(fold_metrics[name]))
    if not quiet:
        print(f"    Mean R2 = {aggregated['mean_Mean R2']:.4f} "
              f"(+/- {aggregated['std_Mean R2']:.4f})")
        print(f"    MSE     = {aggregated['mean_MSE']:.4f} (+/- {aggregated['std_MSE']:.4f})")
    return aggregated


def _direction(direction_name, X, y):
    """(is_rna2dna, RNA table, DNA table) of a direction."""
    if direction_name not in DIRECTIONS:
        raise ValueError(f"unknown direction {direction_name!r}")
    is_rna2dna = direction_name == "RNA -> DNA"
    return is_rna2dna, (X if is_rna2dna else y), (y if is_rna2dna else X)


def _prep_nn_folds(rna_all, dna_all, site, fold_indices, batch_size, device):
    """The config and each fold's inner train, inner validation and outer
    validation tables, gathered on the device from one copy of the cohort."""
    cfg = Config.from_env().replace(input_dim_a=rna_all.shape[1], input_dim_b=dna_all.shape[1],
                                    batch_size=batch_size)
    cohort = tuple(torch.as_tensor(np.asarray(a)).to(device) for a in (rna_all, dna_all))
    cohort += (torch.as_tensor(np.asarray(site, np.int64)).to(device),)

    def take(idx):
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(device)
        return tuple(t.index_select(0, idx) for t in cohort)

    inner_train, inner_val, outer_val = [], [], []
    for train_index, val_index in fold_indices:
        tr_in, va_in = cv_inner_split(train_index)
        inner_train.append(take(tr_in))
        inner_val.append(take(va_in))
        outer_val.append(take(val_index))
    return cfg, inner_train, inner_val, outer_val


def _score_folds(task_name, fits, outer_val, is_rna2dna, cfg, device):
    """Per-fold metrics of the fits' predictions on the outer validation rows."""
    fold_metrics = {k: [] for k in METRIC_NAMES}
    for fit_res, val in zip(fits, outer_val):
        pred = engine.predict(task_name, fit_res.params, fit_res.state, val,
                              compute_dtype=cfg.compute_dtype, device=device)
        m = compute_cv_metrics(val[1] if is_rna2dna else val[0], pred, device)
        for k in METRIC_NAMES:
            fold_metrics[k].append(m[k])
    return fold_metrics


def run_cross_validation(X, y, site, k_values, fold_indices, direction_name, model_type="knn",
                         epochs=10, batch_size=32, seed=0, device=None):
    """One (direction, family) sweep over all folds (reference :285-414)."""
    print(f"\nRunning Cross-Validation for {direction_name} ({model_type})...")
    if model_type == "knn":
        params_to_test, param_name = k_values, "k"
    elif model_type in ("vae", "ae"):
        params_to_test, param_name = [epochs], "epochs"
    elif model_type == "mean":
        params_to_test, param_name = [0], "dummy"  # the reference's label
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    is_rna2dna, rna_all, dna_all = _direction(direction_name, X, y)
    device = resolve_device(device, Config.from_env())

    if model_type == "knn":
        # one distance pass and one top-k(max k) a fold serve every swept k
        print("  Testing " + ", ".join(f"k={p}" for p in params_to_test)
              + " (one pass per fold)...")
        start_time = time.time()
        per_param = {p: {k: [] for k in METRIC_NAMES} for p in params_to_test}
        X_d, y_d = (torch.as_tensor(np.asarray(a, np.float32)).to(device) for a in (X, y))
        for train_index, val_index in fold_indices:
            tr = torch.as_tensor(train_index).to(device)
            va = torch.as_tensor(val_index).to(device)
            model = KNNRegressor(device=device).fit(X_d[tr], y_d[tr])
            preds = model.predict_multi_k(X_d[va], params_to_test)
            for param in params_to_test:
                m = compute_cv_metrics(y_d[va], preds[min(param, len(train_index))], device)
                for k in METRIC_NAMES:
                    per_param[param][k].append(m[k])
        elapsed = time.time() - start_time
        return [_aggregate_sweep(direction_name, model_type, param_name, param, elapsed,
                                 per_param[param]) for param in params_to_test]

    results = []
    for param in params_to_test:
        label = f"{param_name}={param}" if model_type != "mean" else "Mean Baseline"
        print(f"  Testing {label}...")
        start_time = time.time()
        if model_type == "mean":
            fold_metrics = {k: [] for k in METRIC_NAMES}
            for train_index, val_index in fold_indices:
                model = MeanRegressor()
                model.fit(X[train_index], y[train_index])
                m = compute_cv_metrics(y[val_index], model.predict(X[val_index]), device)
                for k in METRIC_NAMES:
                    fold_metrics[k].append(m[k])
        else:
            task_name = ("rna2dna" if is_rna2dna else "dna2rna") + (
                "_ae" if model_type == "ae" else "")
            cfg, inner_train, inner_val, outer_val = _prep_nn_folds(
                rna_all, dna_all, site, fold_indices, batch_size, device)
            fits = vmap_meta.fit_folds(task_name, cfg, inner_train, inner_val, seed,
                                       int(site.max() + 1), num_epochs=param, drop_last=False,
                                       mesh=vmap_meta.population_mesh(), device=device)
            fold_metrics = _score_folds(task_name, fits, outer_val, is_rna2dna, cfg, device)
        elapsed = time.time() - start_time
        results.append(_aggregate_sweep(direction_name, model_type, param_name, param, elapsed,
                                        fold_metrics))
    return results


def run_unified_direction(X, y, site, fold_indices, direction_name, epochs=10, batch_size=32,
                          seed=0, device=None):
    """One direction's VAE and AE folds through the ``*_unified`` task, one
    population call with ``kl_on = 1`` (at the standalone VAE sweep's seeds,
    so equal to it) and one with ``kl_on = 0``. Returns the two records the
    separate sweeps give; their ``time`` is the two calls' combined wall."""
    print(f"\nRunning unified VAE+AE Cross-Validation for {direction_name}...")
    is_rna2dna, rna_all, dna_all = _direction(direction_name, X, y)
    task_name = ("rna2dna" if is_rna2dna else "dna2rna") + "_unified"
    device = resolve_device(device, Config.from_env())
    start_time = time.time()
    cfg, inner_train, inner_val, outer_val = _prep_nn_folds(
        rna_all, dna_all, site, fold_indices, batch_size, device)
    n_folds = len(fold_indices)
    family_metrics = {}
    for family, kl_on in (("vae", 1.0), ("ae", 0.0)):
        fits = vmap_meta.fit_folds(
            task_name, cfg, inner_train, inner_val, seed, int(site.max() + 1),
            num_epochs=epochs, drop_last=False, seeds=vmap_meta.member_seeds(seed, n_folds),
            state_overrides={"kl_on": np.full(n_folds, kl_on, np.float32)},
            mesh=vmap_meta.population_mesh(), device=device)
        family_metrics[family] = _score_folds(task_name, fits, outer_val, is_rna2dna, cfg,
                                              device)
    elapsed = time.time() - start_time
    results = []
    for family in ("vae", "ae"):
        aggregated = _aggregate_sweep(direction_name, family, "epochs", epochs, elapsed,
                                      family_metrics[family], quiet=True)
        print(f"  [{family}] Mean R2 = {aggregated['mean_Mean R2']:.4f} "
              f"(+/- {aggregated['std_Mean R2']:.4f}), MSE = {aggregated['mean_MSE']:.4f}")
        results.append(aggregated)
    return results


def _config_label(res) -> str:
    """Display label of a swept configuration, e.g. "knn (k=5)"."""
    if res["model"] == "knn":
        return f"knn (k={res['param_value']})"
    if res["model"] in ("vae", "ae"):
        return f"{res['model']} (ep={res['param_value']})"
    return res["model"]


def tidy_results(results):
    """Long-form scores: one row dict per (direction, model, config, fold,
    metric), the columns of the JAX frame."""
    return [{"Direction": res["direction"], "Model": res["model"], "Config": _config_label(res),
             "Fold": fold, "Metric": metric, "Score": score}
            for res in results for metric, scores in res["fold_metrics"].items()
            for fold, score in enumerate(scores)]


# The pairings the reference reports (vae_cross_modality_cv.py:485-513):
# each tuple is (A, B) for a paired t-test on A's vs B's per-fold scores.
_TEST_PAIRS = (("ae", "vae"), ("ae", "knn"), ("vae", "mean"), ("vae", "knn"))
_HIGHER_BETTER_TOKENS = ("R2", "Cosine", "Pearson")


def pairwise_tests(results, metric="Mean R2"):
    """Paired t-tests between the per-direction best configurations: a list
    of rows (Direction, A, B, A_config, B_config, A_mean, B_mean, t, p,
    winner); winner is the significantly better side at p < 0.05, else None.
    The reference's quirk is kept: each family's best configuration is
    chosen by Mean R2 for EVERY compared metric
    (vae_cross_modality_cv.py:466-468)."""
    from scipy import stats

    higher_better = any(tok in metric for tok in _HIGHER_BETTER_TOKENS)
    rows = []
    for direction in sorted({r["direction"] for r in results}):
        best = {}
        for r in results:
            if r["direction"] != direction:
                continue
            cur = best.get(r["model"])
            if cur is None or r["mean_Mean R2"] > cur["mean_Mean R2"]:
                best[r["model"]] = r
        if "knn" not in best or "vae" not in best:
            continue  # reference :476-477 skips directions missing either
        for a, b in _TEST_PAIRS:
            if a not in best or b not in best:
                continue
            sa, sb = best[a]["fold_metrics"][metric], best[b]["fold_metrics"][metric]
            t, p = stats.ttest_rel(sa, sb)
            ma, mb = float(np.mean(sa)), float(np.mean(sb))
            winner = None
            if p < 0.05:
                winner = (a if ma > mb else b) if higher_better else (a if ma < mb else b)
            rows.append({"Direction": direction, "A": a, "B": b,
                         "A_config": _config_label(best[a]), "B_config": _config_label(best[b]),
                         "A_mean": ma, "B_mean": mb, "t": float(t), "p": float(p),
                         "winner": winner})
    return rows


def perform_statistical_comparison(results, metric="Mean R2"):
    """Print the paired-t-test table of one metric (the reference's console
    report, :453-530) and return its rows."""
    tests = pairwise_tests(results, metric)
    print("\n" + "=" * 80)
    print(f"STATISTICAL COMPARISON (Paired t-test) on {metric}")
    print("=" * 80)
    if not tests:
        print("(needs at least one knn and one vae result per direction)")
        return tests
    for direction in sorted({row["Direction"] for row in tests}):
        print(f"\nDirection: {direction}")
        for row in tests:
            if row["Direction"] != direction:
                continue
            print(f"  {row['A_config']} vs {row['B_config']} on {metric}: "
                  f"{row['A_mean']:.4f} vs {row['B_mean']:.4f} | "
                  f"t={row['t']:.4f}, p={row['p']:.4e}"
                  + (f"  -> {row['winner']} significantly better" if row["winner"]
                     else "  -> no significant difference (p >= 0.05)"))
    return tests


@comm.writes_files
def create_plotly_plots(results, output_dir="plots/plotly"):
    """Per-metric boxplots of the tidy rows, one trace a direction (the
    reference's artifact names: cv_results_{metric}.html)."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        print("plotly unavailable; skipping CV plots")
        return
    print(f"Creating Plotly plots in {output_dir}...")
    os.makedirs(output_dir, exist_ok=True)
    rows = tidy_results(results)
    for metric in dict.fromkeys(row["Metric"] for row in rows):
        fig = go.Figure()
        for direction in dict.fromkeys(row["Direction"] for row in rows):
            sub = [row for row in rows if row["Metric"] == metric
                   and row["Direction"] == direction]
            fig.add_trace(go.Box(x=[row["Config"] for row in sub],
                                 y=[row["Score"] for row in sub], name=direction,
                                 boxpoints="all"))
        fig.update_layout(template="plotly_white", title=f"Cross-Validation {metric}",
                          boxmode="group", xaxis_title="Config", yaxis_title="Score")
        safe = metric.lower().replace(" ", "_")
        fig.write_html(f"{output_dir}/cv_results_{safe}.html")
    print("Plotly plots saved.")


def print_summary(all_results):
    print("\n" + "=" * 120)
    print("FINAL RESULTS SUMMARY (Mean R2 & MSE)")
    print("(VAE/AE times are their fold populations' training and scoring on the device)")
    print("=" * 120)
    print(f"{'Direction':<12} | {'Model':<5} | {'Param':<10} | {'Mean R2':<10} | "
          f"{'Std':<8} | {'MSE':<10} | {'Std':<8} | {'Time (s)':<8}")
    print("-" * 120)
    for res in all_results:
        print(f"{res['direction']:<12} | {res['model']:<5} | "
              f"{res['param_name']}={res['param_value']:<6} | "
              f"{res['mean_Mean R2']:<10.4f} | {res['std_Mean R2']:<8.4f} | "
              f"{res['mean_MSE']:<10.4f} | {res['std_MSE']:<8.4f} | {res['time']:<8.2f}")
    print("=" * 120)


def main(argv=None, data=None, device=None):
    """The whole benchmark. ``data`` is (tpm, beta, site) arrays (``--subset``
    applies to them as to the pickle); None reads ``--data_path``.
    Runs on the card unless ``device="cpu"`` or ``DEVICE=cpu``. Returns the
    result records in the report's order."""
    args = parse_args(argv, device)
    comm.ensure_group(device, Config.from_env())
    device = resolve_device(device, Config.from_env())
    if data is None:
        rna_data, dna_data, site_data = load_data(args.data_path, args.subset)
    else:
        rna_data, dna_data, site_data = _subset(
            tuple(np.asarray(a) for a in data), args.subset)
    rna_data = np.asarray(rna_data, np.float32)
    dna_data = np.asarray(dna_data, np.float32)
    site_data = np.asarray(site_data)

    print(f"\nGenerating {args.folds} folds to be used across all models...")
    fold_indices = kfold_indices(len(rna_data), args.folds, seed=42)

    common = dict(epochs=args.epochs, batch_size=args.batch_size, seed=args.seed,
                  device=device)
    sweeps = []  # (callable, args, kwargs)
    for direction, X, y in (("DNA -> RNA", dna_data, rna_data),
                            ("RNA -> DNA", rna_data, dna_data)):
        sweeps += [
            (run_cross_validation, (X, y, site_data, [], fold_indices, direction, "mean"),
             {"device": device}),
            (run_cross_validation,
             (X, y, site_data, args.neighbors, fold_indices, direction, "knn"),
             {"device": device}),
        ]
        if args.unified_families:
            sweeps.append((run_unified_direction, (X, y, site_data, fold_indices, direction),
                           common))
        else:
            sweeps += [(run_cross_validation,
                        (X, y, site_data, [], fold_indices, direction, fam), common)
                       for fam in ("vae", "ae")]
    all_results = []
    for fn, a, kw in sweeps:
        all_results.extend(fn(*a, **kw))

    print_summary(all_results)
    for metric in ("Mean R2", "MSE", "Pearson"):
        perform_statistical_comparison(all_results, metric=metric)
    create_plotly_plots(all_results)
    return all_results


if __name__ == "__main__":
    main()
