"""Imputation metrics (counterpart of ``vae_los_angeles_tpu/ops/metrics.py``).

Torch reductions over the batch, with the JAX package's conventions (which
are sklearn's/scipy's):

  * R² over the flattened arrays, 0 when the truth is constant;
  * per-sample Pearson r over each row, rows with zero variance masked out
    (the reference skips NaN correlations), std is the population std;
  * cosine similarity of matching rows, a zero-norm row contributing 0;
  * ``r2_mean`` the uniform average of per-column R² (sklearn's multioutput
    default), a constant column scoring 1.0 when its residual is < 1e-12
    and 0.0 otherwise, as sklearn does.

`compute_imputation_metrics` is the dict of the reference's
``compare_directional_imputation.py``, `compute_cv_metrics` that of its
``vae_cross_modality_cv.py`` (``METRIC_NAMES``).

`classification_report` is sklearn's ``classification_report(...,
output_dict=True)`` in numpy (the downstream classifiers' scores; the
card's machine has no sklearn), and `format_report` its text form.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(a, device=None):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device or a.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


METRIC_NAMES = ["Mean R2", "Global R2", "MSE", "MAE", "Cosine Sim", "Pearson"]


def mse(y_true, y_pred):
    return torch.square(y_true - y_pred).mean()


def mae(y_true, y_pred):
    return torch.abs(y_true - y_pred).mean()


def r2_mean(y_true, y_pred):
    """Uniform average of per-column R², with sklearn's constant-column rule."""
    ss_res = torch.sum(torch.square(y_true - y_pred), dim=0)
    ss_tot = torch.sum(torch.square(y_true - y_true.mean(dim=0)), dim=0)
    degenerate = torch.where(ss_res < 1e-12, 1.0, 0.0)
    cols = torch.where(ss_tot > 0, 1.0 - ss_res / torch.where(ss_tot > 0, ss_tot, 1.0),
                       degenerate)
    return cols.mean()


def r2_global(y_true, y_pred):
    yt, yp = y_true.reshape(-1), y_pred.reshape(-1)
    ss_res = torch.sum(torch.square(yt - yp))
    ss_tot = torch.sum(torch.square(yt - yt.mean()))
    return torch.where(ss_tot > 0, 1.0 - ss_res / torch.where(ss_tot > 0, ss_tot, 1.0), 0.0)


def cosine_rowwise_mean(y_true, y_pred):
    t_norm = torch.linalg.vector_norm(y_true, dim=1, keepdim=True)
    p_norm = torch.linalg.vector_norm(y_pred, dim=1, keepdim=True)
    tn = y_true / torch.where(t_norm > 0, t_norm, 1.0)
    pn = y_pred / torch.where(p_norm > 0, p_norm, 1.0)
    return torch.sum(tn * pn, dim=1).mean()


def pearson_per_sample(y_true, y_pred):
    """Per-row Pearson r and a validity mask (False where undefined)."""
    y_true, y_pred = _as_tensor(y_true), _as_tensor(y_pred)
    tc = y_true - y_true.mean(dim=1, keepdim=True)
    pc = y_pred - y_pred.mean(dim=1, keepdim=True)
    num = torch.sum(tc * pc, dim=1)
    den = torch.sqrt(torch.sum(torch.square(tc), dim=1) * torch.sum(torch.square(pc), dim=1))
    valid = den > 0
    r = torch.where(valid, num / torch.where(valid, den, 1.0), 0.0)
    return r, valid


def pearson_mean_std(y_true, y_pred):
    """Mean and population std of the valid per-sample correlations."""
    r, valid = pearson_per_sample(y_true, y_pred)
    n = torch.clamp(valid.sum(), min=1)
    mean = torch.where(valid, r, 0.0).sum() / n
    var = torch.where(valid, torch.square(r - mean), 0.0).sum() / n
    return mean, torch.sqrt(var)


def compute_imputation_metrics(y_true, y_pred, modality_name=None, model_name=None,
                               device=None):
    """Metric dict of the reference's ``compare_directional_imputation.py``:
    MAE, MSE, RMSE, R2, CosineSimilarity, PearsonMean, PearsonStd (floats),
    after ``Modality``/``Model`` when given. Computed on ``device`` (the
    inputs' own when None)."""
    y_true, y_pred = _as_tensor(y_true, device), _as_tensor(y_pred, device)
    diff = y_true - y_pred
    mse = torch.square(diff).mean()
    pm, ps = pearson_mean_std(y_true, y_pred)
    vals = {
        "MAE": diff.abs().mean(),
        "MSE": mse,
        "RMSE": torch.sqrt(mse),
        "R2": r2_global(y_true, y_pred),
        "CosineSimilarity": cosine_rowwise_mean(y_true, y_pred),
        "PearsonMean": pm,
        "PearsonStd": ps,
    }
    out = {}
    if modality_name is not None:
        out["Modality"] = modality_name
    if model_name is not None:
        out["Model"] = model_name
    host = torch.stack(list(vals.values())).cpu().tolist()  # one device→host copy
    out.update(zip(vals, host))
    return out


def compute_cv_metrics(y_true, y_pred, device=None):
    """The six ``METRIC_NAMES`` as Python floats (the reference's
    ``vae_cross_modality_cv.py:101-108``), computed on ``device`` (the
    inputs' own when None)."""
    y_true, y_pred = _as_tensor(y_true, device), _as_tensor(y_pred, device)
    vals = torch.stack([r2_mean(y_true, y_pred), r2_global(y_true, y_pred),
                        mse(y_true, y_pred), mae(y_true, y_pred),
                        cosine_rowwise_mean(y_true, y_pred),
                        pearson_mean_std(y_true, y_pred)[0]])
    return dict(zip(METRIC_NAMES, vals.cpu().tolist()))  # one device→host copy


REPORT_STATS = ("precision", "recall", "f1-score", "support")


def _divide(num, den, zero_division):
    """``num / den`` in float64, ``zero_division`` where ``den`` is 0."""
    den = np.asarray(den, dtype=np.float64)
    zero = den == 0
    out = np.asarray(num, dtype=np.float64) / np.where(zero, 1.0, den)
    out[zero] = zero_division
    return out


def _scores(tp, pred, true, zero_division):
    precision = _divide(tp, pred, zero_division)
    recall = _divide(tp, true, zero_division)
    f1 = _divide(2.0 * np.asarray(tp, np.float64),
                 np.asarray(true, np.float64) + np.asarray(pred, np.float64), zero_division)
    return precision, recall, f1


def classification_report(y_true, y_pred, labels, target_names=None, zero_division=0.0):
    """sklearn's ``classification_report(y_true, y_pred, labels=labels,
    target_names=target_names, output_dict=True, zero_division=...)`` for
    integer class codes: a dict by target name of precision, recall,
    f1-score and support (floats), then ``accuracy`` (a float; "micro avg"
    as a dict when ``labels`` leave out a label that occurs), "macro avg"
    and "weighted avg" (weighted by support; unweighted when no label has
    support). A class with no predictions or no support scores
    ``zero_division``."""
    y_true, y_pred, labels = (np.asarray(a).astype(np.int64) for a in (y_true, y_pred, labels))
    names = [str(v) for v in labels] if target_names is None else list(target_names)
    if len(names) != len(labels):
        raise ValueError(f"{len(labels)} labels but {len(names)} target names")
    true = np.array([np.sum(y_true == v) for v in labels], dtype=np.int64)
    pred = np.array([np.sum(y_pred == v) for v in labels], dtype=np.int64)
    tp = np.array([np.sum((y_true == v) & (y_pred == v)) for v in labels], dtype=np.int64)
    precision, recall, f1 = _scores(tp, pred, true, zero_division)
    report = {name: dict(zip(REPORT_STATS, (float(p), float(r), float(f), float(s))))
              for name, p, r, f, s in zip(names, precision, recall, f1, true)}
    support = float(np.sum(true))
    micro = _scores(tp.sum(keepdims=True), pred.sum(keepdims=True), true.sum(keepdims=True),
                    zero_division)
    if set(labels.tolist()) >= set(np.union1d(y_true, y_pred).tolist()):
        report["accuracy"] = float(micro[0][0])
    else:
        report["micro avg"] = dict(zip(REPORT_STATS, [float(m[0]) for m in micro] + [support]))
    report["macro avg"] = dict(zip(REPORT_STATS, [float(np.mean(m)) for m in
                                                  (precision, recall, f1)] + [support]))
    weights = true if true.sum() > 0 else None
    report["weighted avg"] = dict(zip(REPORT_STATS, [float(np.average(m, weights=weights)) for m
                                                     in (precision, recall, f1)] + [support]))
    return report


def format_report(report, digits: int = 2) -> str:
    """The text form of a `classification_report` dict, laid out as
    sklearn's."""
    avgs = ("accuracy", "micro avg", "macro avg", "weighted avg")
    names = [str(k) for k in report if k not in avgs]
    width = max([len(n) for n in names] + [len("weighted avg"), digits])
    head = f"{'':>{width}s} " + "".join(f" {h:>9}" for h in REPORT_STATS)
    lines = [head, ""]

    def row(name, rec):
        return (f"{name:>{width}s} " + "".join(f" {rec[h]:>9.{digits}f}" for h in REPORT_STATS[:3])
                + f" {int(rec['support']):>9}")

    lines += [row(str(k), v) for k, v in report.items() if k not in avgs]
    lines.append("")
    support = int(report["weighted avg"]["support"])
    if "accuracy" in report:
        lines.append(f"{'accuracy':>{width}s} " + f" {'':>9}" * 2
                     + f" {report['accuracy']:>9.{digits}f} {support:>9}")
    for k in ("micro avg", "macro avg", "weighted avg"):
        if k in report:
            lines.append(row(k, report[k]))
    return "\n".join(lines) + "\n"
