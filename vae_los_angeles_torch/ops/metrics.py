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
