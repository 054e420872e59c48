"""Brute-force k-nearest-neighbours regression on the card (counterpart of
``vae_los_angeles_tpu/ops/knn.py``).

The reference's kNN baselines are host sklearn; at methylome width (450,000
β-values) brute force on the host takes minutes. Here the same exact
computation runs on the device: the squared euclidean distance matrix is one
product, ‖q − x‖² = ‖q‖² − 2 q·xᵀ + ‖x‖², in true fp32 (TF32 stays off:
importing ``vae_los_angeles_torch.device`` turns it off, and a TF32 product
picks other neighbours), the manhattan one a direct sum (`torch.cdist`,
p = 1, which builds no (m, n, feature) block). ``torch.topk`` selects the
neighbours in ascending distance; the winners' true distances are computed
again directly, so that a query equal to a training row gets exactly 0 and
sklearn's zero-distance rule fires.

  * `KNNRegressor`: the ``KNeighborsRegressor`` surface the scripts use
    (fit/predict/get_params/set_params, n_neighbors, weights in {uniform,
    distance}, metric euclidean or manhattan), plus ``predict_multi_k``;
  * `ConditionedKNNRegressor`: the site-conditioned baseline as one masked
    distance matrix (the last column of X is the site; cross-site pairs are
    +inf, so per-site k clamping and the zero rows of unseen sites fall out);
  * `knn_grid_mse`: every (k, weights) combination's validation MSE from one
    distance pass and one top-k.

The neighbours' targets are never gathered into an (m, k, t) block: the
weighted sums and the grid's prefix sums run slot by slot over the k sorted
neighbours, keeping (m, t) running sums (`_slot_sum`,
`_prefix_predictions`). The function is the JAX package's; only the memory
layout differs, and at RNA→DNA's 450,000 targets the (m, K, t) form would
not fit on one card.

Unlike the JAX package there is no host route (``EVAL_BACKEND``): the card's
machine has no sklearn, so every resolver returns this module's classes. The
estimators run on ``device.resolve_device(device)``: the card, unless the
caller asks for the CPU. ``fit`` and ``predict`` take numpy arrays or torch
tensors (a tensor already on the device is not copied). ``n_jobs`` is
accepted and ignored.

Several devices (`_eval_mesh`, the JAX policy): under a process group of two
or more ranks the training rows shard over the ranks and every pass runs the
row-sharded program of ``parallel.sharded_eval`` (every rank calls with the
same arguments and gets the whole result); ``shard=False`` keeps one device,
``shard=True`` on one rank raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_los_angeles_torch.device import resolve_device

CHUNK = 4096  # query rows a predict pass
GRID_CHUNK = 512  # query rows a grid pass
TINY = 1e-30


def _eval_mesh(shard=None):
    """The 1-axis ("data",) mesh the evaluation programs shard over, or None:
    ``shard=None`` shards when the process group has two or more ranks,
    ``False`` keeps one device, ``True`` requires a mesh."""
    if shard is False:
        return None
    from vae_los_angeles_torch.parallel.vmap_meta import population_mesh

    mesh = population_mesh()
    if shard is True and mesh is None:
        raise ValueError("shard=True requires more than one visible device")
    return mesh


def _sharded_eval():
    from vae_los_angeles_torch.parallel import sharded_eval

    return sharded_eval


def _to_device(a, device) -> torch.Tensor:
    """fp32 tensor on ``device`` from a numpy array, a list or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)


def _split_sites(X, device):
    """(features, int64 sites) of a matrix whose last column is the site."""
    X = _to_device(X, device)
    return X[:, :-1].contiguous(), X[:, -1].to(torch.int64)


def _check_metric(metric: str) -> str:
    """Normalize the sklearn metric spelling to {euclidean, manhattan}."""
    if metric in ("minkowski", "euclidean", "l2"):
        return "euclidean"
    if metric in ("manhattan", "cityblock", "l1"):
        return "manhattan"
    raise ValueError(
        f"unsupported metric {metric!r} (euclidean/minkowski p=2 or manhattan/cityblock)")


def _l1_dists(x_train, queries):
    """Manhattan distance matrix Σⱼ|qⱼ − xⱼ| as (m, n), fp32, summed
    directly (identical rows give exactly 0) without an (m, n, feature)
    block."""
    return torch.cdist(queries, x_train, p=1.0)


def _selection_dists(x_train, queries, metric: str):
    """Distance matrix in selection space: squared euclidean through the
    product identity, clamped at 0, or manhattan. Either ranks as the true
    distance does."""
    if metric == "manhattan":
        return _l1_dists(x_train, queries)
    q_sq = torch.sum(queries * queries, dim=1, keepdim=True)
    x_sq = torch.sum(x_train * x_train, dim=1)
    cross = torch.matmul(queries, x_train.T)
    return torch.clamp_min(q_sq - 2.0 * cross + x_sq, 0.0)


def _exact_topk_d2(x_train, queries, idx, k: int):
    """‖q − xᵢ‖² of the k selected neighbours, computed directly (the
    product identity leaves ~eps·‖q‖² of cancellation where the true value
    is 0)."""
    cols = []
    for j in range(k):
        diff = queries - x_train.index_select(0, idx[:, j])
        cols.append(torch.sum(diff * diff, dim=1))
    return torch.stack(cols, dim=1)


def _winner_dists(x_train, queries, idx, sel, k: int, metric: str):
    """True distances of the k selected neighbours: euclidean recomputed
    directly, manhattan gathered from the (already exact) selection matrix,
    masked (+inf) entries as 0."""
    if metric == "manhattan":
        d = torch.gather(sel, 1, idx)
        return torch.where(torch.isfinite(d), d, 0.0)
    return torch.sqrt(_exact_topk_d2(x_train, queries, idx, k))


def _select(x_train, queries, k: int, metric: str, x_site=None, q_site=None):
    """(selection matrix, validity (m, k), indices (m, k)) of the k nearest
    training rows a query, ascending. With sites, cross-site pairs are +inf:
    their slots are invalid and may point at any row."""
    sel = _selection_dists(x_train, queries, metric)
    if x_site is not None:
        sel = torch.where(q_site[:, None] == x_site[None, :], sel, torch.inf)
    top, idx = torch.topk(sel, k, dim=1, largest=False, sorted=True)
    return sel, torch.isfinite(top), idx


def _slot_sum(w, idx, y_train):
    """Σⱼ w[:, j] · y[idx[:, j]] as (m, t), one neighbour slot at a time."""
    out = torch.zeros(idx.shape[0], y_train.shape[1], device=y_train.device)
    for j in range(idx.shape[1]):
        out.addcmul_(w[:, j:j + 1], y_train.index_select(0, idx[:, j]))
    return out


def _distance_weights(d, valid):
    """sklearn's ``distance`` weights over the valid slots: 1/d, or, where a
    valid neighbour lies at distance 0, uniform weights over those only."""
    zero = valid & (d <= 0.0)
    any_zero = torch.any(zero, dim=1, keepdim=True)
    inv = torch.where(valid, 1.0 / torch.where(zero | ~valid, 1.0, d), 0.0)
    return torch.where(any_zero, zero.to(d.dtype), inv)


def _knn_chunk(x_train, y_train, queries, k: int, weights: str, metric: str, x_site=None,
               q_site=None):
    """Neighbour-mean predictions of one query chunk. With sites (the
    conditioned kNN) a site with g < k training rows has g valid slots, and
    a site unseen at fit time none: its rows predict 0."""
    sel, valid, idx = _select(x_train, queries, k, metric, x_site, q_site)
    if weights == "uniform":
        w = valid.to(torch.float32)
    else:
        w = _distance_weights(_winner_dists(x_train, queries, idx, sel, k, metric), valid)
    w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), TINY)
    return _slot_sum(w, idx, y_train)


def _neighbours(x_train, queries, kmax: int, metric: str, x_site=None, q_site=None):
    """(true distances, validity, indices) of the kmax nearest training rows
    a query, ascending."""
    sel, valid, idx = _select(x_train, queries, kmax, metric, x_site, q_site)
    return _winner_dists(x_train, queries, idx, sel, kmax, metric), valid, idx


def _prefix_predictions(d, valid, idx, y_train, ks, modes, owned=None):
    """Every (k, weights) combination's predictions from one sorted top-K
    neighbour set, yielded as ((k, mode), (m, t) prediction) in ascending k.

    Because the slots are sorted, each k's prediction is a prefix
    reduction (as the JAX package's three cumulative sums):
      * uniform:  pred(k) = Σ_{j<k} vⱼ·yⱼ / Σ_{j<k} vⱼ;
      * distance: the zero-distance valid neighbours of the first k,
        averaged, if there are any; else 1/d weights over the valid prefix.
    An all-invalid prefix (unseen site) predicts 0. The sums are kept as
    running (m, t) tensors over the slots j = 0…K−1, and each k is read at
    j = k − 1: no (m, K, t) tensor is built. ``owned`` (m, K) keeps only the
    slots whose rows ``y_train`` holds in the numerators (a rank's share of
    a row-sharded pass, ``parallel.sharded_eval``); the denominators stay
    whole."""
    ks = sorted(set(ks))
    vf = valid.to(torch.float32)
    zero = valid & (d <= 0.0)
    zf = zero.to(torch.float32)
    w_inv = torch.where(valid & ~zero, 1.0 / torch.where(zero | ~valid, 1.0, d), 0.0)
    cum_v, cum_z, cum_w = (torch.cumsum(a, dim=1) for a in (vf, zf, w_inv))
    m, t = idx.shape[0], y_train.shape[1]
    sums = {}
    if "uniform" in modes:
        sums["v"] = (vf, torch.zeros(m, t, device=y_train.device))
    if "distance" in modes:
        sums["z"] = (zf, torch.zeros(m, t, device=y_train.device))
        sums["w"] = (w_inv, torch.zeros(m, t, device=y_train.device))
    for j in range(ks[-1]):
        yj = y_train.index_select(0, idx[:, j])
        if owned is not None:
            yj = yj * owned[:, j:j + 1]
        for weight, acc in sums.values():
            acc.addcmul_(weight[:, j:j + 1], yj)
        if j + 1 not in ks:
            continue
        seen = (cum_v[:, j] > 0.0)[:, None]
        for mode in modes:
            if mode == "uniform":
                pred = sums["v"][1] / torch.clamp_min(cum_v[:, j, None], TINY)
            else:
                pz = sums["z"][1] / torch.clamp_min(cum_z[:, j, None], TINY)
                pw = sums["w"][1] / torch.clamp_min(cum_w[:, j, None], TINY)
                pred = torch.where((cum_z[:, j] > 0.0)[:, None], pz, pw)
            yield (j + 1, mode), torch.where(seen, pred, 0.0)


def _grid_errs_from_topk(d, valid, idx, y_train, y_val, ks, modes):
    """Per-sample squared errors of every combination, (len(modes)·len(ks),
    m), rows in ``[(k, mode) for mode in modes for k in ks]`` order."""
    errs = {key: torch.mean((pred - y_val) ** 2, dim=1)
            for key, pred in _prefix_predictions(d, valid, idx, y_train, ks, modes)}
    return torch.stack([errs[(k, mode)] for mode in modes for k in ks])


class KNNRegressor:
    """sklearn-surface kNN regressor on the card.

    Parameters mirror ``KNeighborsRegressor(n_neighbors=, weights=,
    metric=)``; ``n_jobs`` is accepted and ignored. ``chunk_size`` bounds the
    query rows a pass, so the (chunk × n) distance block stays small at any
    cohort size. ``device`` is where it runs (`resolve_device`: the card
    unless the CPU is asked for)."""

    def __init__(self, n_neighbors: int = 5, weights: str = "uniform", n_jobs=None,
                 metric="minkowski", chunk_size: int = CHUNK, shard=None, device=None):
        if weights not in ("uniform", "distance"):
            raise ValueError(f"unsupported weights {weights!r}")
        _check_metric(metric)  # fail early on unsupported metrics
        self.n_neighbors = n_neighbors
        self.weights = weights
        self.n_jobs = n_jobs
        self.metric = metric
        self.chunk_size = chunk_size
        self.shard = shard
        self.device = device
        self._x = self._y = None
        self._n = 0
        self._squeeze = False
        self._mesh = None

    def fit(self, X, y):
        self._mesh = _eval_mesh(self.shard)
        dev = resolve_device(self.device)
        self._x = _to_device(X, dev)
        y = _to_device(y, dev)
        self._squeeze = y.ndim == 1
        self._y = y.reshape(len(y), -1)
        self._n = len(self._x)
        if self._mesh is not None:  # keep this rank's block of the rows
            se = _sharded_eval()
            self._x, self._y = (se.row_block(t, self._mesh) for t in (self._x, self._y))
        return self

    def _chunks(self, X):
        if self._x is None:
            raise RuntimeError("fit() before predict()")
        X = _to_device(X, self._x.device)
        for start in range(0, len(X), self.chunk_size):
            yield X[start:start + self.chunk_size]

    def _finish(self, outs):
        out = (torch.cat(outs) if outs else self._y.new_zeros(0, self._y.shape[1])).cpu().numpy()
        return out[:, 0] if self._squeeze else out

    def predict(self, X):
        """Chunked neighbour-mean predictions as numpy; a 1-D ``y`` at fit
        gives 1-D predictions."""
        metric = _check_metric(self.metric)
        k = min(self.n_neighbors, self._n)
        if self._mesh is not None:
            se = _sharded_eval()
            return self._finish([se.knn_chunk(self._x, self._y, self._n, q, k, self.weights,
                                              metric, self._mesh) for q in self._chunks(X)])
        return self._finish([_knn_chunk(self._x, self._y, q, k, self.weights, metric)
                             for q in self._chunks(X)])

    def predict_multi_k(self, X, ks) -> dict:
        """``{clamped k: predictions}`` for every k in ``ks`` from one
        distance pass and one top-k(max k) a chunk; each equals
        ``KNNRegressor(k).predict``."""
        metric = _check_metric(self.metric)
        ks = tuple(sorted({min(int(k), self._n) for k in ks}))
        outs = {k: [] for k in ks}
        for q in self._chunks(X):
            if self._mesh is not None:
                preds = _sharded_eval().prefix_chunk(self._x, self._y, self._n, q, ks,
                                                     (self.weights,), ks[-1], metric,
                                                     self._mesh).items()
            else:
                d, valid, idx = _neighbours(self._x, q, ks[-1], metric)
                preds = _prefix_predictions(d, valid, idx, self._y, ks, (self.weights,))
            for (k, _), pred in preds:
                outs[k].append(pred)
        return {k: self._finish(v) for k, v in outs.items()}

    # sklearn plumbing used by the comparison scripts' grid search
    def get_params(self, deep=True):
        return {"n_neighbors": self.n_neighbors, "weights": self.weights,
                "n_jobs": self.n_jobs, "metric": self.metric, "chunk_size": self.chunk_size,
                "shard": self.shard, "device": self.device}

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
        return self


class ConditionedKNNRegressor:
    """Site-conditioned kNN on the card: one masked distance matrix in place
    of the reference's one-model-per-site loop (`models.conditioned_knn`,
    which the tests hold it against). The last column of X is the integer
    site id; unseen sites predict zeros; k is clamped to each site's group;
    single-output predictions are flattened."""

    def __init__(self, n_neighbors=5, weights="uniform", metric="euclidean",
                 chunk_size: int = CHUNK, shard=None, device=None):
        if weights not in ("uniform", "distance"):
            raise ValueError(f"unsupported weights {weights!r}")
        _check_metric(metric)  # fail early on unsupported metrics
        self.n_neighbors = n_neighbors
        self.weights = weights
        self.metric = metric
        self.chunk_size = chunk_size
        self.shard = shard
        self.device = device
        self._x = self._y = self._site = None
        self._n = 0
        self._mesh = None
        self.n_features_in_ = None
        self.n_outputs_ = None

    def fit(self, X, y):
        self._mesh = _eval_mesh(self.shard)
        dev = resolve_device(self.device)
        self._x, self._site = _split_sites(X, dev)
        y = _to_device(y, dev)
        self._y = y.reshape(len(y), -1)
        self.n_features_in_ = self._x.shape[1]
        self.n_outputs_ = self._y.shape[1]
        self.unique_sites = np.unique(self._site.cpu().numpy())
        self._n = len(self._x)
        if self._mesh is not None:  # this rank's block; a padded row has site -1
            se = _sharded_eval()
            self._x, self._y = (se.row_block(t, self._mesh) for t in (self._x, self._y))
            self._site = se.row_block(self._site, self._mesh, pad_value=-1)
        return self

    def predict(self, X):
        if self._x is None:
            raise RuntimeError("fit() before predict()")
        metric = _check_metric(self.metric)
        k = min(self.n_neighbors, self._n)
        feats, sites = _split_sites(X, self._x.device)
        if self._mesh is not None:
            se = _sharded_eval()
            chunk = lambda q, qs: se.knn_chunk(self._x, self._y, self._n, q, k,  # noqa: E731
                                               self.weights, metric, self._mesh, self._site, qs)
        else:
            chunk = lambda q, qs: _knn_chunk(self._x, self._y, q, k, self.weights,  # noqa: E731
                                             metric, self._site, qs)
        outs = [chunk(feats[s:s + self.chunk_size], sites[s:s + self.chunk_size])
                for s in range(0, len(feats), self.chunk_size)]
        out = (torch.cat(outs) if outs else self._y.new_zeros(0, self.n_outputs_)).cpu().numpy()
        return out.ravel() if self.n_outputs_ == 1 else out

    def get_params(self, deep=True):
        return {"n_neighbors": self.n_neighbors, "weights": self.weights,
                "metric": self.metric, "shard": self.shard, "device": self.device}

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
        return self


def knn_grid_mse(X_train, y_train, X_val, y_val, ks, modes, conditioned: bool = False,
                 chunk_size: int = GRID_CHUNK, shard=None, metric: str = "euclidean",
                 device=None) -> dict:
    """Mean validation MSE of every (n_neighbors, weights) combination,
    ``{(k, mode): mse}`` with k clamped to the training size, from one
    distance pass and one top-k(max k) a query chunk (`_grid_errs_from_topk`);
    one call serves one metric's whole sub-grid. With ``conditioned`` the
    last column of X is the site. The per-sample errors come back fp32 and
    are summed in float64 on the host, so the best combination is picked as
    the reference's ``mean_squared_error`` picks it. Under a process group
    the training rows shard (`_eval_mesh`)."""
    mesh = _eval_mesh(shard)
    metric = _check_metric(metric)
    dev = resolve_device(device)
    if conditioned:
        x, x_site = _split_sites(X_train, dev)
        q, q_site = _split_sites(X_val, dev)
    else:
        x, q = _to_device(X_train, dev), _to_device(X_val, dev)
        x_site = q_site = None
    y = _to_device(y_train, dev)
    y = y.reshape(len(y), -1)
    yv = _to_device(y_val, dev)
    yv = yv.reshape(len(yv), -1)
    n, m = len(x), len(q)
    ks = tuple(min(int(k), n) for k in ks)
    modes = tuple(modes)
    combo_sums = np.zeros(len(ks) * len(modes), np.float64)
    if mesh is not None:
        se = _sharded_eval()
        x, y = se.row_block(x, mesh), se.row_block(y, mesh)
        if x_site is not None:
            x_site = se.row_block(x_site, mesh, pad_value=-1)
    for s in range(0, m, chunk_size):
        e = s + chunk_size
        qs = None if q_site is None else q_site[s:e]
        if mesh is not None:
            preds = se.prefix_chunk(x, y, n, q[s:e], ks, modes, max(ks), metric, mesh, x_site, qs)
            errs = torch.stack([torch.mean((preds[(k, mode)] - yv[s:e]) ** 2, dim=1)
                                for mode in modes for k in ks])
        else:
            d, valid, idx = _neighbours(x, q[s:e], max(ks), metric, x_site, qs)
            errs = _grid_errs_from_topk(d, valid, idx, y, yv[s:e], ks, modes)
        combo_sums += errs.cpu().numpy().astype(np.float64).sum(axis=1)
    mses = combo_sums / max(m, 1)
    combos = [(k, mode) for mode in modes for k in ks]
    return {combo: float(mse) for combo, mse in zip(combos, mses)}


def resolve_knn_regressor(n_rows=None):
    """The kNN class the evaluation scripts instantiate: always
    `KNNRegressor` (the port has no host route; ``n_rows`` is accepted for
    the JAX package's call sites)."""
    return KNNRegressor


def resolve_conditioned_knn(n_rows=None):
    """The site-conditioned kNN class: always `ConditionedKNNRegressor`."""
    return ConditionedKNNRegressor
