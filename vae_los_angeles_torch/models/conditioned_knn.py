"""Site-conditioned kNN baseline as the reference writes it: one regressor
per site (counterpart of ``vae_los_angeles_tpu/models/conditioned_knn.py``,
reference ``src/models/conditioned_knn.py``), over the port's
`ops.knn.KNNRegressor` in place of sklearn's.

  * the LAST column of X is the integer site id;
  * one regressor is fitted per site, with k clamped to the group size;
  * prediction groups queries by site and leaves zeros for sites unseen at
    fit time; single-output predictions are flattened.

`ops.knn.ConditionedKNNRegressor` computes the same function as one masked
distance matrix; this loop is the independent algorithm it is held against.
"""

from __future__ import annotations

import numpy as np

from vae_los_angeles_torch.ops.knn import KNNRegressor


class ConditionedKNeighborsRegressor:
    """kNN regressor conditioned on a categorical site column."""

    def __init__(self, n_neighbors=5, weights="uniform", metric="euclidean", device=None):
        self.n_neighbors = n_neighbors
        self.weights = weights
        self.metric = metric
        self.device = device
        self.models = {}
        self.n_features_in_ = None
        self.n_outputs_ = None

    def fit(self, X, y):
        X = np.asarray(X)
        y = np.asarray(y)
        feats, sites = X[:, :-1], X[:, -1].astype(int)
        self.n_features_in_ = feats.shape[1]
        self.unique_sites = np.unique(sites)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        self.n_outputs_ = y.shape[1]
        self.models = {}
        for site in self.unique_sites:
            mask = sites == site
            k = min(self.n_neighbors, int(mask.sum()))
            self.models[site] = KNNRegressor(
                n_neighbors=k, weights=self.weights, metric=self.metric, device=self.device,
            ).fit(feats[mask], y[mask])
        return self

    def predict(self, X):
        X = np.asarray(X)
        feats, sites = X[:, :-1], X[:, -1].astype(int)
        predictions = np.zeros((X.shape[0], self.n_outputs_))
        for site in np.unique(sites):
            if site not in self.models:
                continue  # a site unseen at fit time keeps its zeros
            mask = sites == site
            predictions[mask] = self.models[site].predict(feats[mask])
        if self.n_outputs_ == 1:
            return predictions.ravel()
        return predictions

    def get_params(self, deep=True):
        return {"n_neighbors": self.n_neighbors, "weights": self.weights,
                "metric": self.metric, "device": self.device}

    def set_params(self, **parameters):
        for parameter, value in parameters.items():
            setattr(self, parameter, value)
        return self
