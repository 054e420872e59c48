"""Split protocol (counterpart of ``vae_los_angeles_tpu/data/splits.py``).

The JAX package delegates to sklearn's
``train_test_split(idx, test_size, random_state=seed)``. For an index array
that call is a ``RandomState(seed)`` permutation whose first
``ceil(test_size * n)`` entries are the validation rows, so this module
reproduces it with numpy alone (the card's machine has no sklearn).
`kfold_indices` is sklearn's ``KFold(shuffle=True)`` the same way, and
`cv_inner_split` the cross-modality CV's 90/10 early-stopping split of a
fold's training rows.

The downstream classifiers' host-side helpers, each equal to the sklearn
call the JAX package makes (index for index, or value for value):
`stratified_kfold_indices` (``StratifiedKFold(shuffle=True)``),
`stratified_train_test_split` (``train_test_split(stratify=)``),
`balanced_class_weight` (``compute_class_weight("balanced")``),
`standard_scale` (``StandardScaler().fit_transform``), `LabelCodes`
(``LabelEncoder``) and `SiteCodes` (the label encoder of ``data=`` arrays).
Both splitters draw from ``np.random.RandomState(seed)`` in sklearn's order,
so they give its indices for the same seed.
"""

from __future__ import annotations

import math
import warnings

import numpy as np


def train_val_indices(n: int, test_size: float = 0.2, seed: int = 42):
    """(train_idx, val_idx), equal to sklearn's ``train_test_split`` of
    ``np.arange(n)``."""
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must be in (0, 1), got {test_size}")
    n_val = math.ceil(test_size * n)
    if n_val == 0 or n_val >= n:
        raise ValueError(f"test_size={test_size} leaves an empty split of n={n}")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_val:], perm[:n_val]


def kfold_indices(n: int, n_splits: int, seed: int = 42):
    """[(train_idx, test_idx)] a fold, equal to sklearn's
    ``KFold(n_splits, shuffle=True, random_state=seed).split(np.arange(n))``:
    ``RandomState(seed)`` shuffles ``arange(n)``, the first ``n % n_splits``
    folds take one row more, and both index arrays come back ascending."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"n_splits={n_splits} needs 2 <= n_splits <= n_samples={n}")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=np.int64)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def cv_inner_split(train_index, test_size: float = 0.1, seed: int = 42):
    """(inner train rows, inner validation rows) of a fold's training rows,
    equal to sklearn's ``train_test_split(train_index, test_size=0.1,
    random_state=42)`` (the reference's early-stopping split,
    ``vae_cross_modality_cv.py:113-115``)."""
    train_index = np.asarray(train_index)
    tr, va = train_val_indices(len(train_index), test_size, seed)
    return train_index[tr], train_index[va]


def stratified_kfold_indices(y, n_splits: int, seed: int = 42):
    """[(train_idx, test_idx)] a fold, equal to sklearn's
    ``StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(X, y)``:
    classes numbered in their order of first appearance, each class's test
    counts a fold from the round-robin ``bincount(sorted_y[i::n_splits])``,
    then one ``RandomState(seed).shuffle`` a class of its fold numbers; both
    index arrays ascending. Raises as sklearn does when ``n_splits`` exceeds
    every class's count, and warns when it exceeds the smallest."""
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError(f"y must be 1-D, got shape {y.shape}")
    n = len(y)
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the "
                         f"number of samples: n_samples={n}.")
    if n_splits < 2:
        raise ValueError(f"n_splits={n_splits} must be at least 2")
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    y_encoded = class_perm[inverse]  # 0 is the first class to appear, 1 the second, ...
    n_classes = len(first)
    counts = np.bincount(y_encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in "
                         "each class.")
    if n_splits > counts.min():
        warnings.warn(f"The least populated class in y has only {counts.min()} members, which "
                      f"is less than n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(n, dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return [(np.flatnonzero(test_folds != i), np.flatnonzero(test_folds == i))
            for i in range(n_splits)]


def _approximate_mode(class_counts, n_draws: int, rng):
    """sklearn's approximate mode of the multivariate hypergeometric
    (``sklearn.utils.extmath._approximate_mode``): floored shares, the rest
    added by largest remainder, ties broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(y, test_size: float = 0.2, seed: int = 42):
    """(train_idx, test_idx), equal to the indices sklearn's
    ``train_test_split(..., test_size, random_state=seed, stratify=y)``
    takes: ``ceil(test_size * n)`` test rows; from ``RandomState(seed)`` the
    train and test counts a class (`_approximate_mode`, twice), one
    permutation a class of its rows (sorted classes, rows in order), then a
    permutation of the train and of the test indices."""
    y = np.asarray(y)
    n = len(y)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must be in (0, 1), got {test_size}")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"test_size={test_size} leaves an empty train split of n={n}")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too "
                         "few. The minimum number of groups for any class cannot be less than "
                         f"2. Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each be at least "
                         f"the number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        rows = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(rows[: n_i[i]])
        test.extend(rows[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def balanced_class_weight(classes, y) -> np.ndarray:
    """``compute_class_weight("balanced", classes=classes, y=y)``: for each
    of ``classes``, n / (n_classes_in_y · its count), in float64."""
    classes = np.asarray(classes)
    present, y_ind = np.unique(np.asarray(y), return_inverse=True)
    if not np.all(np.isin(classes, present)):
        raise ValueError("classes should have valid labels that are in y")
    counts = np.bincount(y_ind).astype(np.float64)
    recip_freq = counts.sum() / (len(present) * counts)
    return recip_freq[np.searchsorted(present, classes)]


def standard_scale(x) -> np.ndarray:
    """``StandardScaler().fit_transform(x)``: each column less its mean, over
    its population std. The statistics accumulate in float64 (sklearn's
    corrected two-pass form); a column whose variance is within float64
    rounding of 0 keeps a scale of 1 (``_is_constant_feature``,
    ``_handle_zeros_in_scale``); the mean and scale are rounded to ``x``'s
    float dtype and applied in it."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    n = x.shape[0]
    total = np.sum(x, axis=0, dtype=np.float64)
    mean = total / n
    centred = x - mean  # float64
    correction = np.sum(centred, axis=0, dtype=np.float64)
    var = (np.sum(centred ** 2, axis=0, dtype=np.float64) - correction ** 2 / n) / n
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    return (x - mean.astype(x.dtype)) / scale.astype(x.dtype)


class LabelCodes:
    """``LabelEncoder``'s fit: ``classes_`` the sorted distinct labels, and
    the codes of ``y`` into them."""

    classes_ = None

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y))
        return self

    def fit_transform(self, y):
        self.classes_, codes = np.unique(np.asarray(y), return_inverse=True)
        return codes.astype(np.int64)


class SiteCodes:
    """The ``LabelEncoder`` surface for site codes that stand for the site
    names (``main(data=...)`` of the clustering flows): ``classes_`` the
    known codes, ``transform`` and ``inverse_transform`` the identity, so a
    code conditions a model on itself. ``transform`` refuses an unknown
    code, as ``LabelEncoder`` refuses an unseen label."""

    def __init__(self, codes):
        self.classes_ = np.unique(np.asarray(codes).astype(np.int64))

    def transform(self, y):
        y = np.asarray(y).astype(np.int64)
        unseen = np.setdiff1d(y, self.classes_)
        if unseen.size:
            raise ValueError(f"y contains previously unseen labels: {unseen.tolist()}")
        return y

    def inverse_transform(self, y):
        return np.asarray(y).astype(np.int64)
