"""Split protocol (counterpart of ``vae_los_angeles_tpu/data/splits.py``).

The JAX package delegates to sklearn's
``train_test_split(idx, test_size, random_state=seed)``. For an index array
that call is a ``RandomState(seed)`` permutation whose first
``ceil(test_size * n)`` entries are the validation rows, so this module
reproduces it with numpy alone (the card's machine has no sklearn).
`kfold_indices` is sklearn's ``KFold(shuffle=True)`` the same way, and
`cv_inner_split` the cross-modality CV's 90/10 early-stopping split of a
fold's training rows.
"""

from __future__ import annotations

import math

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
