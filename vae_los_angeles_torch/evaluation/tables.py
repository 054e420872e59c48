"""Cohort tables as the evaluation flows pass them: a pandas DataFrame (the
JAX package's pickles, list-valued feature columns) or a dict of numpy
arrays under the same column names (the port's pandas-free artifacts,
``data.artifacts``, and ``main(data=...)``). These helpers read and extend
either kind without importing pandas.
"""

from __future__ import annotations

import numpy as np


def is_frame(table) -> bool:
    return hasattr(table, "columns")


def has(table, name) -> bool:
    return name in (table.columns if is_frame(table) else table)


def n_rows(table) -> int:
    return len(table) if is_frame(table) else len(next(iter(table.values())))


def column(table, name) -> np.ndarray:
    """The column as an array: a list-valued frame column stacked into
    (n, width), as the reference's ``np.array(df[col].tolist())``."""
    if is_frame(table):
        values = table[name].tolist()
        return np.array(values) if values and np.ndim(values[0]) else table[name].values
    return np.asarray(table[name])


def select(table, mask):
    """The rows where ``mask`` holds (a frame keeps its index, as the JAX
    package's filters do)."""
    mask = np.asarray(mask, bool)
    if is_frame(table):
        return table[mask].copy()
    return {name: np.asarray(values)[mask] for name, values in table.items()}


def with_columns(table, **columns):
    """A copy with ``columns`` added; a 2-D array becomes a list column of
    a frame."""
    out = table.copy() if is_frame(table) else dict(table)
    for name, values in columns.items():
        out[name] = list(values) if is_frame(table) and np.ndim(values) == 2 else values
    return out
