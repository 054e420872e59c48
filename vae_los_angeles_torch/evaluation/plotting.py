"""Lazy plotting imports for the evaluation flows.

The card's machine has no matplotlib or plotly, so no module of the port
imports them at module level: a plot function asks here where it draws,
and without the package a line says so and the function returns.
"""

from __future__ import annotations


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None (with a line) when
    matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib unavailable; skipping the plot")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plotly_go():
    """plotly's graph_objects, or None (with a line) when plotly is
    missing."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        print("plotly unavailable; skipping the interactive plot")
        return None
    return go
