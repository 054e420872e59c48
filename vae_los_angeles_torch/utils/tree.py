"""Nested-dict pytrees: the port keeps the JAX package's parameter, state and
carry trees as dicts of tensors, so the bridge to it stays a copy."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must have the same keys); dicts are the only nodes."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError(f"tree structures differ: {sorted(tree)} vs "
                                 f"{sorted(other) if isinstance(other, dict) else type(other)}")
        return {k: tree_map(fn, v, *(o[k] for o in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
