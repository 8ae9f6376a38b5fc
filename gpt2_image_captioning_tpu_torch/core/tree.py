"""The one tree walk the port needs: params are nested dicts and lists of
tensors, as the JAX package's pytrees are."""

from __future__ import annotations


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples (tuples
    come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
