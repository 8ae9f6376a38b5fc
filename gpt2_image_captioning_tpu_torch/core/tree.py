"""The tree walks the port needs: params are nested dicts and lists of
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


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_map`'s order."""
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def flatten_with_paths(tree) -> dict:
    """``{"a.b.0.c": leaf}`` — the key format of the JAX package's
    ``core/tree.py::flatten_with_paths`` (dict keys and list indices)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"": tree}
    flat = {}
    for k, v in items:
        for path, leaf in flatten_with_paths(v).items():
            flat[f"{k}.{path}" if path else str(k)] = leaf
    return flat


def unflatten_from_paths(flat: dict):
    """Inverse of :func:`flatten_with_paths`: all-digit keys become lists."""
    root: dict = {}
    for key, leaf in flat.items():
        *parents, last = key.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)
