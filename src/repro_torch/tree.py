"""Parameter trees: nested dicts, lists and tuples of tensors, the same
structure as the JAX package's pytrees (so the bridge is a leaf-wise
conversion)."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over structurally identical trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest]) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *[r[i] for r in rest])
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out
