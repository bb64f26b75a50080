"""A small pytree utility for op states and batch channels.

States and channels are nested dicts, lists, tuples and NamedTuples of
tensors. Leaves are everything else. Dict keys are visited in sorted
order and ``None`` is an empty node, as JAX's pytrees do, so a
flattening here lists leaves in the order the JAX package lists them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = ("leaf",)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node):
    """(kind, aux, [(key, child), ...]) for an inner node, else None."""
    if node is None:
        return "none", None, []
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", tuple(keys), [(f"[{k!r}]", node[k]) for k in keys]
    if _is_namedtuple(node):
        return "nt", type(node), [(f".{f}", getattr(node, f))
                                  for f in type(node)._fields]
    if isinstance(node, (tuple, list)):
        return (type(node).__name__, len(node),
                [(f"[{i}]", c) for i, c in enumerate(node)])
    return None


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], tuple]:
    """``([(path, leaf), ...], treedef)`` in pytree order."""
    out: List[Tuple[str, Any]] = []

    def rec(node, path):
        ch = _children(node)
        if ch is None:
            out.append((path, node))
            return _LEAF
        kind, aux, items = ch
        return (kind, aux, tuple(rec(c, path + k) for k, c in items))

    treedef = rec(tree, "")
    return out, treedef


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    flat, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in flat], treedef


def tree_unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)

    def rec(td):
        if td == _LEAF:
            return next(it)
        kind, aux, subs = td
        vals = [rec(s) for s in subs]
        if kind == "none":
            return None
        if kind == "dict":
            return dict(zip(aux, vals))
        if kind == "nt":
            return aux(*vals)
        if kind == "list":
            return vals
        return tuple(vals)

    return rec(treedef)


def tree_map(fn: Callable, tree) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_bytes(tree) -> float:
    """Bytes of every tensor leaf (``meta`` tensors included: shapes
    only)."""
    import math
    return float(sum(math.prod(t.shape) * t.element_size()
                     for t in tree_leaves(tree)))
