"""A small pytree utility for op states and batch channels.

States and channels are nested dicts, lists, tuples and NamedTuples of
tensors. Leaves are everything else. Dict keys are visited in sorted
order and ``None`` is an empty node, as JAX's pytrees do, so a
flattening here lists leaves in the order the JAX package lists them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

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


def _flatten(node, path, out, is_leaf):
    ch = None if is_leaf is not None and is_leaf(node) else _children(node)
    if ch is None:
        out.append((path, node))
        return _LEAF
    kind, aux, items = ch
    return (kind, aux, tuple(_flatten(c, path + k, out, is_leaf)
                             for k, c in items))


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None
                           ) -> Tuple[List[Tuple[str, Any]], tuple]:
    """``([(path, leaf), ...], treedef)`` in pytree order. ``is_leaf``
    marks further nodes as leaves (a logical-axes tuple, for one).

    The walks are module-level functions, not closures that call
    themselves: such a closure is a reference cycle, and the leaves it
    captured (a model's parameters, on the card) would live until the
    garbage collector ran."""
    out: List[Tuple[str, Any]] = []
    treedef = _flatten(tree, "", out, is_leaf)
    return out, treedef


def tree_flatten(tree, is_leaf: Optional[Callable] = None
                 ) -> Tuple[List[Any], tuple]:
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in flat], treedef


def _unflatten(td, it):
    if td == _LEAF:
        return next(it)
    kind, aux, subs = td
    vals = [_unflatten(s, it) for s in subs]
    if kind == "none":
        return None
    if kind == "dict":
        return dict(zip(aux, vals))
    if kind == "nt":
        return aux(*vals)
    if kind == "list":
        return vals
    return tuple(vals)


def tree_unflatten(treedef: tuple, leaves) -> Any:
    return _unflatten(treedef, iter(leaves))


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None
             ) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees flattened to as many leaves, ``rest`` under ``is_leaf`` too)."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(leaves)}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_bytes(tree) -> float:
    """Bytes of every tensor leaf (``meta`` tensors included: shapes
    only)."""
    import math
    return float(sum(math.prod(t.shape) * t.element_size()
                     for t in tree_leaves(tree)))
