"""Parameter specs: declare once, materialize or reflect.

A model defines a tree (dicts and lists) of :class:`Spec` leaves (shape +
logical axes + initializer), as in the JAX package's ``models/params.py``.
The same tree yields:
  * real parameters          (:func:`materialize`)
  * shapes without storage   (:func:`shape_tree`, tensors on the ``meta``
                              device)
  * the parameter count      (:func:`param_count`)
  * logical axes             (:func:`axes_of`, consumed by dist.sharding)

Each leaf draws from its own ``torch.Generator``, seeded from the model
seed and the crc32 of the leaf's path (``embed/tok``, ``stack/0/mixer/wq``),
as the JAX package folds that crc32 into its key: a leaf's values do not
depend on the other leaves. ``torch`` and ``jax.random`` give different
numbers from the same seed; to run both packages on the same weights,
convert the JAX package's with :func:`repro_torch.convert.params_from_numpy`.
"""

from __future__ import annotations

import functools
import math
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch._tree import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal|zeros|ones|constant
    scale: Optional[float] = None  # stddev for normal (default: fan-in)
    const: float = 0.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec rank mismatch: {self.shape} vs {self.axes}")


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    # convention: last dim is output; everything else is fan-in
    n = 1
    for s in shape[:-1]:
        n *= s
    return max(n, 1)


def _init_leaf(spec: Spec, gen: Optional[torch.Generator], dtype,
               device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.const, dtype=dtype, device=device)
    s = spec.scale if spec.scale is not None else 1.0 / math.sqrt(
        _fan_in(spec.shape))
    if spec.init == "normal":
        # scaled in place: the draw's peak is the fp32 leaf and its cast,
        # not two fp32 copies (a stacked leaf of a large config is tens
        # of GB in fp32)
        return torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(s).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def leaf_seed(seed: int, path: str) -> int:
    """The generator seed of the leaf at ``path`` under model ``seed``: the
    crc32 of the path, started from the model seed (32 bits, which every
    torch generator keeps whole)."""
    return zlib.crc32(path.encode(), int(seed) & 0xFFFFFFFF)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def materialize(tree, seed: int, dtype=torch.float32, device="cpu",
                keep=None):
    """Materialize a Spec tree into parameters on ``device``
    (deterministic per path). ``keep(i, value)``, where given, is what
    leaf ``i`` (in pytree order) keeps of its drawn value, taken before
    the next leaf is drawn (a rank's shard: the whole value is freed at
    once); the tree then comes back in pytree order."""
    def leaf(path, spec):
        gen = None
        if spec.init == "normal":
            gen = torch.Generator(device=device)
            gen.manual_seed(leaf_seed(seed, path))
        return _init_leaf(spec, gen, dtype, device)
    if keep is None:
        return _map_with_path(leaf, tree)
    draws, treedef = tree_flatten(_map_with_path(
        lambda path, spec: functools.partial(leaf, path, spec), tree))
    return tree_unflatten(treedef, [keep(i, draw())
                                    for i, draw in enumerate(draws)])


def shape_tree(tree, dtype=torch.float32):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    storage."""
    return _map_with_path(
        lambda _, s: torch.empty(s.shape, dtype=dtype, device="meta"), tree)


def axes_of(tree):
    """The tree's logical axes: each Spec replaced by its ``axes`` tuple
    (what ``dist.sharding`` maps onto a mesh)."""
    return _map_with_path(lambda _, s: s.axes, tree)


def spec_leaves(tree):
    out = []
    _map_with_path(lambda _, s: out.append(s), tree)
    return out


def param_count(tree) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(tree))


def stack_specs(spec_tree, n: int):
    """Prepend a stacked `layers` dim of size n to every Spec in the tree."""
    return _map_with_path(
        lambda _, s: Spec((n,) + s.shape, ("layers",) + s.axes, s.init,
                          s.scale, s.const), spec_tree)
