"""Logical-axis -> PartitionSpec mapping, and a spec as DTensor placements.

The single place where "logical" tensor dimension names (``batch``,
``heads``, ``ff``, ...) meet "physical" mesh axis names (``pod``,
``data``, ``model``), as in the JAX package's ``dist/api.py``. The
invariant is *safe degradation*: a logical dim is only mapped onto mesh
axes whose total size divides the dim exactly; anything else stays
replicated. Rules can therefore be written once for the production mesh
and reused unchanged on a laptop, a reduced smoke config, or a degraded
post-failure mesh.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` (its dims
named) or any stand-in with ``.shape`` (name -> size) and
``.axis_names``. :func:`spec_to_placements` turns a spec into the
``Shard``/``Replicate`` placements of a DTensor on a ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """A per-dim spec: each entry ``None`` (unsharded), a mesh axis name,
    or a tuple of mesh axis names (outer first). A tuple, so it compares
    entry for entry with any sequence of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(mesh.shape, Mapping):
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {n: int(s) for n, s in dict(mesh.shape).items()}


def _as_tuple(rule) -> Tuple[str, ...]:
    """Normalize a rule value (str | None | sequence of str) to a tuple."""
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Mapping[str, object],
                    mesh,
                    shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Map per-dim logical names to a PartitionSpec on ``mesh``.

    For each dim, the rule's mesh axes are taken as an ordered candidate
    list and greedily accumulated: an axis is used when it exists in the
    mesh, is not already consumed by an earlier dim, and (when ``shape``
    is given) keeps the accumulated size-product dividing the dim; other
    candidates are skipped. Dims with no rule, no usable candidate, or
    ``None`` stay unsharded.
    """
    sizes = mesh_sizes(mesh)
    used: set = set()
    parts = []
    for i, name in enumerate(logical_axes):
        if name is None or name not in rules:
            parts.append(None)
            continue
        chosen = []
        prod = 1
        dim = None if shape is None else int(shape[i])
        for ax in _as_tuple(rules[name]):
            if ax not in sizes or ax in used:
                continue
            if dim is not None and dim % (prod * sizes[ax]) != 0:
                continue
            chosen.append(ax)
            prod *= sizes[ax]
        used.update(chosen)
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    return PartitionSpec(*parts)


def is_axes(x) -> bool:
    """True for a logical-axes tuple (names or ``None``): the leaf of an
    axes tree."""
    return isinstance(x, tuple) and not hasattr(type(x), "_fields") and \
        all(a is None or isinstance(a, str) for a in x)


def spec_is_replicated(spec) -> bool:
    """True when a spec places nothing on any mesh axis."""
    return all(p is None for p in spec)


def spec_to_placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    for each mesh dim, ``Shard(tensor dim)`` where the spec puts that
    axis, else ``Replicate()``.

    Where several mesh axes share a tensor dim, a DTensor splits it
    outer mesh dim first, as JAX splits ``("pod", "data")``; a spec that
    names them in another order than the mesh's has no placements and
    raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        axes = _as_tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} on dim {dim} is not in "
                             f"the mesh's axis order {tuple(names)}")
        for i in idx:
            placements[i] = Shard(dim)
    return placements


__all__ = ["PartitionSpec", "mesh_sizes", "logical_to_spec", "is_axes",
           "spec_is_replicated", "spec_to_placements"]
