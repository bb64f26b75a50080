"""Parameters that stay sharded through a step: each leaf gathered where
it is used, its gradient reduce-scattered back to its shard.

The JAX package keeps params and optimizer state in the layout its rules
place (``pin_params`` inside its jitted step) and XLA inserts the
all-gather of a weight where it is used and the reduce-scatter of its
gradient. Eager PyTorch has no partitioner, so the port says where:

  * :class:`Layout` -- where each leaf of a tree lives on a mesh: its
    spec (``logical_to_spec`` of its logical axes, the param rules and
    its full shape: the spec :func:`repro_torch.dist.elastic.
    reshard_tree` places it by, divisibility fallback included), the
    rank's shard of a DTensor or plain leaf, DTensors built back from
    shards (``DTensor.from_local``, no communication), and reductions of
    per-leaf values over the mesh axes that shard each leaf.
  * :func:`sharded` -- the context of a step that computes on shards and
    on the rank's slice of the batch: the mesh, its rules and the mesh
    axes the batch is split over. Inside it :func:`gather` is a
    collective; outside it, the identity.
  * :func:`gather` -- a leaf's full value from its shard: an all-gather
    over each mesh axis that shards it, the last mesh axis first
    (DTensor's order: a dim split over ``("data", "model")`` gathers over
    ``model``, then ``data``); the full value bitwise. Differentiable:
    the backward returns the shard's gradient, in fp32 until autograd
    gives it the shard's dtype. Over a sharded axis the batch is split
    over, that is the mean over the ranks along it (a reduce-scatter);
    over a sharded axis the batch is not split over (``model`` where the
    act rules do not keep the dim on it, as experts under ``tp_fsdp``:
    every rank along it computed the same gradient), the rank's slice,
    with no communication. A dim kept on ``model`` (:func:`use_spec`) is
    not gathered over it at all. The mean over batch axes a leaf is not
    sharded on is the caller's, once, after accumulation.

The models gather a layer's params inside the layer's body (so remat
frees them after the layer and the backward gathers them again), the
prefix slot by slot, and the leaves outside the stacks once at each
entry point (``models/transformer.py``), each by its *use spec*
(:func:`use_spec`): a dim that the act rules map to ``model`` as well
(heads, ``ff``, ``vocab``, ``dinner``; experts under the ``ep``
recipes) is not gathered over ``model``. It stays the rank's slice and
the layer computes on it (:mod:`repro_torch.dist.tp`); its gradient is
the rank's own, so the backward narrows nothing there.

Every collective goes to the group's own backend. Gloo carries each one
used here (all-gather, reduce-scatter and all-reduce with SUM, MAX and
AVG) on CUDA tensors as well as CPU ones in torch 2.11, so none is
staged through the host; NCCL and the dry run's fake group carry them
too.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.dist.api import (PartitionSpec, _as_tuple, is_axes,
                                  logical_to_spec, mesh_sizes,
                                  spec_to_placements)

__all__ = ["Layout", "MeshShape", "sharded", "current", "gather", "leaf_spec",
           "use_spec", "is_spec", "all_reduce", "contexts", "entered"]


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def leaf_spec(axes, shape, rules, mesh) -> PartitionSpec:
    """``logical_to_spec`` of a leaf; replicated where its axes do not
    describe it (a leaf ``pin_params`` passes through)."""
    if axes is None or len(axes) != len(shape):
        return PartitionSpec(*(None,) * len(shape))
    return logical_to_spec(axes, rules, mesh, shape)


def use_spec(axes, spec, act: dict) -> PartitionSpec:
    """``spec`` (a leaf's, by the param rules) less ``model`` on each dim
    whose logical axis the act rules ``act`` map to ``model`` too: what
    :func:`gather` gathers of a leaf inside a step on shards. Such a dim
    stays the rank's slice and its layer computes on it (tensor and
    expert parallelism, :mod:`repro_torch.dist.tp`)."""
    if axes is None or len(axes) != len(spec):
        return spec
    out = []
    for ax, part in zip(axes, spec):
        if ax is not None and "model" in _as_tuple(act.get(ax)):
            kept = tuple(a for a in _as_tuple(part) if a != "model")
            part = None if not kept else (kept[0] if len(kept) == 1
                                          else kept)
        out.append(part)
    return PartitionSpec(*out)


def _steps(spec, mesh) -> list:
    """``[(tensor dim, mesh axis), ...]`` sharding ``spec``'s leaf over
    axes of more than one rank, in gather order: the last mesh dim
    first."""
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    steps = [(names.index(a), d, a) for d, part in enumerate(spec)
             for a in _as_tuple(part) if sizes[a] > 1]
    return [(d, a) for _, d, a in sorted(steps, reverse=True)]


# ---------------------------------------------------------------------------
# Collectives along one mesh axis
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    import torch.distributed as tdist
    n = tdist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    tdist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def _reduce_scatter_mean(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the ranks' mean of ``x``."""
    import torch.distributed as tdist
    n = tdist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    tdist.reduce_scatter_tensor(out, src, op=tdist.ReduceOp.AVG, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


_OPS = {"sum": "SUM", "max": "MAX", "mean": "AVG"}


def all_reduce(x: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place over each mesh axis of ``axes`` in turn
    (``op``: ``"sum"``, ``"max"`` or ``"mean"``); returns ``x``."""
    import torch.distributed as tdist
    for a in axes:
        tdist.all_reduce(x, op=getattr(tdist.ReduceOp, _OPS[op]),
                         group=mesh.get_group(a))
    return x


# ---------------------------------------------------------------------------
# The context of a step on shards, and the gather at use
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Sharded:
    mesh: Any
    rules: dict
    batch_axes: tuple
    layout: Optional["Layout"]


class _State(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _State()


def current() -> Optional[_Sharded]:
    """The innermost :func:`sharded` context, or None."""
    return _STATE.stack[-1] if _STATE.stack else None


class MeshShape:
    """A mesh stand-in (``.shape`` name -> size): all that ``axis_size``
    and a spec read of a mesh."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)

    @property
    def axis_names(self):
        return tuple(self.shape)


@contextlib.contextmanager
def sharded(mesh, rules: dict, batch_axes=(), layout=None):
    """Run the enclosed block on shards and on the rank's slice of the
    batch: :func:`gather` all-gathers over ``mesh`` (a ``DeviceMesh``) by
    the param rules of ``rules``; ``batch_axes`` are the mesh axes the
    batch is split over (the gradient's mean runs over them, and
    ``use_mesh`` sees them at size 1); ``layout`` (the params'
    :class:`Layout`) is what an optimizer reads to reduce over a leaf's
    sharded dims."""
    from repro_torch.dist import use_mesh

    batch_axes = tuple(batch_axes)
    # the mesh with the batch's axes at 1: what axis_size reads while the
    # rank computes on its slice of the batch (its own MoE token groups)
    view = MeshShape({n: (1 if n in batch_axes else s)
                      for n, s in mesh_sizes(mesh).items()})
    with use_mesh(view, rules):
        _STATE.stack.append(_Sharded(mesh, rules, batch_axes, layout))
        try:
            yield
        finally:
            _STATE.stack.pop()


def contexts() -> tuple:
    """This thread's active ``use_mesh`` and :func:`sharded` contexts, to
    re-enter where another thread runs the same code (:func:`entered`):
    the autograd engine runs a CUDA backward, and so a checkpoint's
    recompute, on a thread of its own."""
    from repro_torch import dist
    return dist._current(), current()


@contextlib.contextmanager
def entered(ctx: tuple):
    """Re-enter :func:`contexts`' ``ctx`` on this thread."""
    from repro_torch import dist
    mesh_ctx, shard_ctx = ctx
    stacks = [(dist._STATE.stack, mesh_ctx), (_STATE.stack, shard_ctx)]
    stacks = [(st, c) for st, c in stacks if c is not None]
    for st, c in stacks:
        st.append(c)
    try:
        yield
    finally:
        for st, _ in stacks:
            st.pop()


class _Gather(torch.autograd.Function):
    """A leaf's full value from its shard (the module docstring)."""

    @staticmethod
    def forward(ctx, x, steps, mesh, batch_axes):
        ctx.steps, ctx.mesh, ctx.batch_axes = steps, mesh, batch_axes
        for dim, axis in steps:
            x = _all_gather(x, dim, mesh.get_group(axis))
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32)
        mesh = ctx.mesh
        for dim, axis in reversed(ctx.steps):
            if axis in ctx.batch_axes:
                g = _reduce_scatter_mean(g, dim, mesh.get_group(axis))
            else:
                n = g.shape[dim] // mesh_sizes(mesh)[axis]
                g = g.narrow(dim, mesh.get_local_rank(axis) * n, n).clone()
        return g, None, None, None


def gather(tree, specs):
    """Each leaf of ``tree`` (a rank's shards) as its full value, by the
    matching spec of ``specs``, inside a :func:`sharded` block; ``tree``
    as it is outside one, or where ``specs`` is None."""
    ctx = current()
    if ctx is None or specs is None:
        return tree

    def leaf(x, spec):
        steps = _steps(spec, ctx.mesh)
        if not steps:
            return x
        return _Gather.apply(x, steps, ctx.mesh, ctx.batch_axes)
    return tree_map(leaf, tree, specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# A tree's layout on a mesh
# ---------------------------------------------------------------------------

class Layout:
    """Where each leaf of a tree lives on ``mesh`` (a ``DeviceMesh``): its
    full shape, its spec by ``rules["param"]`` and its logical axes, its
    DTensor placements. ``tree``'s leaves are DTensors (their global
    shapes) or full values."""

    def __init__(self, tree, axes_tree, rules: dict, mesh):
        leaves, self.treedef = tree_flatten(tree)
        axes = tree_flatten(axes_tree, is_leaf=is_axes)[0]
        if len(axes) != len(leaves):
            raise ValueError(f"{len(axes)} axes entries for {len(leaves)} "
                             "leaves")
        table = rules.get("param", {})
        self.mesh = mesh
        self.shapes = [tuple(x.shape) for x in leaves]
        self.specs = [leaf_spec(ax, s, table, mesh)
                      for ax, s in zip(axes, self.shapes)]
        self.placements = [spec_to_placements(s, mesh) for s in self.specs]
        self._steps = [_steps(s, mesh) for s in self.specs]

    def axes(self, i: int, dims=None) -> tuple:
        """The mesh axes (of more than one rank) that shard leaf ``i``'s
        ``dims`` (every dim when None), in mesh order."""
        n = len(self.shapes[i])
        want = range(n) if dims is None else {d % n for d in dims}
        got = {a for d, a in self._steps[i] if d in want}
        return tuple(a for a in self.mesh.mesh_dim_names if a in got)

    def local(self, tree):
        """This rank's shard of each leaf: a DTensor's local tensor
        (redistributed first where its placements are not the leaf's:
        a collective), a plain leaf's slice (a copy, so the caller's full
        value is never written)."""
        leaves = tree_flatten(tree)[0]
        return tree_unflatten(self.treedef, [self.local_leaf(i, x) for i, x
                                             in enumerate(leaves)])

    def local_leaf(self, i: int, x):
        """This rank's shard of leaf ``i`` (``x``), as :meth:`local`
        takes it."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            if x.device_mesh != self.mesh:
                raise ValueError("a leaf lives on another mesh than the "
                                 "step's")
            if list(x.placements) != self.placements[i]:
                x = x.redistribute(self.mesh, self.placements[i])
            return x.to_local()
        steps = self._steps[i]
        for dim, axis in reversed(steps):         # outer mesh dim first
            n = x.shape[dim] // mesh_sizes(self.mesh)[axis]
            x = x.narrow(dim, self.mesh.get_local_rank(axis) * n, n)
        return x.clone() if steps else x

    def placed(self, tree):
        """DTensors on the mesh from this rank's shards (no
        communication)."""
        from torch.distributed.tensor import DTensor

        out = []
        for x, pl, shape in zip(tree_flatten(tree)[0], self.placements,
                                self.shapes):
            stride, n = [], 1
            for size in reversed(shape):
                stride.insert(0, n)
                n *= size
            out.append(DTensor.from_local(x, self.mesh, pl, run_check=False,
                                          shape=torch.Size(shape),
                                          stride=tuple(stride)))
        return tree_unflatten(self.treedef, out)

    def reduce(self, values: list, op: str) -> list:
        """Each leaf's 0-dim ``values[i]`` reduced (``"sum"`` or
        ``"max"``) over the mesh axes that shard leaf ``i``: the whole
        leaf's value from its shards' (a replicated leaf's counted once).
        One all-reduce a distinct set of axes and axis."""
        groups: dict = {}
        for i in range(len(values)):
            groups.setdefault(self.axes(i), []).append(i)
        out = list(values)
        for axes, idx in groups.items():
            if not axes:
                continue
            buf = all_reduce(torch.stack([values[i] for i in idx]), axes,
                             self.mesh, op)
            for j, i in enumerate(idx):
                out[i] = buf[j]
        return out
