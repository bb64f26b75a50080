"""repro_torch.dist — the distributed-execution subsystem of the port.

The JAX package's ``repro.dist`` in PyTorch: one substrate that the
models, the train step, the launchers and the orchestrator share,
reached through a handful of names:

  * :func:`use_mesh`     — context manager activating a (mesh, rules)
    pair. Accepts a ``DeviceMesh``, a ``{axis: size}`` dict (built over
    the first ranks of the process group), ``None`` (a degenerate
    ``{"data": 1, "model": 1}`` mesh on the job's device) or any stand-in
    with ``.shape`` (name -> size) and ``.axis_names``.
  * :func:`shard` / :func:`shard_param` — layout constraints keyed by
    *logical* axis names: a DTensor is redistributed to the placements
    its spec gives; strict no-ops outside a mesh, on a rank mismatch,
    with empty rules or a replicated spec, and on a plain tensor (under a
    mesh, a plain tensor is the rank's own values: the train and serve
    steps compute on the rank's shards of the params, gathered where
    they are used, and its slice of the batch, between explicit
    collectives: :mod:`fsdp`).
  * :func:`pin_params`   — tree-level :func:`shard_param`.
  * :func:`axis_size`    — resolved size of a logical axis (1 when
    unmapped / no mesh); drives KV-head TP duplication and MoE token
    grouping.
  * submodules: :mod:`api` (logical->PartitionSpec->placements),
    :mod:`sharding` (recipe->rules), :mod:`checkpoint` (step-dir
    save/restore + async), :mod:`compression` (int8 edge-uplink gradient
    compression), :mod:`elastic` (mesh rebuild, resharding, worker
    add/remove decisions), :mod:`fsdp` (the step on shards: layouts,
    the gather at use and its reduce-scatter).

A mesh's devices are the ranks of the default process group, one device
each. A process with no group gets a world of one, made from a
``HashStore``, the first time it needs a ``DeviceMesh``: a single
process on the card needs no launcher. Where a mesh spans one device
every constraint is the identity, so nothing changes on one card.

Logical-axis naming conventions are the reference's: ``batch``,
``seq_sp``, ``kv_seq``, ``embed``, ``heads``/``kv_heads``, ``ff``,
``dinner``, ``vocab``, ``experts``, ``expert_groups``, ``layers``,
``head_dim``/``lora``.
"""

from __future__ import annotations

import atexit
import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch._tree import tree_map
from repro_torch.dist import checkpoint  # noqa: F401  (re-export submodule)
from repro_torch.dist.api import (is_axes, logical_to_spec, mesh_sizes,
                                  spec_is_replicated, spec_to_placements)

__all__ = [
    "use_mesh", "current_mesh", "current_rules", "mesh_active",
    "shard", "shard_param", "pin_params", "axis_size", "checkpoint",
    "world_ranks", "device_mesh", "spans_devices", "gather_tree",
    "local_tree",
]


@dataclass(frozen=True)
class _MeshContext:
    mesh: Any
    rules: dict


class _State(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _State()


def _current() -> Optional[_MeshContext]:
    return _STATE.stack[-1] if _STATE.stack else None


def current_mesh():
    ctx = _current()
    return ctx.mesh if ctx else None


def current_rules() -> Optional[dict]:
    ctx = _current()
    return ctx.rules if ctx else None


def mesh_active() -> bool:
    return _current() is not None


# ---------------------------------------------------------------------------
# The process group and its meshes
# ---------------------------------------------------------------------------

def world_ranks() -> list:
    """The ranks of the default process group (the mesh's devices, one
    a rank); a process with no group first makes a world of one."""
    import torch.distributed as tdist

    if not tdist.is_initialized():
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        tdist.init_process_group(backend, store=tdist.HashStore(), rank=0,
                                 world_size=1)
        atexit.register(_close_world)
    return list(range(tdist.get_world_size()))


def _close_world() -> None:
    """Destroy the world of one :func:`world_ranks` made, at exit."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        tdist.destroy_process_group()


def device_mesh(device_type: str, ranks, shape, names):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (row-major), its dims
    named ``names``. Every rank of the world calls it (its subgroups are
    made collectively), those outside ``ranks`` included."""
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor([int(r) for r in ranks], dtype=torch.int64)
    return DeviceMesh(device_type, grid.reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def spans_devices(mesh) -> bool:
    """A ``DeviceMesh`` of more than one device that holds this rank: the
    only mesh on which a constraint moves anything."""
    from torch.distributed.device_mesh import DeviceMesh
    return (isinstance(mesh, DeviceMesh) and mesh.size() > 1
            and mesh.get_coordinate() is not None)


def _coerce_mesh(mesh, device):
    if mesh is None:
        mesh = {"data": 1, "model": 1}
    if isinstance(mesh, dict):
        from repro_torch import resolve_device

        names = tuple(mesh)
        shape = tuple(int(v) for v in mesh.values())
        n = 1
        for s in shape:
            n *= s
        ranks = world_ranks()
        if len(ranks) < n:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} needs {n} devices, "
                f"have {len(ranks)}")
        return device_mesh(resolve_device(device).type, ranks[:n], shape,
                           names)
    return mesh


@contextlib.contextmanager
def use_mesh(mesh=None, rules: Optional[dict] = None, *, device="cuda"):
    """Activate (mesh, rules) for the enclosed block.

    ``mesh``: a ``DeviceMesh``, an ``{axis: size}`` dict (built over the
    first ranks of the world on ``device``'s type; more devices than the
    world has raise ``ValueError``), None (a single-device degenerate
    mesh) or a stand-in. ``rules``: as produced by
    :func:`repro_torch.dist.sharding.build_rules`; defaults to empty
    rules, i.e. everything replicated.
    """
    ctx = _MeshContext(_coerce_mesh(mesh, device),
                       rules if rules is not None else {"param": {}, "act": {}})
    _STATE.stack.append(ctx)
    try:
        yield ctx.mesh
    finally:
        _STATE.stack.pop()


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, logical_axes, table_key: str):
    ctx = _current()
    if ctx is None or not isinstance(x, torch.Tensor):
        return x
    if len(logical_axes) != x.dim():
        return x
    rules = ctx.rules.get(table_key, {})
    if not rules or not spans_devices(ctx.mesh) or not _is_dtensor(x):
        return x
    spec = logical_to_spec(logical_axes, rules, ctx.mesh, x.shape)
    if spec_is_replicated(spec) or x.device_mesh != ctx.mesh:
        return x
    return x.redistribute(ctx.mesh, spec_to_placements(spec, ctx.mesh))


def shard(x, *logical_axes):
    """Constrain an activation to its logical layout (no-op outside a
    mesh, on a plain tensor, or when a dim does not divide by its mesh
    axes)."""
    return _constrain(x, logical_axes, "act")


def shard_param(x, logical_axes):
    """Constrain a parameter (or grad) leaf to its param-rule layout."""
    return _constrain(x, tuple(logical_axes), "param")


def pin_params(tree, axes_tree):
    """Apply :func:`shard_param` across a tree; leaves whose rank does
    not match their axes entry (e.g. non-tensor aux state) pass through."""
    if _current() is None:
        return tree
    return tree_map(
        lambda x, ax: shard_param(x, ax)
        if isinstance(x, torch.Tensor) and x.dim() == len(ax) else x,
        tree, axes_tree, is_leaf=is_axes)


def axis_size(name: str) -> int:
    """Resolved size of logical axis ``name`` under the active mesh.

    Returns 1 with no active mesh, for unmapped names, and for mesh
    axes absent from the current mesh. ``name`` may also be a physical
    mesh axis name.
    """
    ctx = _current()
    if ctx is None:
        return 1
    sizes = mesh_sizes(ctx.mesh)
    if name in sizes:
        return int(sizes[name])
    rule = ctx.rules.get("act", {}).get(name)
    if rule is None:
        rule = ctx.rules.get("param", {}).get(name)
    if rule is None:
        return 1
    if isinstance(rule, str):
        rule = (rule,)
    n = 1
    for ax in rule:
        n *= int(sizes.get(ax, 1))
    return n


# ---------------------------------------------------------------------------
# Trees across ranks
# ---------------------------------------------------------------------------

def gather_tree(tree):
    """Every DTensor leaf as its full value (a collective over its mesh);
    other leaves as they are. For what runs outside a step (a checkpoint
    save, a rescale): a step gathers a leaf only where it uses it."""
    return tree_map(lambda x: x.full_tensor() if _is_dtensor(x) else x, tree)


def local_tree(tree):
    """Every DTensor leaf as this rank's local tensor; other leaves as
    they are."""
    return tree_map(lambda x: x.to_local() if _is_dtensor(x) else x, tree)
