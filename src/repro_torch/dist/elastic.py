"""Elastic worker management: add/remove-worker resharding decisions.

Two layers, as in the JAX package's ``dist/elastic.py``:

  * mechanism — :func:`rebuild_mesh` carves a new (data, model) mesh out
    of the surviving devices (the ranks of the process group) after
    failures/scale events, and :func:`reshard_tree` moves a
    checkpoint/parameter tree onto it (values preserved; layout
    re-derived from the logical rules). :func:`rescale_cycle` drives a
    rescale through both and the checkpoint.
  * policy — :class:`ElasticController` watches offered vs. achieved
    stream rate and emits :class:`ScalePlan` grow/shrink/hold decisions
    with hysteresis; the orchestrator logs these next to its offload
    decisions.

Data-parallel worker counts stay powers of two so global batches keep
dividing evenly (see api.logical_to_spec's divisibility contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch._tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Mechanism: mesh rebuild + tree resharding
# ---------------------------------------------------------------------------

def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def factor_mesh(n_devices: int, prefer_model: int = 1):
    """(data, model) shape for ``n_devices``: honour ``prefer_model``
    (halving until it fits) and keep data a power of two."""
    model = max(1, int(prefer_model))
    while model > n_devices:
        model //= 2
    data = _pow2_floor(max(1, n_devices // model))
    return data, model


def _default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def rebuild_mesh(devices: Sequence, failed: Sequence = (),
                 prefer_model: int = 1, *, device_type: Optional[str] = None):
    """New ("data","model") ``DeviceMesh`` over the devices that survived.

    ``devices`` and ``failed`` entries are ranks (ints) or objects with an
    ``.id`` (the rank). Every rank of the world calls it. ``device_type``
    defaults to ``cuda`` where a card is visible, else ``cpu``.
    """
    from repro_torch.dist import device_mesh

    failed_ids = {getattr(f, "id", f) for f in failed}
    alive = [getattr(d, "id", d) for d in devices
             if getattr(d, "id", d) not in failed_ids]
    if not alive:
        raise RuntimeError("no surviving devices to rebuild a mesh from")
    data, model = factor_mesh(len(alive), prefer_model)
    return device_mesh(device_type or _default_device_type(),
                       alive[:data * model], (data, model),
                       ("data", "model"))


def reshard_tree(tree, axes_tree, rules: dict, mesh):
    """Re-place a tree onto ``mesh`` per its logical axes (values kept).

    Layouts are re-derived through ``rules["param"]`` with the usual
    divisibility fallback, so a tree sharded for an 8-way mesh restores
    cleanly onto a degraded 4-way one. A DTensor leaf is gathered first;
    a plain leaf must hold the same full value on every rank (the
    SPMD program's replicated state), and each rank keeps its slice of
    it, with no communication. On a mesh of one device, or on a rank
    outside ``mesh``, every leaf comes back as a plain tensor.
    """
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.dist import spans_devices
    from repro_torch.dist.api import (is_axes, logical_to_spec,
                                      spec_to_placements)

    spans = spans_devices(mesh)

    def leaf(x, ax):
        if not isinstance(x, torch.Tensor):
            return x
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if not spans:
            return x
        spec = logical_to_spec(ax, rules.get("param", {}), mesh, x.shape)
        return distribute_tensor(x, mesh, spec_to_placements(spec, mesh),
                                 src_data_rank=None)

    return tree_map(leaf, tree, axes_tree, is_leaf=is_axes)


def replicated_axes(tree):
    """Logical-axes tree marking every dim of every leaf unsharded — the
    ``axes_tree`` to pass :func:`reshard_tree`/:func:`rescale_cycle` for
    state with no sharding recipe (e.g. optimizer accumulators)."""
    return tree_map(lambda x: tuple(None for _ in getattr(x, "shape", ())),
                    tree)


def rescale_cycle(directory, step: int, tree, axes_tree, rules: dict,
                  new_workers: int, *, prefer_model: int = 1,
                  meta: Optional[dict] = None, keep: Optional[int] = None):
    """Drive a :class:`ScalePlan` through the state-carrying machinery:
    ``checkpoint.save -> rebuild_mesh -> reshard_tree`` and hand back the
    tree resident on the new mesh, ready to resume.

    Every rank of the world calls it. DTensor leaves are gathered, rank 0
    writes the checkpoint, and every rank restores it (each leaf on its
    device) before the new mesh is carved out of the first
    ``new_workers * prefer_model`` ranks (capped at the world, as the
    reference caps at its devices). ``keep`` bounds the published step
    dirs (checkpoint GC). Returns ``(tree_on_new_mesh, mesh)``.
    """
    import torch.distributed as tdist

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import gather_tree, world_ranks

    full = gather_tree(tree)
    ranks = world_ranks()
    if tdist.get_rank() == 0:
        ckpt.save(directory, int(step), full, keep=keep,
                  meta={"workers": int(new_workers), **(meta or {})})
    if len(ranks) > 1:
        tdist.barrier()
    restored, _ = ckpt.restore(directory, full, step=int(step))
    if len(ranks) > 1:      # no rank's next save may GC a step being read
        tdist.barrier()
    n = max(1, min(len(ranks), int(new_workers) * int(prefer_model)))
    tensors = [x for x in tree_leaves(full) if isinstance(x, torch.Tensor)]
    kind = tensors[0].device.type if tensors else None
    mesh = rebuild_mesh(ranks[:n], prefer_model=prefer_model,
                        device_type=kind)
    return reshard_tree(restored, axes_tree, rules, mesh), mesh


# ---------------------------------------------------------------------------
# Policy: scale decisions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScalePlan:
    action: str              # "hold" | "grow" | "shrink" | "recover"
    workers: int             # target data-parallel worker count
    reason: str
    # a grow/shrink that is not an even re-partition of the old layout
    # must round through a checkpoint (save -> rebuild mesh -> restore)
    needs_checkpoint_cycle: bool = False

    @property
    def changed(self) -> bool:
        return self.action != "hold"


def plan_reshard(old_workers: int, new_workers: int, *,
                 reason: str = "manual") -> ScalePlan:
    """Resharding plan for an explicit worker-count change."""
    if new_workers == old_workers:
        return ScalePlan("hold", old_workers, reason)
    action = "grow" if new_workers > old_workers else "shrink"
    even = (max(old_workers, new_workers) % min(old_workers, new_workers) == 0)
    return ScalePlan(action, new_workers, reason,
                     needs_checkpoint_cycle=not even)


class ElasticController:
    """Hysteresis-guarded worker scaling from rate telemetry.

    ``observe(step, offered, achieved)`` compares the offered stream
    rate against pool capacity, where ``achieved`` is the measured
    *per-worker* throughput (pool capacity = achieved x workers); the
    orchestrator passes its single-pipeline rate. Sustained overload
    (utilization > ``high``) doubles workers; sustained slack
    (utilization < ``low``) halves them. ``patience`` consecutive
    breaches are required before acting, and ``cooldown`` steps must
    pass between actions, so transient bursts don't thrash the mesh.
    """

    def __init__(self, workers: int = 1, *, min_workers: int = 1,
                 max_workers: int = 64, high: float = 1.0, low: float = 0.35,
                 patience: int = 3, cooldown: int = 10):
        self.workers = int(workers)
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.high = high
        self.low = low
        self.patience = patience
        self.cooldown = cooldown
        self._over = 0
        self._under = 0
        self._last_action_step: Optional[int] = None
        self.rescales = 0

    def observe(self, step: int, offered: float, achieved: float) -> ScalePlan:
        # utilization: how much of the pool's throughput the stream needs
        util = offered / max(achieved * self.workers, 1e-9)
        self._over = self._over + 1 if util > self.high else 0
        self._under = self._under + 1 if util < self.low else 0
        in_cooldown = (self._last_action_step is not None and
                       step - self._last_action_step < self.cooldown)
        if in_cooldown:
            return ScalePlan("hold", self.workers, "cooldown")
        if self._over >= self.patience and self.workers < self.max_workers:
            return self._act(step, min(self.workers * 2, self.max_workers),
                             f"overload util={util:.2f}")
        if self._under >= self.patience and self.workers > self.min_workers:
            return self._act(step, max(self.workers // 2, self.min_workers),
                             f"slack util={util:.2f}")
        return ScalePlan("hold", self.workers, "steady")

    def _act(self, step: int, new_workers: int, reason: str) -> ScalePlan:
        plan = plan_reshard(self.workers, new_workers, reason=reason)
        self.workers = new_workers
        self._over = self._under = 0
        self._last_action_step = step
        self.rescales += 1
        return plan

    def involuntary(self, step: int, reason: str,
                    workers: Optional[int] = None) -> ScalePlan:
        """An involuntary rescale — pool loss / failure recovery. The
        trigger is a topology FACT, not a rate sample, so it bypasses
        the patience/cooldown hysteresis entirely and always rounds
        through the checkpoint cycle (the surviving mesh layout is not
        an even re-partition of one that included the dead pool's
        share). Resets the rate streaks and starts the cooldown clock,
        so the next voluntary action still waits out hysteresis."""
        new = self.workers if workers is None else \
            max(self.min_workers, min(int(workers), self.max_workers))
        plan = ScalePlan("recover", new, reason,
                         needs_checkpoint_cycle=True)
        self.workers = new
        self._over = self._under = 0
        self._last_action_step = step
        self.rescales += 1
        return plan
