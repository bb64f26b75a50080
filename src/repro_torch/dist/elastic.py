"""Elastic worker management: add/remove-worker rescale decisions.

Two layers:

  * mechanism — :func:`rescale_cycle` drives a rescale through the
    checkpoint: the state tree is saved, restored and placed back on the
    job's device, and the usable devices of the new (data, model) layout
    are listed. The port's "mesh" is that list of CUDA devices; sharded
    layouts over it come with the rest of ``dist`` (ROADMAP).
  * policy — :class:`ElasticController` watches offered vs. achieved
    stream rate and emits :class:`ScalePlan` grow/shrink/hold decisions
    with hysteresis; the orchestrator logs these next to its offload
    decisions.

Data-parallel worker counts stay powers of two so global batches keep
dividing evenly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


# ---------------------------------------------------------------------------
# Mechanism: device list + checkpoint round-trip
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


def usable_devices(device) -> List[torch.device]:
    """The devices a job on ``device`` may spread over: every visible
    CUDA device for a CUDA job, the one CPU for a CPU job."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def rescale_cycle(directory, step: int, tree, new_workers: int, device, *,
                  prefer_model: int = 1, meta: Optional[dict] = None,
                  keep: Optional[int] = None):
    """Drive a :class:`ScalePlan` through the state-carrying machinery:
    ``checkpoint.save -> restore -> place on the job's device``, and hand
    back the tree, ready to resume, with the devices of the new layout.
    ``keep`` bounds the published step dirs (checkpoint GC). Returns
    ``(tree_on_device, devices)``."""
    from repro_torch.dist import checkpoint as ckpt

    ckpt.save(directory, int(step), tree, keep=keep,
              meta={"workers": int(new_workers), **(meta or {})})
    restored, _ = ckpt.restore(directory, tree, step=int(step))
    devices = usable_devices(device)
    n = max(1, min(len(devices), int(new_workers) * int(prefer_model)))
    data, model = factor_mesh(n, prefer_model)
    return restored, devices[:data * model]


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
