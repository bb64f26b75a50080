"""Training as a placement-priced operator: :func:`dl_train_op` wraps
the :func:`~repro_torch.train.train_step.make_train_step` factory as a
pipeline :class:`~repro_torch.core.pipeline.Op` whose state is the
``(params, opt_state, step)`` triple and whose
:class:`~repro_torch.core.costmodel.OperatorCost` comes from the roofline
6ND rule (:func:`repro_torch.launch.roofline.dl_operator_cost`), as the
JAX package's ``train/ops.py``. An assigned zoo architecture is then
placed by the frontier DP like any other operator: ``state_bytes`` (the
full param + optimizer tree) prices it against ``mem_cap``, and
``edge_capable=False`` (the default, S2CE's "full DL training is a cloud
concern") anchors it on a pod.

The op fn is the *unmodified* train step applied to the channel env:
under the identity codec the pipeline-wrapped step is bitwise the
standalone ``train_step`` on the same device (the differential contract
in the tests). Its state lives on the op's device, the card unless the
caller asks for the CPU, and the step updates it in place.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_bytes
from repro_torch.core.costmodel import OperatorCost
from repro_torch.core.pipeline import Op
from repro_torch.launch.roofline import dl_operator_cost
from repro_torch.models import model_zoo as zoo
from repro_torch.train.optim import Optimizer
from repro_torch.train.train_step import make_train_step


def train_state_bytes(cfg, optimizer: Optimizer) -> float:
    """Resident bytes of the train op's state (params + optimizer
    moments), from shapes only: the optimizer's ``init`` runs on the
    ``meta`` tensors of ``zoo.param_shapes``, so nothing is
    materialized."""
    pshapes = zoo.param_shapes(cfg)
    return tree_bytes(pshapes) + tree_bytes(optimizer.init(pshapes))


def dl_train_op(cfg, optimizer: Optimizer, *, batch_size: int,
                seq_len: int, name: str = "dl_train",
                impl: str = "chunked", seed: int = 0,
                clip_norm: float = 1.0,
                microbatches: Optional[int] = None,
                grad_compression: Optional[str] = None,
                edge_capable: bool = False,
                cost: Optional[OperatorCost] = None,
                extra_reads: Tuple[str, ...] = (),
                device="cuda") -> Op:
    """The zoo train step as a pipeline op.

    * state: ``(params, opt_state, step)``, initialized on ``device``
      from ``zoo.init_params(cfg, seed)`` / ``optimizer.init``, the step
      a 0-dim int32 tensor;
    * channels: reads ``("tokens",)`` (plus family extras /
      ``extra_reads``), writes per-step ``("loss", "grad_norm")``;
    * cost: roofline-declared (6ND per sequence event, weight-stream
      HBM traffic, full state residency) unless ``cost`` is given.
    """
    extras = tuple(extra_reads)
    if cfg.family == "vlm" and "patches" not in extras:
        extras += ("patches",)
    if cfg.family == "encdec" and "frames" not in extras:
        extras += ("frames",)
    train_step = make_train_step(
        cfg, optimizer, impl=impl, clip_norm=clip_norm,
        microbatches=microbatches, grad_compression=grad_compression)
    model_keys = ("tokens",) + extras

    def fn(state, batch):
        params, opt_state, step = state
        model_in = {k: batch[k] for k in model_keys if k in batch}
        params, opt_state, step, metrics = train_step(
            params, opt_state, step, model_in)
        out = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}
        return (params, opt_state, step), out

    def init():
        dev = resolve_device(device)
        params = zoo.init_params(cfg, seed, device=dev)
        return (params, optimizer.init(params),
                torch.zeros((), dtype=torch.int32, device=dev))

    if cost is None:
        cost = dl_operator_cost(
            name, cfg, phase="train", batch=batch_size, seq_len=seq_len,
            param_bytes=tree_bytes(zoo.param_shapes(cfg)),
            out_bytes_per_event=8.0,
            state_bytes=train_state_bytes(cfg, optimizer),
            edge_capable=edge_capable)
    else:
        cost = replace(cost, name=name)
    return Op(name, fn, cost, init=init,
              reads=model_keys, writes=("loss", "grad_norm"))


__all__ = ["dl_train_op", "train_state_bytes"]
