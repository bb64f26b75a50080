"""Train-step factory: microbatched gradient accumulation, global-norm
clipping, the optimizer update, metrics.

The JAX package's ``train/train_step.py`` in PyTorch. Gradients come from
``torch.autograd.grad`` over the parameter leaves (the model runs its
plain chunked paths: no kernel of the port has a backward, and the
kernels' wrappers refuse a tensor that requires grad). Microbatches run
one after another and their gradients are summed in fp32 as
``acc + g / M``, in the reference's order. The step updates the given
params and optimizer state IN PLACE (see :mod:`repro_torch.train.optim`)
and returns them.

The reference pins the params and gradients to their sharded layout
(``pin_params``): a sharding constraint, with no meaning on one device,
so it is left out.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import lm_loss
from repro_torch.train.optim import Optimizer


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32, summed
    leaf after leaf in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_flatten(tree)[0]))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to at most max_norm in fp32, its norm before)``."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, tree), n


def _split_microbatches(batch: dict, m: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % m == 0, f"batch {b} not divisible by microbatches {m}"
        return x.reshape(m, b // m, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def _batch_on(batch: dict, device) -> dict:
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    impl: str = "chunked", clip_norm: float = 1.0,
                    loss_fn: Optional[Callable] = None,
                    microbatches: Optional[int] = None,
                    grad_compression: Optional[str] = None) -> Callable:
    """Returns train_step(params, opt_state, step, batch) ->
    (params, opt_state, step+1, metrics), the params and state updated in
    place. ``step`` is an int or a 0-dim tensor; the batch's tensors are
    moved to the params' device.

    ``grad_compression="int8"`` passes the accumulated gradients through
    the edge-uplink int8 wire format (dist/compression) before clipping:
    what an edge worker's sync sees on a constrained uplink."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    loss_fn = loss_fn or (lambda p, b: lm_loss(p, cfg, b, impl=impl))
    M = microbatches if microbatches is not None else cfg.microbatches

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        xs = [t.detach().requires_grad_(t.is_floating_point())
              for t in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(treedef, xs), batch)
            want = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(loss, want, allow_unused=True))
        grads = []
        for x in xs:
            g = next(got) if x.requires_grad else None
            grads.append(torch.zeros_like(x) if g is None else g)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads, treedef)

    def train_step(params, opt_state, step, batch):
        dev = tree_flatten(params)[0][0].device
        batch = _batch_on(batch, dev)
        if M <= 1:
            loss, metrics, grads, treedef = grads_of(params, batch)
            grads = [g.to(torch.float32) for g in grads]
        else:
            mb = _split_microbatches(batch, M)
            grads, losses = None, []
            for i in range(M):
                l, _, g, treedef = grads_of(
                    params, {k: v[i] for k, v in mb.items()})
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g]
                for a, gg in zip(grads, g):
                    a.add_(gg.to(torch.float32) / M)
                del g
                losses.append(l)
            loss = torch.mean(torch.stack(losses))
            metrics = {}
        if grad_compression == "int8":
            from repro_torch.dist.compression import int8_roundtrip
            grads = [int8_roundtrip(g) for g in grads]
        # clip_by_global_norm's arithmetic, in place: the fp32 gradients
        # are this step's own, and a copy would be 4 bytes a parameter
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
        params, opt_state = optimizer.update(
            tree_unflatten(treedef, grads), opt_state, params, step)
        out_metrics = {"loss": loss.to(torch.float32),
                       "grad_norm": gnorm.to(torch.float32)}
        for k, v in (metrics or {}).items():
            out_metrics[k] = v.to(torch.float32)
        return params, opt_state, step + 1, out_metrics

    return train_step


__all__ = ["global_norm", "clip_by_global_norm", "make_train_step"]
