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

Where the reference pins params, gradients and accumulators to their
sharded layout, the port's step on a mesh of several ranks holds them as
the rank's shards (``dist/fsdp.py``): the model gathers each layer's
weights where it uses them and the gather's backward reduce-scatters its
gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import dist
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp
from repro_torch.dist.api import logical_to_spec, spec_to_placements
from repro_torch.dist.elastic import replicated_axes
from repro_torch.models import model_zoo as zoo
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

    Under a mesh of more than one device (:func:`repro_torch.dist.
    use_mesh`) the step computes on the rank's shards, as the reference's
    pinned step does (``dist/fsdp.py``). Params and optimizer state
    (DTensors, or full values every rank holds) are laid out by the param
    rules (:class:`~repro_torch.dist.fsdp.Layout`) and the rank keeps its
    shards; the batch is its slice along the mesh axes ``batch`` maps
    onto, split into microbatches locally. The rank computes under a view
    of the mesh with those axes at size 1 (so MoE token groups are its
    own); the model gathers each layer's weights where the layer runs
    and the gathers' backward reduce-scatters the gradients, which arrive
    shard-shaped and accumulate in fp32. Once, after accumulation, the
    gradients of leaves not sharded over a batch axis, the loss and the
    metrics are averaged over it; the global norm and the int8 wire
    format's scale are the whole leaves' (all-reduces over each leaf's
    sharded axes); the optimizer updates the shards in place. It returns
    params and state as DTensors of those shards (no communication), not
    the given objects.

    ``grad_compression="int8"`` passes the accumulated gradients through
    the edge-uplink int8 wire format (dist/compression) before clipping:
    what an edge worker's sync sees on a constrained uplink."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    # the model's logical axes lay out its params; a custom loss has its
    # own params, which they do not describe (replicated on a mesh)
    _axes = zoo.param_axes(cfg) if loss_fn is None else None
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

    def accumulate(params, batch):
        """``(loss, metrics, fp32 grads, treedef)`` of ``batch``."""
        if M <= 1:
            loss, metrics, grads, treedef = grads_of(params, batch)
            return loss, metrics, [g.to(torch.float32) for g in grads], \
                treedef
        mb = _split_microbatches(batch, M)
        grads, losses = None, []
        for i in range(M):
            l, _, g, treedef = grads_of(params,
                                        {k: v[i] for k, v in mb.items()})
            if grads is None:
                grads = [torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in g]
            for a, gg in zip(grads, g):
                a.add_(gg.to(torch.float32) / M)
            del g
            losses.append(l)
        return torch.mean(torch.stack(losses)), {}, grads, treedef

    def update(params, opt_state, step, loss, metrics, grads, treedef,
               layout=None):
        if grad_compression == "int8":
            from repro_torch.dist.compression import int8_roundtrip
            amax = [torch.max(torch.abs(g.float())) for g in grads]
            if layout is not None:
                amax = layout.reduce(amax, "max")
            grads = [int8_roundtrip(g, a) for g, a in zip(grads, amax)]
        # clip_by_global_norm's arithmetic, in place: the fp32 gradients
        # are this step's own, and a copy would be 4 bytes a parameter
        if layout is None:
            gnorm = global_norm(grads)
        else:
            gnorm = torch.sqrt(sum(layout.reduce(
                [torch.sum(torch.square(g.to(torch.float32))) for g in grads],
                "sum")))
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

    def train_step(params, opt_state, step, batch):
        mesh = dist.current_mesh()
        if not dist.spans_devices(mesh):
            dev = tree_flatten(params)[0][0].device
            loss, metrics, grads, treedef = accumulate(
                params, _batch_on(batch, dev))
            return update(params, opt_state, step, loss, metrics, grads,
                          treedef)
        rules = dist.current_rules()
        p_axes = _axes if _axes is not None else replicated_axes(params)
        p_lay = fsdp.Layout(params, p_axes, rules, mesh)
        s_lay = fsdp.Layout(opt_state, optimizer.state_axes(p_axes), rules,
                            mesh)
        params, opt_state = p_lay.local(params), s_lay.local(opt_state)
        dev = tree_flatten(params)[0][0].device
        axes = _batch_axes(batch, rules, mesh)
        batch = _local_batch(_batch_on(batch, dev), rules, mesh)
        with fsdp.sharded(mesh, rules, axes, p_lay):
            loss, metrics, grads, treedef = accumulate(params, batch)
            loss, metrics, grads = _mean_over(mesh, axes, p_lay, loss,
                                              metrics, grads)
            params, opt_state, step, metrics = update(
                params, opt_state, step, loss, metrics, grads, treedef,
                p_lay)
        return p_lay.placed(params), s_lay.placed(opt_state), step, metrics

    return train_step


# ---------------------------------------------------------------------------
# Data parallelism over a mesh
# ---------------------------------------------------------------------------

def _batch_spec(x: torch.Tensor, rules: dict, mesh):
    axes = ("batch",) + (None,) * (x.dim() - 1)
    return logical_to_spec(axes, rules.get("act", {}), mesh, x.shape)


def _batch_axes(batch: dict, rules: dict, mesh) -> tuple:
    """The mesh axes of more than one rank the batch dim is split over
    (those of ``tokens``): a mean over an axis of one rank is the
    identity, and no collective runs for it."""
    from repro_torch.dist.api import mesh_sizes
    part = _batch_spec(batch["tokens"], rules, mesh)[0]
    axes = () if part is None else ((part,) if isinstance(part, str)
                                    else tuple(part))
    sizes = mesh_sizes(mesh)
    return tuple(a for a in axes if sizes[a] > 1)


def _local_batch(batch: dict, rules: dict, mesh) -> dict:
    """This rank's slice of every batch tensor along the mesh axes that
    ``batch`` maps onto (a placed DTensor's local tensor, a full value's
    slice; no communication where the DTensor is placed so)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        pl = spec_to_placements(_batch_spec(x, rules, mesh), mesh)
        if isinstance(x, DTensor):
            if list(x.placements) != pl:
                x = x.redistribute(mesh, pl)
            return x.to_local()
        return distribute_tensor(x, mesh, pl, src_data_rank=None).to_local()
    return {k: one(v) for k, v in batch.items()}


def _mean_over(mesh, axes, layout, loss, metrics, grads):
    """Loss and metrics averaged over the batch's mesh ``axes``, and each
    gradient over those of them its leaf is not sharded on (the gather's
    backward averaged it over the others): one all-reduce of one flat
    fp32 buffer an axis."""
    if not axes:
        return loss, metrics, grads
    keys = sorted(metrics)
    scalars = [loss.to(torch.float32).reshape(1)] + [
        metrics[k].to(torch.float32).reshape(1) for k in keys]
    grads = list(grads)
    for name in axes:
        idx = [i for i in range(len(grads)) if name not in layout.axes(i)]
        flat = fsdp.all_reduce(torch.cat(
            [grads[i].reshape(-1) for i in idx] + scalars), (name,), mesh,
            "mean")
        at = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[at:at + n].view_as(grads[i])
            at += n
        scalars = list(flat[at:].split(1))
    loss = scalars[0][0]
    metrics = {k: scalars[1 + i][0] for i, k in enumerate(keys)}
    return loss, metrics, grads


__all__ = ["global_norm", "clip_by_global_norm", "make_train_step"]
