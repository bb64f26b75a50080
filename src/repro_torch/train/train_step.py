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

The params, gradients and accumulators are pinned to their layout
(``pin_params``) where the reference pins them; on the local tensors of
a rank's computation, and on one device, a pin is the identity.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import dist
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import pin_params
from repro_torch.dist.api import logical_to_spec, mesh_sizes, spec_to_placements
from repro_torch.dist.elastic import replicated_axes, reshard_tree
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
    use_mesh`) the step is data-parallel over the global batch: each rank
    gathers the params, optimizer state and batch (DTensors or replicated
    plain tensors), takes its slice of every (micro)batch along the mesh axes
    that ``batch`` maps onto, computes its gradients under a view of the
    mesh with those axes at size 1 (so MoE token groups are its own),
    averages gradients, loss and metrics over them, applies the update
    to the full values, and returns params and state as DTensors laid
    out by the param rules (each rank holding its shards), not the given
    objects.

    ``grad_compression="int8"`` passes the accumulated gradients through
    the edge-uplink int8 wire format (dist/compression) before clipping:
    what an edge worker's sync sees on a constrained uplink."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    # the model's logical axes pin its params; a custom loss has its own
    # params, which they do not describe
    _axes = zoo.param_axes(cfg) if loss_fn is None else None
    loss_fn = loss_fn or (lambda p, b: lm_loss(p, cfg, b, impl=impl))
    M = microbatches if microbatches is not None else cfg.microbatches

    def pin(leaves, treedef):
        """``pin_params`` over a flat list of param-shaped leaves: the
        reference pins params, gradients and accumulators to the param
        layout (the identity on a rank's plain tensors)."""
        if _axes is None or not dist.mesh_active():
            return leaves
        return tree_flatten(pin_params(tree_unflatten(treedef, leaves),
                                       _axes))[0]

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = pin(leaves, treedef)
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
                pin(grads, treedef), treedef)

    def accumulate(params, batch, local):
        """``(loss, metrics, fp32 grads, treedef)`` of ``batch``, each
        (micro)batch first cut to ``local``'s slice of it."""
        if M <= 1:
            loss, metrics, grads, treedef = grads_of(params, local(batch))
            return loss, metrics, [g.to(torch.float32) for g in grads], \
                treedef
        mb = _split_microbatches(batch, M)
        grads, losses = None, []
        for i in range(M):
            l, _, g, treedef = grads_of(
                params, local({k: v[i] for k, v in mb.items()}))
            if grads is None:
                grads = pin([torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g],
                            treedef)
            for a, gg in zip(grads, g):
                a.add_(gg.to(torch.float32) / M)
            del g
            losses.append(l)
        return torch.mean(torch.stack(losses)), {}, grads, treedef

    def update(params, opt_state, step, loss, metrics, grads, treedef):
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

    def train_step(params, opt_state, step, batch):
        mesh = dist.current_mesh()
        if not dist.spans_devices(mesh):
            dev = tree_flatten(params)[0][0].device
            loss, metrics, grads, treedef = accumulate(
                params, _batch_on(batch, dev), lambda b: b)
            return update(params, opt_state, step, loss, metrics, grads,
                          treedef)
        rules = dist.current_rules()
        params, opt_state, batch = dist.gather_tree((params, opt_state,
                                                     batch))
        dev = tree_flatten(params)[0][0].device
        batch = _batch_on(batch, dev)
        axes = _batch_axes(batch, rules, mesh)
        sizes = {n: (1 if n in axes else s)
                 for n, s in mesh_sizes(mesh).items()}
        with dist.use_mesh(_MeshView(sizes), rules):
            loss, metrics, grads, treedef = accumulate(
                params, batch, lambda b: _local_batch(b, rules, mesh))
        loss, metrics, grads = _mean_over(mesh, axes, loss, metrics, grads)
        params, opt_state, step, metrics = update(
            params, opt_state, step, loss, metrics, grads, treedef)
        p_axes = _axes if _axes is not None else replicated_axes(params)
        return (reshard_tree(params, p_axes, rules, mesh),
                reshard_tree(opt_state, optimizer.state_axes(p_axes), rules,
                             mesh),
                step, metrics)

    return train_step


# ---------------------------------------------------------------------------
# Data parallelism over a mesh
# ---------------------------------------------------------------------------

class _MeshView:
    """A mesh stand-in (``.shape`` name -> size): what :func:`axis_size`
    reads while a rank computes on its slice of the batch."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)

    @property
    def axis_names(self):
        return tuple(self.shape)


def _batch_spec(x: torch.Tensor, rules: dict, mesh):
    axes = ("batch",) + (None,) * (x.dim() - 1)
    return logical_to_spec(axes, rules.get("act", {}), mesh, x.shape)


def _batch_axes(batch: dict, rules: dict, mesh) -> tuple:
    """The mesh axes the batch dim is split over (those of ``tokens``)."""
    part = _batch_spec(batch["tokens"], rules, mesh)[0]
    return () if part is None else ((part,) if isinstance(part, str)
                                    else tuple(part))


def _local_batch(batch: dict, rules: dict, mesh) -> dict:
    """This rank's slice of every batch tensor along the mesh axes that
    ``batch`` maps onto (its DTensor shard, with no communication)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        spec = _batch_spec(x, rules, mesh)
        return distribute_tensor(x, mesh, spec_to_placements(spec, mesh),
                                 src_data_rank=None).to_local()
    return {k: one(v) for k, v in batch.items()}


def _mean_over(mesh, axes, loss, metrics, grads):
    """Loss, metrics and gradients averaged over the mesh ``axes`` (one
    all-reduce of one flat fp32 buffer each)."""
    import torch.distributed as tdist

    if not axes:
        return loss, metrics, grads
    keys = sorted(metrics)
    parts = [g.reshape(-1) for g in grads] + [
        loss.to(torch.float32).reshape(1)] + [
        metrics[k].to(torch.float32).reshape(1) for k in keys]
    flat = torch.cat(parts)
    for name in axes:
        tdist.all_reduce(flat, op=tdist.ReduceOp.AVG,
                         group=mesh.get_group(name))
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    loss = flat[at]
    metrics = {k: flat[at + 1 + i] for i, k in enumerate(keys)}
    return loss, metrics, out


__all__ = ["global_norm", "clip_by_global_norm", "make_train_step"]
