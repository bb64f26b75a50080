"""Optimizers built from scratch: AdamW, Adafactor, Lion, SGD.

The JAX package's ``train/optim.py`` in PyTorch. Each optimizer is a pair
of plain functions over the port's parameter trees plus a *state-axes*
reflector (what a step on a mesh lays the state out by: each rank holds
and updates its shards). AdamW, Lion and SGD are elementwise, so a shard
updates as the whole leaf would; Adafactor's means over a sharded dim
and its update's RMS are a local sum and an all-reduce over the mesh
axes that shard the dim (``dist/fsdp.py``). States respect ``cfg.opt_state_dtype``
and optionally carry fp32 master weights (``cfg.fp32_master``) when
params live in bf16. The schedules and the bias corrections are fp32
tensors on the step's device, as the reference computes them, and every
update repeats the reference's arithmetic operation for operation in
fp32.

``update(grads, state, params, step)`` returns ``(params, state)`` and
works IN PLACE, under ``torch.no_grad``: the returned trees are the given
ones, their tensors overwritten (the reference donates these buffers to
its jitted step). A caller that needs the old values (a checkpoint
snapshot, a second run from the same start) copies them first.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch._tree import tree_flatten, tree_flatten_with_path, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                 # params -> state
    update: Callable[..., tuple]               # (grads, state, params, step) -> (params, state)
    state_axes: Callable[[Any], Any]           # param_axes -> state_axes


def _zeros_like_tree(tree, dtype):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                          device=x.device), tree)


def _device(tree) -> torch.device:
    return tree_flatten(tree)[0][0].device


def _step(step, device) -> torch.Tensor:
    """The step as a 0-dim tensor on ``device``."""
    if isinstance(step, torch.Tensor):
        return step.to(device)
    return torch.tensor(int(step), dtype=torch.int32, device=device)


def _f32(step) -> torch.Tensor:
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step)
    return step.to(torch.float32)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``: an fp32 tensor on the step's
    device."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float):
    return lambda step: torch.full((), lr_val, dtype=torch.float32,
                                   device=_f32(step).device)


def _as_schedule(lr):
    return lr if callable(lr) else constant_schedule(lr)


def _leaves(*trees):
    """Each tree's leaves, in the same (tree) order."""
    return [tree_flatten(t)[0] for t in trees]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32,
          fp32_master: bool = False) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        st = {"m": _zeros_like_tree(params, state_dtype),
              "v": _zeros_like_tree(params, state_dtype)}
        if fp32_master:
            st["master"] = tree_map(
                lambda x: x.to(torch.float32, copy=True), params)
        return st

    @torch.no_grad()
    def update(grads, state, params, step):
        step = _step(step, _device(params))
        stepf = step.to(torch.float32) + 1.0
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr_t = lr(step)
        base = state.get("master", params)
        gs, ms, vs, bs, ps = _leaves(grads, state["m"], state["v"],
                                          base, params)
        for g, m, v, b, p in zip(gs, ms, vs, bs, ps):
            g = g.to(torch.float32)
            m_new = b1 * m.to(torch.float32) + (1 - b1) * g
            v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
            mhat = m_new / bc1
            vhat = v_new / bc2
            b32 = b.to(torch.float32)
            p_new = b32 - lr_t * (mhat / (torch.sqrt(vhat) + eps)
                                  + weight_decay * b32)
            m.copy_(m_new)
            v.copy_(v_new)
            b.copy_(p_new)
            if b is not p:
                p.copy_(p_new)
        return params, state

    def state_axes(param_axes):
        st = {"m": param_axes, "v": param_axes}
        if fp32_master:
            st["master"] = param_axes
        return st

    return Optimizer(init, update, state_axes)


# ---------------------------------------------------------------------------
# Lion (memory-light: single momentum)
# ---------------------------------------------------------------------------

def lion(lr, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1,
         state_dtype=torch.bfloat16) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        return {"m": _zeros_like_tree(params, state_dtype)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr(_step(step, _device(params)))
        gs, ms, ps = _leaves(grads, state["m"], params)
        for g, m, p in zip(gs, ms, ps):
            g = g.to(torch.float32)
            m32 = m.to(torch.float32)
            d = torch.sign(b1 * m32 + (1 - b1) * g)
            p32 = p.to(torch.float32)
            p_new = p32 - lr_t * (d + weight_decay * p32)
            m_new = b2 * m32 + (1 - b2) * g
            p.copy_(p_new)
            m.copy_(m_new)
        return params, state

    return Optimizer(init, update, lambda ax: {"m": ax})


# ---------------------------------------------------------------------------
# Adafactor (factored second moment: frontier-scale memory)
# ---------------------------------------------------------------------------

def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map_axes(fn, tree):
    """``fn`` over the axes tuples of a logical-axes tree."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_axes(fn, v) for v in tree)
    return tree


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    lr = _as_schedule(lr)

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def leaf(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"v": tree_map(leaf, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        from repro_torch.dist import fsdp
        step = _step(step, _device(params))
        stepf = step.to(torch.float32) + 1.0
        rho = torch.clamp(1.0 / torch.pow(stepf, decay), max=1e-2)
        beta = 1.0 - rho
        lr_t = lr(step)
        gs = tree_flatten(grads)[0]
        # inside a step on shards: the params' layout, whose sharded dims
        # each mean below reduces over
        ctx = fsdp.current()
        lay = ctx.layout if ctx is not None else None
        # each parameter's {"vr", "vc"} or {"v"}, found by its path
        vs = dict(tree_flatten_with_path(state["v"])[0])
        for i, (g, (path, p)) in enumerate(zip(
                gs, tree_flatten_with_path(params)[0])):
            def mean(x, pdims, dim=None, keepdim=False):
                """The whole leaf's mean of ``x`` over ``dim`` (all dims
                when None), which are the param's dims ``pdims``."""
                axes = () if lay is None else lay.axes(i, pdims)
                if not axes:
                    return (torch.mean(x) if dim is None else
                            torch.mean(x, dim=dim, keepdim=keepdim))
                s = (torch.sum(x) if dim is None else
                     torch.sum(x, dim=dim, keepdim=keepdim))
                n = math.prod(lay.shapes[i][d] for d in pdims)
                return fsdp.all_reduce(s, axes, lay.mesh, "sum") / n

            nd = p.dim()
            v = {k: vs[f"{path}[{k!r}]"] for k in (
                ("vr", "vc") if _factored(p.shape) else ("v",))}
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * mean(g2, (nd - 1,), -1)
                vc = beta * v["vc"] + (1 - beta) * mean(g2, (nd - 2,), -2)
                rfac = torch.rsqrt(vr / mean(vr, (nd - 2,), -1, True) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                v2 = beta * v["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v2 + eps)
                v["v"].copy_(v2)
            # update clipping
            rms = torch.sqrt(mean(torch.square(u), tuple(range(nd)))
                             + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.to(torch.float32)
            p.copy_(p32 - lr_t * (u + weight_decay * p32))
        return params, state

    def state_axes(param_axes):
        def leaf(ax):
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"v": _map_axes(leaf, param_axes)}

    return Optimizer(init, update, state_axes)


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------

def sgd(lr, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr = _as_schedule(lr)

    def init(params):
        return {"m": _zeros_like_tree(params, torch.float32)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr(_step(step, _device(params)))
        gs, ms, ps = _leaves(grads, state["m"], params)
        for g, m, p in zip(gs, ms, ps):
            g = g.to(torch.float32)
            m_new = momentum * m + g
            d = g + momentum * m_new if nesterov else m_new
            p.copy_(p.to(torch.float32) - lr_t * d)
            m.copy_(m_new)
        return params, state

    return Optimizer(init, update, lambda ax: {"m": ax})


def make_optimizer(cfg, name: str = "adamw", lr=3e-4,
                   total_steps: int = 10000, warmup: int = 200) -> Optimizer:
    from repro_torch.models.layers import dtype_of
    sched = cosine_schedule(lr, warmup, total_steps) if not callable(lr) else lr
    if name == "adamw":
        return adamw(sched, state_dtype=dtype_of(cfg.opt_state_dtype),
                     fp32_master=cfg.fp32_master
                     and cfg.param_dtype != "float32")
    if name == "lion":
        return lion(sched)
    if name == "adafactor":
        return adafactor(sched)
    if name == "sgd":
        return sgd(sched)
    raise KeyError(name)


__all__ = ["Optimizer", "cosine_schedule", "constant_schedule", "adamw",
           "lion", "adafactor", "sgd", "make_optimizer"]
