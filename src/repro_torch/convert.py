"""Carry op states and model weights from the JAX package into the port.

For a stream system the op states are what weights are for a model: a
normalizer's running moments, a reservoir, a learner, a detector. Given
the JAX package's states as numpy trees (``{op name: state}``, e.g.
``jax.tree.map(np.asarray, orchestrator.states)``), :func:`states_from_numpy`
builds the port's states for the same pipeline on a device, so both
packages can continue from the same point. :func:`state_from_numpy`
carries one state, such as an edge node's ``CountMin`` (table, seeds) or
``MisraGries`` (keys, counts) sketch, onto the port's template of it
(``streams/sketches.py``), after which it continues bitwise.
:func:`params_from_numpy` does the same for a model's parameter tree,
and :func:`opt_state_from_numpy` / :func:`step_from_numpy` for a
trainer's optimizer state and step, so both packages continue training
from the same step. :func:`cache_from_numpy` carries a serving cache
(a whole cache tree, or one ``KVCache``, ``MLACache`` or ``MambaState``),
so both packages decode on from the same cache.

Every entry point defaults to ``device="cuda"`` and raises where CUDA is
not available; pass ``device="cpu"`` to build on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_flatten_with_path, tree_map, tree_unflatten
from repro_torch.models import model_zoo as zoo
from repro_torch.streams.sampling import SEED_MASK


def key_to_seed(key) -> int:
    """A generator seed from a JAX PRNG key (two uint32 words)."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    return ((int(k[0]) << 32) | int(k[-1])) & SEED_MASK


def _leaf(template: torch.Tensor, value, path: str, device) -> torch.Tensor:
    a = np.asarray(value)
    if (template.dtype == torch.int64 and template.dim() == 0
            and a.dtype == np.uint32 and a.shape == (2,)):
        # a JAX PRNG key where the port keeps a generator seed
        return torch.tensor(key_to_seed(a), dtype=torch.int64, device=device)
    if tuple(a.shape) != tuple(template.shape):
        raise ValueError(f"state leaf {path}: shape {a.shape} where the port "
                         f"has {tuple(template.shape)}")
    return torch.as_tensor(np.array(a), device=device).to(template.dtype)


def state_from_numpy(template, state_np, device="cuda") -> Any:
    """One op's state: ``state_np`` must have the structure (same fields,
    in the same order) of the port's ``template`` state."""
    device = resolve_device(device)
    want, treedef = tree_flatten_with_path(template)
    have, _ = tree_flatten_with_path(state_np)
    if [p for p, _ in want] != [p for p, _ in have]:
        raise ValueError(f"state structure differs: port {[p for p, _ in want]}"
                         f" vs given {[p for p, _ in have]}")
    leaves = [_leaf(t, v, p, device) for (p, t), (_, v) in zip(want, have)]
    return tree_unflatten(treedef, leaves)


def states_from_numpy(pipeline, states_np: Dict[str, Any],
                      device="cuda") -> Dict[str, Any]:
    """The port's states ``{op name: state}`` for ``pipeline`` on
    ``device``, from the JAX package's states as numpy trees."""
    missing = sorted(set(pipeline.names) - set(states_np))
    if missing:
        raise ValueError(f"no state given for ops {missing}")
    templates = pipeline.init_states("cpu")
    return {name: state_from_numpy(templates[name], states_np[name], device)
            for name in pipeline.names}


def _tree_from_numpy(template, tree_np, device, what: str,
                     host_leaf=lambda path: False):
    """``tree_np`` (numpy leaves, bf16 ones included) on ``device``, leaf
    for leaf onto ``template`` (tensors, ``meta`` ones included): each
    leaf takes its template leaf's dtype; a leaf whose path
    ``host_leaf`` names goes to the CPU. Raises on a missing, extra or
    misshaped leaf."""
    want, treedef = tree_flatten_with_path(template)
    have = dict(tree_flatten_with_path(tree_np)[0])
    paths = [p for p, _ in want]
    missing = sorted(set(paths) - set(have))
    extra = sorted(set(have) - set(paths))
    if missing or extra:
        raise ValueError(f"{what} tree differs: missing {missing}, "
                         f"extra {extra}")
    leaves = []
    for p, t in want:
        a = np.asarray(have[p])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what} {p}: shape {a.shape} where the port "
                             f"has {tuple(t.shape)}")
        # through fp32, which holds every bf16 value exactly
        a = np.array(a, dtype=np.float32 if t.is_floating_point() else None)
        dev = torch.device("cpu") if host_leaf(p) else device
        leaves.append(torch.from_numpy(a).to(device=dev, dtype=t.dtype))
    return tree_unflatten(treedef, leaves)


def params_from_numpy(cfg, params_np, device="cuda"):
    """The port's parameter tree for ``cfg`` on ``device``, leaf for leaf
    from the JAX package's (``jax.tree.map(np.asarray, params)``), in the
    configuration's parameter dtype. Raises on a missing, extra or
    misshaped leaf."""
    return _tree_from_numpy(zoo.param_shapes(cfg), params_np,
                            resolve_device(device), "parameter")


def cache_from_numpy(template, cache_np, device="cuda"):
    """A serving cache on ``device``, leaf for leaf from the JAX package's
    (``jax.tree.map(np.asarray, caches)``) onto the port's ``template``
    of it (``zoo.init_caches(..., device="meta")``, or one cache such as
    ``init_mla_cache``'s): each leaf in its template leaf's dtype, every
    ``length`` on the CPU, where the port keeps it. Raises on a missing,
    extra or misshaped leaf."""
    return _tree_from_numpy(template, cache_np, resolve_device(device),
                            "cache", lambda p: p.endswith(".length"))


def opt_state_from_numpy(optimizer, params, state_np, device="cuda"):
    """The port's state of ``optimizer`` (``repro_torch.train.optim``)
    over the port's ``params``, leaf for leaf from the JAX package's
    state of the same optimizer as numpy trees: AdamW's ``m``, ``v`` and
    ``master``, Lion's ``m``, Adafactor's factored ``vr`` and ``vc`` (``v``
    for a vector), SGD's ``m``. Each leaf takes the dtype the port's
    ``init`` gives it. Raises on a missing, extra or misshaped leaf."""
    shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), params)
    return _tree_from_numpy(optimizer.init(shapes), state_np,
                            resolve_device(device), "optimizer state")


def step_from_numpy(step, device="cuda") -> torch.Tensor:
    """The JAX package's step counter as the port's: a 0-dim int32
    tensor on ``device``."""
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                        device=resolve_device(device))
