"""Carry op states from the JAX package into the port.

For a stream system the op states are what weights are for a model: a
normalizer's running moments, a reservoir, a learner, a detector. Given
the JAX package's states as numpy trees (``{op name: state}``, e.g.
``jax.tree.map(np.asarray, orchestrator.states)``), :func:`states_from_numpy`
builds the port's states for the same pipeline on a device, so both
packages can continue from the same point.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._tree import tree_flatten_with_path, tree_unflatten
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


def state_from_numpy(template, state_np, device="cpu") -> Any:
    """One op's state: ``state_np`` must have the structure (same fields,
    in the same order) of the port's ``template`` state."""
    want, treedef = tree_flatten_with_path(template)
    have, _ = tree_flatten_with_path(state_np)
    if [p for p, _ in want] != [p for p, _ in have]:
        raise ValueError(f"state structure differs: port {[p for p, _ in want]}"
                         f" vs given {[p for p, _ in have]}")
    leaves = [_leaf(t, v, p, device) for (p, t), (_, v) in zip(want, have)]
    return tree_unflatten(treedef, leaves)


def states_from_numpy(pipeline, states_np: Dict[str, Any],
                      device="cpu") -> Dict[str, Any]:
    """The port's states ``{op name: state}`` for ``pipeline`` on
    ``device``, from the JAX package's states as numpy trees."""
    missing = sorted(set(pipeline.names) - set(states_np))
    if missing:
        raise ValueError(f"no state given for ops {missing}")
    templates = pipeline.init_states("cpu")
    return {name: state_from_numpy(templates[name], states_np[name], device)
            for name in pipeline.names}
