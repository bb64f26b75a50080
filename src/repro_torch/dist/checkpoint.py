"""Step-numbered checkpointing.

Layout: ``<dir>/step_<010d>/{arrays.npz, manifest.json}``. Writes are
atomic (tmp dir + ``os.replace``) so a reader never sees a partial
checkpoint and ``latest_step`` only reports fully-published steps.
Restore is *structure-checked*: the target tree must have exactly the
saved leaves (a mismatch raises ``ValueError`` naming the keys) and
each leaf comes back with the target leaf's dtype and device.

The port carries ``save``/``restore`` (what the elastic rescale cycle
uses); the JAX package's asynchronous writer comes with the rest of
``dist`` (ROADMAP).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_flatten_with_path, tree_unflatten

_STEP_PREFIX = "step_"
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _step_dir(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"{_STEP_PREFIX}{int(step):010d}"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        # np.savez has no bfloat16/fp8: widen, restore casts back
        if not t.dtype.is_complex and t.dtype not in (
                torch.float16, torch.float32, torch.float64, torch.bool,
                torch.int8, torch.int16, torch.int32, torch.int64,
                torch.uint8):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save(directory, step: int, tree, *, meta: Optional[dict] = None,
         keep: Optional[int] = None) -> pathlib.Path:
    """Write ``tree`` as checkpoint ``step``; optionally GC old steps."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = directory / f".tmp_{final.name}_{os.getpid()}_{threading.get_ident()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        flat, _ = tree_flatten_with_path(tree)
        arrays = {k: _to_numpy(v) for k, v in flat}
        with open(tmp / _ARRAYS, "wb") as f:
            np.savez(f, **arrays)
        manifest = {"step": int(step), "meta": meta or {},
                    "keys": sorted(arrays)}
        (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None:
        _gc(directory, keep)
    return final


def _published_steps(directory) -> list:
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for p in directory.iterdir():
        if p.name.startswith(_STEP_PREFIX) and (p / _MANIFEST).exists():
            try:
                out.append(int(p.name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(out)


def _gc(directory, keep: int):
    steps = _published_steps(directory)
    for s in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    steps = _published_steps(directory)
    return steps[-1] if steps else None


def restore(directory, like, step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``; returns (tree, meta).

    ``meta`` is ``{"step": int, "meta": {...saved metadata...}}``. The
    saved leaf set must match ``like`` exactly; extra or missing leaves
    raise ``ValueError`` naming the offending keys. Each restored leaf
    takes the dtype and device of the corresponding ``like`` leaf.
    """
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = _step_dir(directory, step)
    manifest = json.loads((d / _MANIFEST).read_text())
    flat, treedef = tree_flatten_with_path(like)
    want = [k for k, _ in flat]
    have = set(manifest["keys"])
    missing = sorted(set(want) - have)   # in `like` but not in checkpoint
    extra = sorted(have - set(want))     # in checkpoint but not in `like`
    if missing or extra:
        raise ValueError(
            f"checkpoint structure mismatch at step {step}: "
            f"target leaves not in checkpoint: {missing or 'none'}; "
            f"checkpoint leaves not in target: {extra or 'none'}")
    leaves = []
    with np.load(d / _ARRAYS) as z:
        for k, ref in flat:
            arr = torch.from_numpy(np.array(z[k]))
            if isinstance(ref, torch.Tensor):
                arr = arr.to(device=ref.device, dtype=ref.dtype)
            leaves.append(arr)
    tree = tree_unflatten(treedef, leaves)
    return tree, {"step": manifest["step"], "meta": manifest["meta"]}
