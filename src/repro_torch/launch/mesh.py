"""Meshes of the launchers.

Defined as FUNCTIONS so importing this module touches no process group.
A mesh's devices are the ranks of the default process group (one device
a rank); a process with no group is a world of one
(:func:`repro_torch.dist.world_ranks`). ``make_production_mesh`` carves
the single-pod (16,16)=256-device mesh or the multi-pod (2,16,16)=512 one
out of a world that large, as the JAX package's does out of its devices.
"""

from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    from repro_torch import resolve_device
    from repro_torch.dist import device_mesh, world_ranks

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    ranks = world_ranks()
    if len(ranks) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {len(ranks)} — "
            "start one process per device (the 256/512-device dry run "
            "is not part of the port yet)")
    return device_mesh(resolve_device(device).type, ranks[:n], shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A (data, model) mesh over the first ``data * model`` ranks."""
    from repro_torch import resolve_device
    from repro_torch.dist import device_mesh, world_ranks

    n = data * model
    ranks = world_ranks()
    if len(ranks) < n:
        raise ValueError(f"mesh ({data}, {model}) needs {n} devices, "
                         f"have {len(ranks)}")
    return device_mesh(resolve_device(device).type, ranks[:n],
                       (data, model), ("data", "model"))


def make_elastic_mesh(prefer_model: int = 1, failed=(), *, device="cuda"):
    """Best-effort mesh over whatever ranks currently survive.

    Used after an elastic grow/shrink or a worker failure: carves the
    largest power-of-two data axis (x ``prefer_model``) out of the
    non-failed ranks via dist/elastic.
    """
    from repro_torch import resolve_device
    from repro_torch.dist import world_ranks
    from repro_torch.dist.elastic import rebuild_mesh

    return rebuild_mesh(world_ranks(), failed=failed,
                        prefer_model=prefer_model,
                        device_type=resolve_device(device).type)


def mesh_context(cfg, data: int = 1, model: int = 1, *, shape=None,
                 device="cuda"):
    """``use_mesh`` context for a local (data, model) mesh with the
    arch's recipe rules — the one-liner launchers use to activate
    distribution (a (1,1) request still yields a working context)."""
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import build_rules
    return use_mesh(make_local_mesh(data, model, device=device),
                    build_rules(cfg, shape=shape))
