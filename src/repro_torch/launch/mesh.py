"""Meshes of the launchers.

Defined as FUNCTIONS so importing this module touches no process group.
A mesh's devices are the ranks of the default process group (one device
a rank); a process with no group is a world of one
(:func:`repro_torch.dist.world_ranks`). ``make_production_mesh`` carves
the single-pod (16,16)=256-device mesh or the multi-pod (2,16,16)=512 one
out of a world that large, as the JAX package's does out of its devices.
The dry run (and only the dry run) makes that world a fake one in one
process (:func:`fake_world`), as the JAX package forces 512 host
devices; a real world of processes stays the launchers' route.
"""

from __future__ import annotations

import atexit
import math


def fake_world(n: int) -> int:
    """Start a fake process group of ``n`` ranks in this process (this
    process is rank 0; a collective on it moves nothing), unless a fake
    world of at least ``n`` ranks is up already. Returns the world's size.

    A fake world and a real one never mix: with a real group up (a
    launcher's ranks, or the world of one that ``dist.world_ranks``
    makes) this raises ``RuntimeError``, as it does for a fake world
    smaller than ``n``."""
    import torch.distributed as tdist

    if tdist.is_initialized():
        if tdist.get_backend() != "fake":
            raise RuntimeError(
                f"a real process group ({tdist.get_backend()}, "
                f"{tdist.get_world_size()} ranks) is up: a fake world of "
                f"{n} ranks cannot share its process")
        have = tdist.get_world_size()
        if have < n:
            raise RuntimeError(f"a fake world of {have} ranks is up; "
                               f"{n} are needed")
        return have
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this torch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), "
            "which the dry run's fake world needs") from e
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=n)
    from repro_torch.dist import _close_world
    atexit.register(_close_world)
    return n


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
            "start a fake world first (fake_world(512); launch/dryrun.py "
            "does this) or one process per device")
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
