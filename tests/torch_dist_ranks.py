"""The ranks of ``tests/test_torch_dist.py``'s multi-process checks.

One process per rank of a 4-rank gloo world on the CPU (spawned by the
test, joined through a ``file://`` store): each rank runs the port's
distributed pieces on a (2, 2) mesh and saves what it holds with
``torch.save`` for the test to hold against the JAX package. Imports
torch and the port only, so a spawned rank does not load JAX.
"""

from __future__ import annotations

import datetime
import pathlib

import torch
import torch.distributed as tdist

# a rank waits this long for the others before failing
RANK_TIMEOUT_S = 120

RESHARD_RULES = {"param": {"embed": ("data",), "ff": ("model",),
                           "flat": ("data", "model")}, "act": {}}
RESHARD_AXES = {"w": ("embed", "ff"), "b": ("embed",), "v": ("flat",),
                "s": ()}
# (failed ranks, prefer_model) for rebuild_mesh over the 4 ranks
REBUILD_CASES = (((), 2), ((1,), 2), ((3,), 1), ((0, 2), 1), ((1, 2, 3), 4))


def reshard_tree_input() -> dict:
    return {"w": torch.arange(32.0).reshape(8, 4), "b": torch.ones(5),
            "v": torch.arange(16.0), "s": torch.tensor(3.0)}


def _flat(tree):
    from repro_torch._tree import tree_flatten_with_path
    return dict(tree_flatten_with_path(tree)[0])


def train_case(case: dict, mesh_shape):
    """One step of ``case`` (a config, SGD at a constant rate, params and
    tokens) under a mesh of ``mesh_shape`` over the first ranks: the
    gathered params, each leaf's local shape and the loss."""
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.train.optim import constant_schedule, sgd
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(case["arch"], smoke=True).with_overrides(
        recipe=case["recipe"])
    opt = sgd(constant_schedule(case["lr"]))
    params = case["params"]
    step_fn = make_train_step(cfg, opt, microbatches=1)
    with mesh_context(cfg, *mesh_shape, device="cpu"):
        p, s, _, m = step_fn(params, opt.init(params), 0,
                             {"tokens": case["tokens"]})
    local = {k: tuple(v.to_local().shape) for k, v in _flat(p).items()}
    return {"params": dist.gather_tree(p), "local_shapes": local,
            "loss": float(m["loss"]), "state_local": {
                k: tuple(v.to_local().shape) for k, v in _flat(s).items()}}


def run(rank: int, world: int, store: str, out: str, payload: str):
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        res = _checks(rank, torch.load(payload, weights_only=False))
        torch.save(res, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def _checks(rank: int, case: dict) -> dict:
    from repro_torch import dist
    from repro_torch.dist.compression import compressed_allreduce_mean
    from repro_torch.dist.elastic import rebuild_mesh, reshard_tree
    from repro_torch.launch.mesh import make_local_mesh

    res = {}
    mesh = make_local_mesh(2, 2, device="cpu")
    tree = reshard_tree_input()
    placed = reshard_tree(tree, RESHARD_AXES, RESHARD_RULES, mesh)
    res["coordinate"] = tuple(mesh.get_coordinate())
    res["local"] = {k: v.to_local().clone() for k, v in placed.items()}
    res["placements"] = {k: [p.dim if p.is_shard() else None
                             for p in v.placements]
                         for k, v in placed.items()}
    res["roundtrip"] = {k: bool(torch.equal(v.full_tensor(), tree[k]))
                        for k, v in placed.items()}

    res["rebuild"] = []
    for failed, prefer in REBUILD_CASES:
        m = rebuild_mesh(list(range(4)), failed=failed, prefer_model=prefer,
                         device_type="cpu")
        res["rebuild"].append((tuple(m.shape), m.mesh.flatten().tolist()))

    x = case["workers_x"][rank]
    with dist.use_mesh(make_local_mesh(4, 1, device="cpu")):
        res["cmean_mesh"] = compressed_allreduce_mean(x, group="data")
    res["cmean_world"] = compressed_allreduce_mean(x, group=tdist.group.WORLD)

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_context
    cfg = get_config("qwen2-1.5b", smoke=True).with_overrides(
        recipe="tp_fsdp")
    with mesh_context(cfg, 2, 2, device="cpu"):
        res["axis_heads"] = dist.axis_size("heads")

    res["dense"] = train_case(case["dense"], (2, 2))
    res["moe"] = train_case(case["moe"], (2, 2))
    return res
