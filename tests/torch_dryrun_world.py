"""The fake-world half of ``tests/test_torch_dryrun.py``, run as one
process of its own: a process holds one process group, and the test
files share their pytest workers.

``python tests/torch_dryrun_world.py OUT_DIR`` writes ``OUT_DIR/world.json``
with what the test holds against the JAX package: the meshes over fake
worlds of 256 and 512 ranks and the refusals, the arguments a rank of
three full-width cells, the collectives of a granite smoke step on a
(2, 4) mesh, a tensor-parallel cell on (1, 1) and (1, 2) meshes, the memory of a wide narrow-batch train cell on shards, ``run_cell``'s records (cut configs, written under
``OUT_DIR``), ``main``'s exit code for a failing cell, and one real
``selftune.evaluate_candidate``. Imports torch and the port only.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch.distributed as tdist

CUT = {"n_layers": 2}           # the cut configs of the record checks
COLLECTIVES_CUT = {"recipe": "ep_fsdp", "remat": "full"}
MEMORY_CUT = {"n_layers": 2, "remat": "full"}   # the wide cell's cut
MEMORY_B, MEMORY_S = 4, 64
SERVE_CELLS = ("prefill_32k", "decode_32k")
# a tp_fsdp cell traced on (1, 1) and (1, 2) meshes at two depths (the
# encoder's and the decoder's layers each), B x S
TP_ARCH, TP_CUT = "seamless-m4t-medium", {"recipe": "tp_fsdp",
                                          "remat": "full"}
TP_DEPTHS = (2, 4)
TP_B, TP_S = 2, 16
ARG_CELLS = (("qwen2-1.5b", "fsdp"), ("qwen2-1.5b", "tp_fsdp"),
             ("granite-moe-1b-a400m", "ep_fsdp"))


def _raises(fn) -> str:
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return ""


def _mesh(m) -> dict:
    return {"shape": list(m.shape), "names": list(m.mesh_dim_names),
            "device": m.device_type}


def worlds() -> dict:
    from repro_torch.dist import world_ranks
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    out = {}
    world_ranks()                       # a real world of one (gloo)
    out["refused_under_real"] = _raises(lambda: fake_world(256))
    tdist.destroy_process_group()
    out["world_256"] = fake_world(256)
    out["single_256"] = _mesh(make_production_mesh(device="cpu"))
    out["multi_on_256"] = _raises(
        lambda: make_production_mesh(multi_pod=True, device="cpu"))
    out["grow_256"] = _raises(lambda: fake_world(512))
    out["again_256"] = fake_world(128)
    tdist.destroy_process_group()
    out["world_512"] = fake_world(512)
    out["single_512"] = _mesh(make_production_mesh(device="cpu"))
    out["multi_512"] = _mesh(make_production_mesh(multi_pod=True,
                                                  device="cpu"))
    return out


def argument_cells() -> dict:
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import build_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device="cpu")
    shape = SHAPES_BY_NAME["train_4k"]
    out = {}
    for arch, recipe in ARG_CELLS:
        cfg = get_config(arch).with_overrides(recipe=recipe)
        rules = build_rules(cfg, shape=shape)
        with use_mesh(mesh, rules):
            _, args = dryrun.build_cell(cfg, shape, mesh, rules,
                                        device="cpu")
        out[f"{arch}/{recipe}"] = dryrun.argument_bytes(args)
    return out


def collectives_cell() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.sharding import build_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config("granite-moe-1b-a400m", smoke=True).with_overrides(
        **COLLECTIVES_CUT)
    shape = InputShape("tiny_train", 32, 8, "train")
    mesh = make_local_mesh(2, 4, device="cpu")
    return dryrun.trace_cell(cfg, shape, mesh, build_rules(cfg, shape=shape),
                             device="cpu")


def memory_cell() -> dict:
    """A wide, narrow-batch train cell on shards: qwen2-1.5b's full width
    at ``MEMORY_CUT`` on a (2, 4) mesh, ``MEMORY_B`` x ``MEMORY_S``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.sharding import build_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config("qwen2-1.5b").with_overrides(**MEMORY_CUT)
    shape = InputShape("narrow_train", MEMORY_S, MEMORY_B, "train")
    return dryrun.trace_cell(cfg, shape, make_local_mesh(2, 4, device="cpu"),
                             build_rules(cfg, shape=shape), device="cpu")


def tp_cells() -> dict:
    """``TP_ARCH``'s smoke config under ``tp_fsdp`` (``TP_CUT``) at each
    of ``TP_DEPTHS`` on (data 1, model 1) and (data 1, model 2) meshes:
    a train cell's record (a rank's matrix-product operations, its
    layout and links) and a decode cell's KV cache bytes a rank (its
    self- and cross-attention K and V, as the decode step receives
    them)."""
    from torch.distributed.tensor import DTensor
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import build_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    base = get_config(TP_ARCH, smoke=True).with_overrides(**TP_CUT)
    train = InputShape("tp_train", TP_S, TP_B, "train")
    decode = InputShape("tp_decode", TP_S, TP_B, "decode")
    out = {}
    for model in (1, 2):
        mesh = make_local_mesh(1, model, device="cpu")
        for depth in TP_DEPTHS:
            cfg = base.with_overrides(enc_layers=depth, dec_layers=depth,
                                      n_layers=2 * depth)
            rec = dryrun.trace_cell(cfg, train, mesh,
                                    build_rules(cfg, shape=train),
                                    device="cpu")
            rules = build_rules(cfg, shape=decode)
            with use_mesh(mesh, rules):
                _, args = dryrun.build_cell(cfg, decode, mesh, rules,
                                            device="cpu")
            kv = 0
            for path, t in tree_flatten_with_path(args[1])[0]:
                if path.endswith((".k", ".v")):
                    t = t.to_local() if isinstance(t, DTensor) else t
                    kv += t.numel() * t.element_size()
            out[f"{model}/{depth}"] = {
                "dot_flops": rec["cost"]["dot_flops"],
                "step_layout": rec["step_layout"],
                "collectives": rec["collectives"], "kv_bytes": kv}
    return out


def records(out_dir: pathlib.Path) -> dict:
    from repro_torch.core import selftune
    from repro_torch.launch import dryrun

    dryrun.OUT = out_dir / "dryrun_torch"
    out = {"cells": {}}
    for shape in ("train_4k",) + SERVE_CELLS:
        out["cells"][shape] = dryrun.run_cell(
            "qwen2-1.5b", shape, False, overrides=CUT, force=True,
            device="cpu")
    path = dryrun.OUT / "pod_16x16" / "qwen2-1.5b" / "train_4k.json"
    stamp = path.stat().st_mtime_ns
    out["reread"] = dryrun.run_cell("qwen2-1.5b", "train_4k", False,
                                    device="cpu")
    out["reread_untouched"] = path.stat().st_mtime_ns == stamp
    out["failed"] = dryrun.run_cell("qwen2-1.5b", "train_4k", False,
                                    recipe="bogus", tag="bad", force=True,
                                    device="cpu")
    out["main_rc"] = dryrun.main(
        ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", "single",
         "--recipe", "bogus", "--tag", "bad", "--force", "--device", "cpu"])
    r = selftune.evaluate_candidate(
        "qwen2-1.5b", "train_4k", selftune.Candidate(dict(CUT), note="cut"),
        device="cpu")
    out["candidate"] = {"ok": r.ok, "mem_gib": r.mem_gib,
                        "bound_s": r.bound_s, "dominant": r.dominant,
                        "roofline_fraction": r.roofline_fraction,
                        "useful_ratio": r.useful_ratio, "record": r.record}
    return out


def main(out_dir: pathlib.Path) -> None:
    out = worlds()
    out["arguments"] = argument_cells()
    out["collectives"] = collectives_cell()
    out["memory"] = memory_cell()
    out["tp"] = tp_cells()
    out.update(records(out_dir))
    (out_dir / "world.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]))
