"""Multi-pod dry run of the port: trace every (architecture x input-shape
x mesh) cell on fake tensors over a fake world of 512 ranks and record
memory, cost and collective analysis, as the JAX package's dry run
compiles each cell over 512 forced host devices.

A cell's params, optimizer state and batch are fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage), placed on
the mesh as DTensors by the param rules
(``dist/sharding.py::param_sharding_tree``) and, for the batch and the
caches, by the ``"act"`` rules. The step runs once on them, as one rank
runs it (``launch/hlo_analysis.py``). A sharding mismatch or an
unsupported op fails the cell. Records are written to
``experiments/dryrun_torch/<mesh>/<arch>/<shape>.json`` (the JAX
package's go to ``experiments/dryrun/``), so reruns skip green cells.

What the port's steps do on a mesh of several ranks, and the record
says (``step_layout``: ``"sharded"``, or ``"sharded_tp"`` where the
``model`` axis splits heads, ``ff``, ``vocab``, ``dinner`` or experts
and the layers compute on the rank's slice, their activations reduced
over ``model`` where the one-rank layer would have summed them
(``dist/tp.py``), ``"sharded_tp_seq"`` where besides the act rules map
``seq_sp`` to ``model`` and the residual stream between the layers is
the rank's slice of the sequence; ``"one device"`` on a mesh of one):

  * a train cell runs ``make_train_step(cfg, make_optimizer(cfg,
    "adamw"))``: a rank holds its shards of the params and of the AdamW
    state and its slice of the batch across the step; the model gathers
    a layer's weights where the layer runs (again in the backward's
    recompute under remat) and the leaves outside the stacks once, and
    the gradients are reduce-scattered layer by layer in the backward
    (``dist/fsdp.py``). Its peak holds the shards, one layer's gathered
    weights and the entry leaves, shard-sized fp32 gradients, and the
    activations of its slice of the batch;
  * a prefill or decode cell holds the params' shards, gathers each
    layer's weights as it runs and frees them after, and runs its rank's
    slice of the batch and of the caches (under ``"sharded_tp"`` its
    caches hold only its KV heads, ``dinner`` channels or RWKV heads).

Under ``"sharded_tp"`` a traced rank counts its own slice of the split
products, and its links show the activation all-reduces over ``model``
(fp32) in place of the all-gathers of those weights over ``model``;
under ``"sharded_tp_seq"`` the layers' output products are
reduce-scattered and the norms' outputs all-gathered over ``model``
instead. A saved record of another layout than the cell's is traced
again.

The memory record keeps the JAX package's keys where their meaning
holds: ``argument_size_in_bytes`` is the exact bytes of the rank's
shards of the arguments (params, optimizer state, step, batch or
caches). XLA's ``temp_size_in_bytes`` has no counterpart here: the
record holds the peak of the step's live tensors (``MemTracker``) less
the arguments in its place, and ``total_per_device`` their sum, the
traced peak.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu   # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single --force [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --recipe tp_fsdp \\
      --microbatches 4 --device cpu

``--device`` (default ``cuda``) is the device the fake tensors and the
mesh name: no tensor is allocated on it, but without a card ``cuda``
raises rather than trace on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, get_config,
                                 shapes_for, skipped_shapes_for)
from repro_torch.dist import fsdp, spans_devices, use_mesh
from repro_torch.dist.api import (is_axes, logical_to_spec, mesh_sizes,
                                  spec_to_placements)
from repro_torch.dist.sharding import build_rules, param_sharding_tree
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT = ROOT / "experiments" / "dryrun_torch"
WORLD = 512     # the fake world's ranks: the multi-pod mesh's


def _fake(t, dev):
    """A ``meta`` tensor as a fake one on ``dev``; a CPU tensor (a cache's
    length, which the port keeps on the host) as it is."""
    if t.device.type == "cpu":
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=dev)


def _is_placement(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], list)


def _param_placed(full, axes, mesh, rules):
    """``full`` (a fake tree with logical ``axes``) as DTensors placed by
    ``param_sharding_tree``; as it is on a mesh of one device."""
    from torch.distributed.tensor import distribute_tensor

    if not spans_devices(mesh):
        return full
    leaves, treedef = tree_flatten(full)
    where = tree_flatten(param_sharding_tree(axes, mesh, rules, full),
                         is_leaf=_is_placement)[0]
    return tree_unflatten(treedef, [
        distribute_tensor(x, m, p, src_data_rank=None)
        for x, (m, p) in zip(leaves, where)])


def _act_placed(tree, axes, mesh, rules):
    """A batch or cache tree placed by the ``"act"`` rules; the host's
    tensors (real, on the CPU) stay as they are."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import distribute_tensor

    if not spans_devices(mesh):
        return tree

    def leaf(x, ax):
        if not isinstance(x, FakeTensor):
            return x
        spec = logical_to_spec(ax, rules["act"], mesh, x.shape)
        return distribute_tensor(x, mesh, spec_to_placements(spec, mesh),
                                 src_data_rank=None)
    return tree_map(leaf, tree, axes, is_leaf=is_axes)


def _batch(cfg, shape, mesh, rules, dev):
    specs = zoo.input_specs(cfg, shape)
    out = {}
    for k, v in specs.items():
        if k == "caches":
            caches = tree_map(lambda t: _fake(t, dev), v)
            out[k] = _act_placed(caches, zoo.cache_axes(v), mesh, rules)
        else:
            out[k] = _act_placed(_fake(v, dev),
                                 ("batch",) + (None,) * (v.dim() - 1),
                                 mesh, rules)
    return out


def _rank_slice(tree, axes, mesh):
    """Every DTensor leaf as this rank's slice along the mesh ``axes``
    (the batch's), its other sharded dims gathered."""
    from torch.distributed.tensor import DTensor, Replicate

    names = mesh.mesh_dim_names

    def one(x):
        if not isinstance(x, DTensor):
            return x
        keep = [p if names[i] in axes else Replicate()
                for i, p in enumerate(x.placements)]
        if list(x.placements) != keep:
            x = x.redistribute(mesh, keep)
        return x.to_local()
    return tree_map(one, tree)


def _serve_fn(cfg, shape, mesh, rules, impl):
    """The prefill or decode step as one rank runs it: on the params'
    shards (each layer gathered where it runs), the rank's slice of the
    batch and the caches (``dist.fsdp.sharded``)."""
    from torch.distributed.tensor import DTensor

    def axes_of(tokens):
        if not isinstance(tokens, DTensor):
            return ()
        return tuple(mesh.mesh_dim_names[i]
                     for i, p in enumerate(tokens.placements)
                     if p.is_shard(0))

    def shards(params):
        return fsdp.Layout(params, zoo.param_axes(cfg), rules,
                           mesh).local(params)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            axes = axes_of(batch["tokens"])
            params = shards(params)
            batch = _rank_slice(batch, axes, mesh)
            with fsdp.sharded(mesh, rules, axes):
                return zoo.prefill(params, cfg, batch, max_len=shape.seq_len,
                                   impl=impl)
        return prefill_step

    def serve_step(params, caches, tokens):
        axes = axes_of(tokens)
        params = shards(params)
        # a cache's heads or channels stay split over ``model``, where
        # the layers run the rank's share of them
        caches = _rank_slice(caches, axes + ("model",), mesh)
        tokens = _rank_slice(tokens, axes, mesh)
        with fsdp.sharded(mesh, rules, axes):
            return zoo.decode_step(params, cfg, caches, tokens, impl=impl)
    return serve_step


def build_cell(cfg, shape, mesh, rules, impl="chunked", device="cuda"):
    """``(step, example_args)`` for one dry-run cell: the arguments are
    fake tensors on ``device`` placed on ``mesh`` (a ``DeviceMesh``, or a
    stand-in of one device: plain tensors). Call it (and the step) under
    ``use_mesh(mesh, rules)``."""
    if impl == "kernel":
        raise ValueError("the dry run traces the chunked paths: a CUDA "
                         "kernel cannot run on fake tensors")
    dev = resolve_device(device)
    mode = ha.fake_tensor_mode()
    with mode, ha.HostScalars():
        axes = zoo.param_axes(cfg)
        full = tree_map(lambda t: _fake(t, dev), zoo.param_shapes(cfg))
        params = _param_placed(full, axes, mesh, rules)
        batch = _batch(cfg, shape, mesh, rules, dev)
        if shape.kind == "train":
            opt = make_optimizer(cfg, "adamw")
            state = _param_placed(opt.init(full), opt.state_axes(axes),
                                  mesh, rules)
            step = torch.zeros((), dtype=torch.int32, device=dev)
            fn = make_train_step(cfg, opt, impl=impl)
            args = (params, state, step, batch)
        else:
            fn = _serve_fn(cfg, shape, mesh, rules, impl)
            args = ((params, batch) if shape.kind == "prefill"
                    else (params, batch["caches"], batch["tokens"]))
    return fn, args


def argument_bytes(args) -> int:
    """Exact bytes of this rank's shards of ``args``."""
    return sum(t.numel() * t.element_size() for t in ha.local_tensors(args))


def step_layout(sizes: dict, rules, seq_len: int) -> str:
    """What a rank of a cell's step on a mesh of ``sizes`` (axis ->
    ranks) holds and computes: ``"one device"``; ``"sharded"`` (its
    shards, each layer gathered where it runs); ``"sharded_tp"``, where
    a ``model`` axis of more than one rank splits dims the param and act
    rules both map to it, and the layers compute on the rank's slice
    (``dist/tp.py``); or ``"sharded_tp_seq"``, that and the residual
    stream the rank's slice of the sequence (the act rules map
    ``seq_sp`` to ``model`` and ``seq_len`` divides by it:
    reduce-scatters and all-gathers in place of the all-reduces)."""
    from repro_torch.dist.api import _as_tuple
    if math.prod(sizes.values()) <= 1:
        return "one device"
    act = rules.get("act", {})
    m = sizes.get("model", 1)
    if m > 1 and any(
            "model" in _as_tuple(v) and "model" in _as_tuple(act.get(k))
            for k, v in rules.get("param", {}).items()):
        if "model" in _as_tuple(act.get("seq_sp")) and seq_len % m == 0:
            return "sharded_tp_seq"
        return "sharded_tp"
    return "sharded"


def trace_cell(cfg, shape, mesh, rules, impl="chunked", device="cuda"
               ) -> dict:
    """Build one cell and trace its step under ``use_mesh(mesh, rules)``:
    the record's memory, cost, collective and roofline fields."""
    t0 = time.time()
    with use_mesh(mesh, rules):
        fn, args = build_cell(cfg, shape, mesh, rules, impl=impl,
                              device=device)
        t = ha.analyze(fn, args)
    arg = argument_bytes(args)
    counts = cfg.param_counts()
    return {
        "trace_s": round(time.time() - t0, 2),
        "memory": {"argument_size_in_bytes": arg,
                   "temp_size_in_bytes": t["peak_bytes"] - arg,
                   "total_per_device": t["peak_bytes"]},
        "cost": {"flops": t["flops"], "dot_flops": t["dot_flops"],
                 "bytes accessed": t["hbm_bytes"]},
        "collectives": dict(t["collectives"],
                            total=t["collective_bytes_total"]),
        "collective_ops": t["collective_ops"],
        "roofline": rf.from_trace(
            t, cfg, shape, math.prod(mesh_sizes(mesh).values())).to_dict(),
        "step_layout": step_layout(mesh_sizes(mesh), rules, shape.seq_len),
        "params_total": counts["total"],
        "params_active": counts["active"],
    }


_NOTES = {
    "train": "a rank holds its shards of the params and AdamW state and its "
             "slice of the batch; each layer's weights gathered where used "
             "(and in the recompute), its gradients reduce-scattered",
    "prefill": "a rank holds its shards of the params, gathers each layer's "
               "weights as it runs, and runs its slice of the batch",
    "decode": "a rank holds its shards of the params, gathers each layer's "
              "weights as it runs, and runs its slice of the batch and the "
              "caches",
}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             recipe=None, impl="chunked", overrides=None, tag="",
             force=False, save=True, device="cuda") -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    out_dir = OUT / (mesh_name + (f"_{tag}" if tag else ""))
    out_path = out_dir / arch / f"{shape_name}.json"
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    if recipe:
        cfg = cfg.with_overrides(recipe=recipe)
    shape = SHAPES_BY_NAME[shape_name]
    if out_path.exists() and not force:
        # a green record of the layout the cell runs now; an older
        # layout's (gathered over ``model``) is traced again
        rec = json.loads(out_path.read_text())
        sizes = dict(zip(("pod", "data", "model")[-3 if multi_pod else -2:],
                         (2, 16, 16) if multi_pod else (16, 16)))
        try:
            want = step_layout(sizes, build_rules(cfg, shape=shape),
                               shape.seq_len)
        except ValueError:
            want = None
        if not rec.get("ok") or rec.get("step_layout") == want:
            return rec
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "recipe": cfg.recipe, "impl": impl, "tag": tag,
           "overrides": overrides or {}, "device": str(device),
           "note": _NOTES[shape.kind], "ok": False}
    t0 = time.time()
    try:
        rules = build_rules(cfg, shape=shape)
        fake_world(WORLD)
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rec.update(trace_cell(cfg, shape, mesh, rules, impl=impl,
                              device=device))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if save:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--recipe", default=None)
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors and the mesh "
                         "(cuda needs a card; cpu traces anywhere)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = {}
    if args.microbatches:
        overrides["microbatches"] = args.microbatches

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        names = [args.shape] if args.shape else [s.name for s in shapes_for(cfg)]
        for skipped in skipped_shapes_for(cfg):
            if not args.shape:
                print(f"SKIP  {arch:>24s} {skipped.name:>12s}  "
                      "(full attention; long_500k is for sub-quadratic mixers)")
                n_skip += 1
        for shape_name in names:
            for mp in meshes:
                rec = run_cell(arch, shape_name, mp, recipe=args.recipe,
                               impl=args.impl, tag=args.tag,
                               overrides=overrides or None, force=args.force,
                               device=args.device)
                status = "OK  " if rec["ok"] else "FAIL"
                mesh_name = "multi " if mp else "single"
                extra = ""
                if rec["ok"]:
                    m = rec["memory"].get("total_per_device", 0) / 2**30
                    dom = rec["roofline"]["dominant"]
                    extra = f"mem/dev={m:6.2f}GiB dom={dom}"
                else:
                    extra = rec.get("error", "")[:120]
                print(f"{status}  {arch:>24s} {shape_name:>12s} {mesh_name} "
                      f"t={rec['total_s']:7.1f}s  {extra}", flush=True)
                n_ok += rec["ok"]
                n_fail += (not rec["ok"])
    print(f"\ndone: {n_ok} ok, {n_fail} failed, {n_skip} skipped-by-design")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
