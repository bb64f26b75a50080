"""Training launcher: builds the mesh, shards params/optimizer per the
arch's recipe, and runs the streaming train loop with async checkpointing
and rate-driven elastic scaling — the JAX package's ``launch/train.py``
on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 50 --batch 8 --seq 64 [--device cpu]

A mesh of ``--data-mesh x --model-mesh`` devices is that many ranks: one
process per device, started here (``torch.multiprocessing``, spawned,
joined through a ``file://`` store in a temporary directory), gloo on
the CPU and NCCL on the cards. On the cards the ranks are capped at the
visible devices, as the reference caps at its devices; a world of one
runs in this process. Every rank runs the same loop; rank 0 prints,
writes checkpoints and takes the elastic decisions, which it broadcasts.
Ranks outside the current mesh (the spare workers an elastic grow may
take) follow the loop without computing.

``--elastic`` activates the rate-driven :class:`ElasticController`; when
it emits a grow/shrink plan the loop drives it through the real
state-carrying cycle — ``checkpoint.save -> rebuild_mesh ->
reshard_tree -> resume`` (dist/elastic.rescale_cycle) — and the next
mesh epoch runs on the rebuilt mesh. ``--elastic-demand`` scales the
offered rate relative to measured per-worker throughput (a synthetic
load curve). Without it the offered load comes from the stream feeder's
queue depth: a prefetch queue that stays FULL for ``patience``
consecutive steps means the source outpaces the pool, so controller
utilization crosses the grow threshold. That signal only grows the pool.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import pathlib
import tempfile
import time

# a rank waits this long for the others in a collective before failing
RANK_TIMEOUT_S = 300


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "lion", "sgd"])
    ap.add_argument("--recipe", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--elastic", action="store_true",
                    help="rate-driven worker scaling via checkpoint cycle")
    ap.add_argument("--max-workers", type=int, default=8,
                    help="elastic data-parallel worker cap")
    ap.add_argument("--elastic-demand", type=float, default=0.0,
                    help="offered rate = demand x per-worker throughput "
                         "(0 = use the measured rate)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the devices the ranks run on")
    return ap.parse_args(argv)


def world_size(args) -> int:
    """Ranks to start: every device a mesh of the run may use, capped at
    the visible cards on ``cuda``."""
    n = args.data_mesh * args.model_mesh
    if args.elastic:
        n = max(n, args.max_workers * args.model_mesh)
    if args.device == "cuda":
        import torch
        n = min(n, max(1, torch.cuda.device_count()))
    return n


def main(argv=None):
    args = parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="s2ce_")
    n = world_size(args)
    if n == 1:
        return train(args)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="s2ce_ranks_") as d:
        mp.start_processes(_rank_main, args=(n, os.path.join(d, "store"),
                                             args),
                           nprocs=n, join=True, start_method="spawn")
    return None


def _rank_main(rank: int, world: int, store: str, args):
    import torch
    import torch.distributed as tdist

    backend = "gloo"
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        backend = "cpu:gloo,cuda:nccl"
    tdist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        train(args)
    finally:
        tdist.destroy_process_group()


def _rank() -> tuple:
    """``(rank, world size)``; ``(0, 1)`` with no process group."""
    import torch.distributed as tdist
    if not tdist.is_initialized():
        return 0, 1
    return tdist.get_rank(), tdist.get_world_size()


def _plan_from_rank0(plan):
    """Rank 0's plan on every rank (each measures its own step time)."""
    import torch.distributed as tdist
    box = [plan]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def train(args):
    """The loop on this rank. Returns ``{"params", "opt", "step",
    "stats"}``: ``stats`` holds each computed step's seconds (the card
    synchronized at its end), each checkpoint's caller-thread seconds
    (gather and host copy), the final write's wait, the run's seconds and
    tok/s, and the rescales."""
    import torch

    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import elastic as el
    from repro_torch.dist.sharding import build_rules
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import model_zoo as zoo
    from repro_torch.streams.generators import DriftSpec, TokenStream
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    rank, world = _rank()
    lead = rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.recipe:
        cfg = cfg.with_overrides(recipe=args.recipe)
    if args.microbatches:
        cfg = cfg.with_overrides(microbatches=args.microbatches)

    n_dev = args.data_mesh * args.model_mesh
    say(f"arch={cfg.name} params={zoo.param_count(cfg)/1e6:.1f}M "
        f"recipe={cfg.recipe} mesh={n_dev} devices")

    gen = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      drift=DriftSpec("abrupt", at=0.5),
                      horizon=float(args.steps * args.batch * args.seq))
    opt = make_optimizer(cfg, args.optimizer, lr=args.lr,
                         total_steps=args.steps)

    ckpt_dir = pathlib.Path(args.ckpt_dir)
    saver = ckpt.AsyncCheckpointer(ckpt_dir) if lead else None
    params = zoo.init_params(cfg, 0, device)
    state = opt.init(params)
    step = 0
    start = 0
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        tree, meta = ckpt.restore(ckpt_dir, {"params": params, "opt": state})
        params, state, start = tree["params"], tree["opt"], meta["step"]
        step = start
        say(f"resumed from step {start}")

    controller = (el.ElasticController(
        workers=args.data_mesh, max_workers=args.max_workers,
        patience=2, cooldown=2) if args.elastic else None)
    workers = args.data_mesh

    # measured-rate elastic mode: rank 0 pulls batches through the stream
    # feeder so its queue depth gives a real offered-load signal (a
    # backlog means the source outpaces the pool -> utilization > 1 ->
    # grow); the other ranks draw the same batches from the stream
    feeder = None
    if controller is not None and args.elastic_demand <= 0 and lead:
        from repro_torch.streams.feeder import StreamFeeder
        feeder = StreamFeeder(lambda shard, idx, n: gen.batch(idx, n),
                              n_shards=1, batch_per_shard=args.batch,
                              deadline_s=30.0, prefetch=4, start_idx=start)
        feeder.start()

    def make_batch(i):
        src = feeder.next() if feeder is not None else gen.batch(i, args.batch)
        batch = {"tokens": torch.from_numpy(src.data["tokens"])}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.frontend_len, cfg.frontend_dim))
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (args.batch, args.seq, cfg.frontend_dim))
        return batch

    stats = {"step_s": [], "save_s": [], "rescales": 0}
    t0 = time.perf_counter()
    i = start
    mesh = None      # the mesh a rescale rebuilt; None: the flags' mesh
    while i < args.steps:
        # one mesh epoch: the step runs under the current mesh; a rescale
        # below breaks out, round-trips state, and re-enters here
        if mesh is not None:
            ctx = (dist.use_mesh(mesh, build_rules(cfg)) if mesh.size() > 1
                   else contextlib.nullcontext())
            ranks = mesh.mesh.flatten().tolist()
        elif workers * args.model_mesh > 1:
            ctx = mesh_context(cfg, workers, args.model_mesh,
                               device=device.type)
            ranks = list(range(workers * args.model_mesh))
        else:
            ctx = contextlib.nullcontext()
            ranks = [0]
        active = rank in ranks
        step_fn = make_train_step(cfg, opt)
        plan = None
        with ctx:
            while i < args.steps:
                t_step = time.perf_counter()
                if active:
                    params, state, step, metrics = step_fn(
                        params, state, step, make_batch(i))
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    stats["step_s"].append(time.perf_counter() - t_step)
                    if (i + 1) % args.ckpt_every == 0:
                        t_save = time.perf_counter()
                        full = dist.gather_tree({"params": params,
                                                 "opt": state})
                        if lead:
                            saver.save(int(step), full)
                        stats["save_s"].append(time.perf_counter() - t_save)
                    if i % 10 == 0:
                        say(f"step {i:4d} loss={float(metrics['loss']):7.3f}"
                            f" gnorm={float(metrics['grad_norm']):6.2f} "
                            f"workers={workers}")
                if controller is not None:
                    if lead:
                        dt_step = max(time.perf_counter() - t_step, 1e-9)
                        achieved = args.batch * args.seq / dt_step / workers
                        if args.elastic_demand > 0:
                            offered = args.elastic_demand * achieved
                        else:
                            # binary backpressure: a SUSTAINED-full
                            # prefetch queue means the source outpaces the
                            # pool -> grow (never under the shrink
                            # threshold; shrinking needs a demand curve)
                            full_q = feeder.backlog >= feeder.prefetch
                            offered = achieved * workers * (2.0 if full_q
                                                            else 1.0)
                        plan = controller.observe(i, offered, achieved)
                    if world > 1:
                        plan = _plan_from_rank0(plan)
                i += 1
                if plan is not None and plan.changed:
                    break
                plan = None
        if plan is not None and plan.changed and i < args.steps:
            # the ROADMAP cycle: save -> rebuild_mesh -> reshard -> resume
            if lead:
                saver.wait()
            step = i         # a spare rank's own count stood still
            tree = {"params": params, "opt": state}
            axes = {"params": zoo.param_axes(cfg),
                    "opt": el.replicated_axes(state)}
            tree, mesh = el.rescale_cycle(
                ckpt_dir, int(step), tree, axes, build_rules(cfg),
                plan.workers, prefer_model=args.model_mesh,
                meta={"reason": plan.reason})
            params, state = tree["params"], tree["opt"]
            workers = plan.workers
            stats["rescales"] += 1
            say(f"elastic {plan.action} -> {workers} workers at step "
                f"{step} ({plan.reason}); resumed from checkpoint "
                f"cycle on a {tuple(mesh.shape)} mesh")
    if feeder is not None:
        feeder.stop()
    if lead:
        t_wait = time.perf_counter()
        saver.close()
        stats["write_s"] = time.perf_counter() - t_wait
    dt = time.perf_counter() - t0
    toks = (args.steps - start) * args.batch * args.seq
    stats.update(seconds=dt, tok_per_s=toks / dt)
    say(f"done: {toks/dt:.0f} tok/s; checkpoints at {ckpt_dir} "
        f"(latest {ckpt.latest_step(ckpt_dir)}, "
        f"rescales={stats['rescales']})")
    return {"params": params, "opt": state, "step": step, "stats": stats}


if __name__ == "__main__":
    main()
