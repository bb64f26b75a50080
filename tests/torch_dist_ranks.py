"""The ranks of ``tests/test_torch_dist.py``'s multi-process checks.

One process per rank of a 4-rank gloo world on the CPU (spawned by the
test, joined through a ``file://`` store): each rank runs the port's
distributed pieces on a (2, 2) mesh (the train and serve steps on the
rank's shards) and saves what it holds with ``torch.save`` for the test
to hold against the single process and the JAX package. Imports
torch and the port only, so a spawned rank does not load JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import pathlib

import torch
import torch.distributed as tdist

# a rank waits this long for the others before failing
RANK_TIMEOUT_S = 120
RANK_THREADS = 2

RESHARD_RULES = {"param": {"embed": ("data",), "ff": ("model",),
                           "flat": ("data", "model")}, "act": {}}
RESHARD_AXES = {"w": ("embed", "ff"), "b": ("embed",), "v": ("flat",),
                "s": ()}
# the step on shards: case -> (arch, recipe, optimizer, microbatches,
# gradient compression), each at remat "full". On the (2, 2) mesh the
# tp/ep recipes compute on the rank's slice of heads, ff, vocab,
# dinner or experts (dist/tp.py)
TRAIN_CASES = {
    "dense": ("qwen2-1.5b", "tp_fsdp", "sgd", 1, None),
    "moe": ("granite-moe-1b-a400m", "ep_fsdp", "sgd", 1, None),
    "fsdp_adamw": ("qwen2-1.5b", "fsdp", "adamw", 1, None),
    "fsdp_adafactor": ("qwen2-1.5b", "fsdp", "adafactor", 1, None),
    "tp_int8": ("qwen2-1.5b", "tp_fsdp", "sgd", 2, "int8"),
    "tp_adafactor": ("qwen2-1.5b", "tp_fsdp", "adafactor", 1, None),
    "rwkv": ("rwkv6-1.6b", "tp_fsdp", "sgd", 1, None),
    "hybrid": ("jamba-1.5-large-398b", "ep_tp_fsdp", "sgd", 1, None),
    "mla_moe": ("deepseek-v2-lite-16b", "ep_fsdp", "sgd", 1, None),
    "mla_tp": ("deepseek-v2-lite-16b", "ep_tp_fsdp", "sgd", 1, None),
    "vlm": ("llama-3.2-vision-90b", "tp_fsdp", "sgd", 1, None),
    "dense_seq": ("qwen2-1.5b", "tp_fsdp", "sgd", 1, None),
    "rwkv_seq": ("rwkv6-1.6b", "tp_fsdp", "sgd", 1, None),
    "hybrid_seq": ("jamba-1.5-large-398b", "ep_tp_fsdp", "sgd", 1, None),
    "vlm_seq": ("llama-3.2-vision-90b", "tp_fsdp", "sgd", 1, None),
    "mla_tp_seq": ("deepseek-v2-lite-16b", "ep_tp_fsdp", "sgd", 1, None),
}
# serving on shards: case -> (arch, recipe)
SERVE_CASES = {
    "encdec": ("seamless-m4t-medium", "tp_fsdp"),
    "rwkv": ("rwkv6-1.6b", "tp_fsdp"),
    "hybrid": ("jamba-1.5-large-398b", "ep_tp_fsdp"),
    "mla_moe": ("deepseek-v2-lite-16b", "ep_fsdp"),
    "mla_tp": ("deepseek-v2-lite-16b", "ep_tp_fsdp"),
    "vlm": ("llama-3.2-vision-90b", "tp_fsdp"),
    "encdec_seq": ("seamless-m4t-medium", "tp_fsdp"),
    "encdec_seq_odd": ("seamless-m4t-medium", "tp_fsdp"),
    "rwkv_seq": ("rwkv6-1.6b", "tp_fsdp"),
    "hybrid_seq": ("jamba-1.5-large-398b", "ep_tp_fsdp"),
    "mla_tp_seq": ("deepseek-v2-lite-16b", "ep_tp_fsdp"),
}
# the cases with ``seq_shard=True``: the act rules map ``seq_sp`` to
# ``model``, so the residual stream between the layers is the rank's
# slice of the sequence where it divides (dist/tp.py); each is the twin of
# the case without ``_seq`` (the same config, params and batch)
SEQ_SHARD = ("dense_seq", "rwkv_seq", "hybrid_seq", "vlm_seq", "mla_tp_seq",
             "encdec_seq", "encdec_seq_odd")
# a serve case's prompt tokens; 11 does not divide over the model axis
SERVE_PROMPT = {"encdec_seq_odd": 11}
SERVE_TOKENS = 5                 # the prefill's token and 4 decode steps
# (failed ranks, prefer_model) for rebuild_mesh over the 4 ranks
REBUILD_CASES = (((), 2), ((1,), 2), ((3,), 1), ((0, 2), 1), ((1, 2, 3), 4))


def reshard_tree_input() -> dict:
    return {"w": torch.arange(32.0).reshape(8, 4), "b": torch.ones(5),
            "v": torch.arange(16.0), "s": torch.tensor(3.0)}


def _flat(tree):
    from repro_torch._tree import tree_flatten_with_path
    return dict(tree_flatten_with_path(tree)[0])


def make_opt(cfg, case: dict):
    """``case``'s optimizer at its constant rate."""
    from repro_torch.train.optim import constant_schedule, make_optimizer
    return make_optimizer(cfg, case["opt"],
                          lr=constant_schedule(case["lr"]))


def case_config(case: dict):
    from repro_torch.configs import get_config
    seq = {"seq_shard": True} if case.get("seq_shard") else {}
    return get_config(case["arch"], smoke=True).with_overrides(
        recipe=case["recipe"], remat="full", **seq)


def recording(opt, into: list):
    """``opt`` with each update's gradients (the step's clipped fp32
    gradients, a rank's shards on a mesh) appended to ``into``."""
    from repro_torch.train.optim import Optimizer

    def update(grads, state, params, step):
        into.append(grads)
        return opt.update(grads, state, params, step)
    return Optimizer(opt.init, update, opt.state_axes)


class GatherLog:
    """Every ``all_gather_into_tensor`` while entered: the ranks of its
    group, and whether a parameter's gather (``fsdp._Gather``) or an
    activation's (``tp.gather_out``; the sequence's: ``tp.gather_in``,
    a ``gather_out`` called from it, and the backward of
    ``tp.reduce_scatter_out`` and ``tp.seq_slice``) made it. Every
    ``reduce_scatter_tensor`` and ``all_reduce`` too (``reductions``),
    with what made it and ``phase`` at the call."""

    MAKERS = ("_Gather.forward", "_GatherOut.forward",
              "_ReduceScatterOut.forward", "_ReduceScatterOut.backward",
              "_SeqSlice.backward", "_ReduceOut.forward",
              "_CopyIn.backward")
    CALL_SITES = ("gather_in",)       # named by their caller, not the maker

    def __init__(self):
        self.calls = []
        self.reductions = []
        self.phase = "all"

    def _who(self):
        import sys
        f, who = sys._getframe(2), "other"
        while f is not None:
            name = f.f_code.co_qualname
            if name in self.CALL_SITES:
                return name
            if who == "other" and name in self.MAKERS:
                who = name
            f = f.f_back
        return who

    def __enter__(self):
        self._real = real = (tdist.all_gather_into_tensor,
                             tdist.reduce_scatter_tensor, tdist.all_reduce)

        def gathered(out, src, group=None, *a, **k):
            who = self._who()
            if who.endswith(".forward") and who.startswith(
                    ("_Gather.", "_GatherOut.")):
                who = who.split(".")[0]
            self.calls.append((tuple(tdist.get_process_group_ranks(group)),
                               who))
            return real[0](out, src, group, *a, **k)

        def scattered(out, src, op=tdist.ReduceOp.SUM, group=None, *a,
                      **k):
            ranks = (tuple(tdist.get_process_group_ranks(group))
                     if group is not None else None)
            self.reductions.append((ranks, "reduce_scatter", self._who(),
                                    self.phase))
            return real[1](out, src, op, group, *a, **k)

        def reduced(t, op=tdist.ReduceOp.SUM, group=None, *a, **k):
            ranks = (tuple(tdist.get_process_group_ranks(group))
                     if group is not None else None)
            self.reductions.append((ranks, "all_reduce", self._who(),
                                    self.phase))
            return real[2](t, op, group, *a, **k)
        (tdist.all_gather_into_tensor, tdist.reduce_scatter_tensor,
         tdist.all_reduce) = gathered, scattered, reduced
        return self

    def __exit__(self, *exc):
        (tdist.all_gather_into_tensor, tdist.reduce_scatter_tensor,
         tdist.all_reduce) = self._real

    def _groups(self, mesh) -> dict:
        return {tuple(tdist.get_process_group_ranks(mesh.get_group(a))): a
                for a in mesh.mesh_dim_names}

    def by_axis(self, mesh) -> dict:
        """``{(axis, who): calls}`` of the all-gathers over the mesh's
        axis groups."""
        groups = self._groups(mesh)
        out = {}
        for ranks, who in self.calls:
            key = (groups.get(ranks, "other"), who)
            out[key] = out.get(key, 0) + 1
        return out

    def reductions_by_axis(self, mesh) -> dict:
        """``{(axis, kind, who, phase): calls}`` of the reduce-scatters and
        all-reduces."""
        groups = self._groups(mesh)
        out = {}
        for ranks, kind, who, phase in self.reductions:
            key = (groups.get(ranks, "other"), kind, who, phase)
            out[key] = out.get(key, 0) + 1
        return out


class RoutingLog:
    """The expert ids of every MoE layer run while entered (``moe.top_k``
    wrapped: its indices, each call's in order)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.ids, self._real = [], moe.top_k

        def top_k(probs, k):
            vals, idx = self._real(probs, k)
            self.ids.append(idx.clone())
            return vals, idx
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._real


def train_case(case: dict, mesh_shape):
    """One step of ``case`` (a config, its optimizer at a constant rate,
    params, tokens, microbatches and gradient compression) under a mesh
    of ``mesh_shape`` over the first ranks: the gathered params, the
    gathered clipped gradients, each leaf's local shape (the optimizer
    state's too), the loss, the gradient norm and the all-gathers by
    mesh axis and maker."""
    from repro_torch import dist
    from repro_torch.dist import fsdp
    from repro_torch.dist.sharding import build_rules
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train.train_step import make_train_step

    cfg = case_config(case)
    grads = []
    opt = recording(make_opt(cfg, case), grads)
    params = case["params"]
    step_fn = make_train_step(cfg, opt, microbatches=case["microbatches"],
                              grad_compression=case["compression"])
    with mesh_context(cfg, *mesh_shape, device="cpu") as mesh, \
            GatherLog() as log:
        p, s, _, m = step_fn(params, opt.init(params), 0,
                             {"tokens": case["tokens"],
                              **case.get("extra", {})})
    gathers = log.by_axis(mesh)
    reductions = log.reductions_by_axis(mesh)
    lay = fsdp.Layout(params, zoo.param_axes(cfg), build_rules(cfg), mesh)
    local = {k: tuple(v.to_local().shape) for k, v in _flat(p).items()}
    return {"params": dist.gather_tree(p), "local_shapes": local,
            "grads": dist.gather_tree(lay.placed(grads[0])),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "gathers": gathers, "reductions": reductions,
            "state_local": {
                k: tuple(v.to_local().shape) for k, v in _flat(s).items()}}



def serve_case(case: dict, mesh_shape, new_tokens: int):
    """Prefill and ``new_tokens - 1`` greedy decode steps of ``case`` on
    the params' shards (each layer gathered where it runs), the rank's
    slice of the prompts along ``data``: its rows and greedy tokens."""
    from repro_torch import dist
    from repro_torch.dist import fsdp
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import model_zoo as zoo

    cfg = case_config(case)
    with mesh_context(cfg, *mesh_shape, device="cpu") as mesh:
        rules = dist.current_rules()
        params = fsdp.Layout(case["params"], zoo.param_axes(cfg), rules,
                             mesh).local(case["params"])
        n = case["batch"]["tokens"].shape[0] // mesh.size(0)
        lo = mesh.get_local_rank("data") * n
        batch = {k: v[lo:lo + n] for k, v in case["batch"].items()}
        with torch.no_grad(), fsdp.sharded(mesh, rules, ("data",)), \
                GatherLog() as log, RoutingLog() as routing, \
                _phases(log):
            tokens, caches = greedy(params, cfg, batch, case["max_len"],
                                    new_tokens, with_caches=True)
        gathers = log.by_axis(mesh)
        reductions = log.reductions_by_axis(mesh)
    return {"rows": (lo, lo + n), "tokens": tokens, "gathers": gathers,
            "reductions": reductions,
            "routing": routing.ids,
            "cache_shapes": {k: tuple(v.shape)
                             for k, v in _flat(caches).items()},
            "local_shapes": {k: tuple(v.shape)
                             for k, v in _flat(params).items()}}


@contextlib.contextmanager
def _phases(log: GatherLog):
    """``log.phase`` "prefill" inside ``zoo.prefill``, "decode" after."""
    from repro_torch.models import model_zoo as zoo
    real = zoo.prefill

    def prefill(*a, **k):
        log.phase = "prefill"
        try:
            return real(*a, **k)
        finally:
            log.phase = "decode"
    zoo.prefill = prefill
    try:
        yield
    finally:
        zoo.prefill = real


def greedy(params, cfg, batch, max_len: int, new_tokens: int,
           with_caches: bool = False):
    """``zoo.prefill``, then greedy ``zoo.decode_step``s: (B, new_tokens)
    int32 tokens (and the caches after them)."""
    from repro_torch.models import model_zoo as zoo

    logits, caches = zoo.prefill(params, cfg, batch, max_len)
    out = []
    for i in range(new_tokens):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        if i + 1 < new_tokens:
            logits, caches = zoo.decode_step(params, cfg, caches, tok)
    tokens = torch.cat(out, dim=1)
    return (tokens, caches) if with_caches else tokens


# chip_smoke.py phase 17 at smoke size on the CPU
PHASE17_SIZES = {"TRAIN_B": 4, "TRAIN_S": 16, "PROMPT": 8, "MAX_LEN": 32,
                 "SHARD_DECODES": 2, "SERVE_BATCH": 4,
                 "DRYRUN_PEAK_TOL": float("inf")}


def phase17_stubs(set_attr=setattr) -> None:
    """``chip_smoke.py`` phases 17 and 18 on the CPU, in the test's
    process and in each process the phase starts: smoke configs with the
    full configs' recipes and remat "full", the card's calls stubbed (the
    peak read as 1 B, so its checks pass vacuously), flash's and WKV's
    plain versions counted as launches, PHASE17_SIZES."""
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    real = configs.get_config
    set_attr(configs, "get_config", lambda arch, smoke=False: real(
        arch, smoke=True).with_overrides(recipe=real(arch).recipe,
                                         remat="full"))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        set_attr(torch.cuda, name, lambda *a, **k: None)
    set_attr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1)
    set_attr(cs, "nvidia_smi_line", lambda: "no card")
    for k, v in PHASE17_SIZES.items():
        set_attr(cs, k, v)
    for mod, name in ((fa, "flash_attention"), (wkv, "rwkv6_wkv")):
        set_attr(ops, name, _counted(mod.LAUNCHES, name, getattr(ops, name)))


def _counted(launches: dict, name: str, fn):
    def call(*a, **k):
        launches[name] += 1
        return fn(*a, **k)
    return call


def run(rank: int, world: int, store: str, out: str, payload: str):
    # four ranks share the test's cores: one thread pool each, not four
    # pools the machine's width
    torch.set_num_threads(RANK_THREADS)
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
    from repro_torch.dist import fsdp
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
    lay = fsdp.Layout(tree, RESHARD_AXES, RESHARD_RULES, mesh)
    res["layout_local"] = lay.local(tree)
    res["layout_roundtrip"] = {
        k: bool(torch.equal(v.full_tensor(), tree[k]))
        for k, v in lay.placed(res["layout_local"]).items()}

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

    for name in TRAIN_CASES:
        res[name] = train_case(case[name], (2, 2))
    for name in SERVE_CASES:
        res["serve/" + name] = serve_case(case["serve/" + name], (2, 2),
                                          SERVE_TOKENS)
    return res
