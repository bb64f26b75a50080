"""The port's dry run (``launch/dryrun.py``, the traced-step analysis
``launch/hlo_analysis.py``, ``launch/roofline.py``'s ``Roofline``,
``launch/report.py``, ``launch/mesh.py::fake_world``) and the tuner's
scoring (``core/selftune.py``) against the JAX package's, on the CPU.

The fake worlds (256 and 512 ranks in one process) live in a process of
their own, spawned once for the file (``torch_dryrun_world.py``): a
process holds one process group, and the test files share their pytest
workers. What they return is held here to the reference:

* the production meshes' shapes and axis names, and the refusals;
* the exact bytes of a rank's arguments of three full-width cells,
  reckoned from the reference's rules (``build_rules``,
  ``logical_to_spec`` on a stand-in mesh of the same shape,
  ``param_shapes``, ``jax.eval_shape`` of AdamW's init);
* the collectives of a granite smoke step under ``ep_fsdp`` on a (2, 4)
  mesh (the reference test's cell), reckoned from
  ``param_sharding_tree``;
* ``run_cell``'s records, a rerun, a failing cell and ``main``'s exit
  code, and one real ``evaluate_candidate`` on a cut config.

In this process: ``model_flops``, ``param_counts``, ``Roofline`` and the
collective factors against the reference's; the traced step's product
flops against the reference's HLO count of its compiled single-device
step; the report's strings and the tuner's greedy loop against the
reference's on the same rows and the same scripted verdicts.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JInputShape
from repro.core import selftune as jst
from repro.dist.api import logical_to_spec as jlogical_to_spec
from repro.dist.sharding import build_rules as jbuild_rules
from repro.launch import hlo_analysis as jha
from repro.launch import report as jreport
from repro.launch import roofline as jrf
from repro.models import model_zoo as jzoo
from repro.train.optim import make_optimizer as jmake_optimizer
from repro.train.train_step import make_train_step as jmake_train_step

import torch_dryrun_world as worker
from repro_torch._tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config, shapes_for
from repro_torch.configs.base import InputShape
from repro_torch.core import selftune as tst
from repro_torch.dist.api import is_axes, logical_to_spec
from repro_torch.dist.sharding import build_rules
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as trf
from repro_torch.models import model_zoo as tzoo
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLD_TIMEOUT_S = 300
SMOKE_B, SMOKE_S = 8, 32

# (arch, rtol) of the traced step's product flops against the reference's
# HLO dot flops. rwkv6: 15 products of 262,144 flops more in the
# reference (1.2%), all in WKV's chunk loop: the reference runs it as a
# lax.scan whose body is the same for every chunk, so its gradient also
# computes the products of the first chunk's zero initial state and of
# the last chunk's final state, which the loss does not read; the port's
# loop is unrolled and autograd builds neither.
DOT_FLOPS_CASES = (("qwen2-1.5b", 1e-9), ("granite-moe-1b-a400m", 1e-9),
                   ("rwkv6-1.6b", 0.015))


class _StandIn:
    """A mesh the reference and the port only read the shape of."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)

    @property
    def axis_names(self):
        return self.mesh_dim_names


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_world")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    proc = subprocess.run([sys.executable, str(HERE / "torch_dryrun_world.py"),
                           str(out)], env=env, capture_output=True, text=True,
                          timeout=WORLD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads((out / "world.json").read_text())
    rec["out_dir"] = str(out)
    return rec


def _reference_mesh(monkeypatch, multi_pod: bool):
    """``(shape, axes, n devices)`` the reference's make_production_mesh
    asks of ``jax.make_mesh`` given 512 devices."""
    from repro.launch import mesh as jmesh
    monkeypatch.setattr(jax, "devices", lambda *a: list(range(512)))
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes, devices=None:
                        (list(shape), list(axes), len(devices)))
    return jmesh.make_production_mesh(multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# meshes over fake worlds
# ---------------------------------------------------------------------------

def test_production_meshes_over_fake_worlds(world, monkeypatch):
    for key, multi_pod, n in (("single_256", False, 256),
                              ("single_512", False, 256),
                              ("multi_512", True, 512)):
        shape, axes, used = _reference_mesh(monkeypatch, multi_pod)
        assert world[key] == {"shape": shape, "names": axes,
                              "device": "cpu"}, key
        assert used == math.prod(shape) == n
    assert world["world_256"] == 256 and world["world_512"] == 512


def test_fake_world_refusals(world):
    """A real group refuses a fake world; a fake world of 256 neither
    carves the multi-pod mesh nor grows; asking for fewer ranks than it
    has returns the world as it is."""
    assert "a real process group (gloo, 1 ranks) is up" in \
        world["refused_under_real"]
    assert "need 512 devices for mesh (2, 16, 16), have 256" in \
        world["multi_on_256"]
    assert "fake_world(512)" in world["multi_on_256"]
    assert world["grow_256"] == "a fake world of 256 ranks is up; 512 are needed"
    assert world["again_256"] == 256


# ---------------------------------------------------------------------------
# arguments a rank, against the reference's rules
# ---------------------------------------------------------------------------

def _local_bytes(sds, axes, table, mesh) -> int:
    spec = jlogical_to_spec(axes, table, mesh, sds.shape)
    split = 1
    for part in spec:
        for ax in ((part,) if isinstance(part, str) else (part or ())):
            split *= mesh.shape[ax]
    n = math.prod(sds.shape)
    assert n % split == 0
    return n // split * jnp.dtype(sds.dtype).itemsize


@pytest.mark.parametrize("arch,recipe", worker.ARG_CELLS)
def test_argument_bytes_match_the_reference_rules(world, arch, recipe):
    """Params, AdamW state (fp32 moments and master), the step and the
    batch's shard, each leaf's local size by the reference's spec on a
    (16, 16) mesh (12 heads of qwen2 do not divide 16: ``tp_fsdp`` falls
    back to replicated heads)."""
    cfg = jget(arch).with_overrides(recipe=recipe)
    shape = JInputShape("train_4k", 4096, 256, "train")
    rules = jbuild_rules(cfg, shape=shape)
    mesh = _StandIn({"data": 16, "model": 16})
    shapes, axes = jzoo.param_shapes(cfg), jzoo.param_axes(cfg)
    opt = jmake_optimizer(cfg, "adamw")
    state = jax.eval_shape(opt.init, shapes)
    is_leaf = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    want = 0
    for tree, ax_tree in ((shapes, axes), (state, opt.state_axes(axes))):
        leaves = jax.tree.leaves(tree)
        ax_leaves = jax.tree.leaves(ax_tree, is_leaf=is_leaf)
        assert len(leaves) == len(ax_leaves)
        want += sum(_local_bytes(s, a, rules["param"], mesh)
                    for s, a in zip(leaves, ax_leaves))
    want += 4                                            # the int32 step
    want += _local_bytes(jax.ShapeDtypeStruct((256, 4096), jnp.int32),
                         ("batch", None), rules["act"], mesh)
    assert world["arguments"][f"{arch}/{recipe}"] == want


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_param_counts_match(arch):
    tcfg, jcfg = get_config(arch), jget(arch)
    assert tcfg.param_counts() == jcfg.param_counts()
    for s in shapes_for(tcfg):
        js = JInputShape(s.name, s.seq_len, s.global_batch, s.kind)
        assert trf.model_flops(tcfg, s) == jrf.model_flops(jcfg, js)


ROOFLINE_CASES = (
    (9.13e14, 2.34e13, 3.4e10, 256, 9.7e15),
    (1.0e12, 1.0e9, 0.0, 1, 0.0),
    (0.0, 0.0, 0.0, 512, 1.0e15),
    (5.0e13, 2.0e14, 8.0e12, 512, 3.0e16),
    (1.0e10, 1.0e6, 1.0e12, 8, 7.5e10),
)


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_roofline_matches_the_reference(case):
    assert trf.Roofline(*case).to_dict() == jrf.Roofline(*case).to_dict()
    assert (trf.PEAK_FLOPS, trf.HBM_BW, trf.LINK_BW) == \
        (jrf.PEAK_FLOPS, jrf.HBM_BW, jrf.LINK_BW)


def test_collective_bytes_uses_the_reference_factors():
    assert trf._COLLECTIVE_FACTORS == jrf._COLLECTIVE_FACTORS == \
        jha._COLLECTIVE_FACTORS
    out = {kind: float(i + 1) for i, kind in enumerate(jha._COLLECTIVE_FACTORS)}
    got = trf.collective_bytes({"collective_out_bytes": out})
    want = {k: v * jha._COLLECTIVE_FACTORS[k] for k, v in out.items()}
    assert got == dict(want, total=sum(want.values()))
    assert trf.collective_bytes({}) == {"total": 0}


def _fake_train_args(cfg):
    mode = ha.fake_tensor_mode()
    with mode, ha.HostScalars():
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                          tzoo.param_shapes(cfg))
        opt = make_optimizer(cfg, "adamw")
        args = (params, opt.init(params), torch.zeros((), dtype=torch.int32),
                {"tokens": torch.empty((SMOKE_B, SMOKE_S), dtype=torch.int32)})
    return make_train_step(cfg, opt), args


@pytest.mark.parametrize("arch,rtol", DOT_FLOPS_CASES)
def test_dot_flops_match_the_reference_hlo_count(arch, rtol):
    """The smoke config's AdamW step at 8 x 32 with no mesh: the traced
    step's product flops against the reference's scan-aware HLO count
    of its compiled step (a single-device compile, which works here)."""
    jcfg = jget(arch, smoke=True)
    opt = jmake_optimizer(jcfg, "adamw")
    params = jax.eval_shape(lambda: jzoo.init_params(jcfg, 0))
    hlo = jax.jit(jmake_train_step(jcfg, opt)).lower(
        params, jax.eval_shape(opt.init, params),
        jax.ShapeDtypeStruct((), jnp.int32),
        {"tokens": jax.ShapeDtypeStruct((SMOKE_B, SMOKE_S), jnp.int32)},
    ).compile().as_text()
    want = jha.analyze(hlo)["flops"]
    got = ha.analyze(*_fake_train_args(get_config(arch, smoke=True)))
    assert got["dot_flops"] == pytest.approx(want, rel=rtol)
    assert got["flops"] > got["dot_flops"] > 0
    assert got["collectives"] == {} and got["collective_bytes_total"] == 0
    assert got["peak_bytes"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_traces_prefill_and_decode(arch):
    """The serving cells on one device (a stand-in (1, 1) mesh), at the
    smoke config: a cache's length stays a host scalar (``HostScalars``),
    so the attention reads it; the record's memory and counts are
    filled, and nothing moves between ranks."""
    cfg = get_config(arch, smoke=True)
    mesh = _StandIn({"data": 1, "model": 1})
    for kind in ("prefill", "decode"):
        shape = InputShape(f"smoke_{kind}", 64, 4, kind)
        rec = dryrun.trace_cell(cfg, shape, mesh,
                                build_rules(cfg, shape=shape), device="cpu")
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0, kind
        assert mem["total_per_device"] > mem["argument_size_in_bytes"], kind
        assert rec["cost"]["flops"] > rec["cost"]["dot_flops"] > 0, kind
        assert rec["collectives"] == {"total": 0}, kind
        assert rec["step_layout"] == "one device"
        assert rec["roofline"]["chips"] == 1


# ---------------------------------------------------------------------------
# collectives on a fake (2, 4) world
# ---------------------------------------------------------------------------

def test_collectives_exact_on_a_2x4_world(world):
    """granite's smoke config under ``ep_fsdp`` with ``remat="full"`` on
    (data 2, model 4), 8 x 32 tokens, AdamW: the step on shards, its
    experts computed where they are stored. Each sharded param leaf is
    all-gathered where it is used over the mesh dims its use spec keeps
    (``fsdp.use_spec``: ``experts``, which the act rules map to ``model``
    too, stays the rank's slice), the last mesh dim first: a stacked leaf
    layer by layer, in the forward and again in the backward's
    recompute, the leaves outside the stack once. The backward
    reduce-scatters each layer's fp32 gradient over ``data`` where the
    leaf is sharded over it (the rank's slice of the experts only). One
    all-reduce over ``data`` averages the gradients of the leaves not
    sharded over it, the loss and the loss's metrics (2x), and the global
    norm sums each leaf's squares over its sharded axes: one all-reduce a
    distinct set of axes and axis. Each MoE layer adds its expert
    parallelism's collectives over ``model`` (``dist/tp.py``): the
    router's logits of the rank's experts all-gathered (fp32, t x E) in
    the forward and the recompute, the experts' partial sums all-reduced
    (fp32, t x D) in the forward only (the recompute stops once it holds
    what the backward needs, torch's early stop, before the layer's
    end), and in the backward the tokens' gradient (t x D) and the
    gates' (t x K) all-reduced. No optimizer moment and no batch is
    gathered."""
    from repro_torch.dist import fsdp
    cfg = get_config("granite-moe-1b-a400m", smoke=True).with_overrides(
        **worker.COLLECTIVES_CUT)
    rules = build_rules(cfg, shape=InputShape("tiny_train", 32, 8, "train"))
    mesh = _StandIn({"data": 2, "model": 4})
    shapes, axes = tzoo.param_shapes(cfg), tzoo.param_axes(cfg)
    gathered = scattered = 0.0
    gathers = scatters = 0
    flat = 0                                  # elements of the data mean
    norm_groups = {}                          # sharded axes -> leaves

    def axes_of(spec):
        return sorted((a for p in spec if p
                       for a in ((p,) if isinstance(p, str) else p)
                       if mesh.shape[a] > 1), key=mesh.mesh_dim_names.index)
    for (path, x), ax in zip(tree_flatten_with_path(shapes)[0],
                             tree_flatten(axes, is_leaf=is_axes)[0]):
        spec = logical_to_spec(ax, rules["param"], mesh, x.shape)
        used = axes_of(spec)
        kept = axes_of(fsdp.use_spec(ax, spec, rules["act"]))
        norm_groups[tuple(used)] = norm_groups.get(tuple(used), 0) + 1
        if "data" not in used:
            flat += x.numel()
        stacked = "['stack']" in path
        layers = x.shape[0] if stacked else 1
        passes = 2 if stacked else 1          # the forward and the recompute
        size = x.numel() * x.element_size() / math.prod(
            mesh.shape[a] for a in used)
        for a in reversed(kept):
            size *= mesh.shape[a]
            gathered += passes * size
            gathers += passes * layers
        if "data" in used:
            scattered += x.numel() * 4 / math.prod(mesh.shape[a]
                                                    for a in used)
            scatters += layers
    mode = ha.fake_tensor_mode()
    with mode:
        p = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), shapes)
        _, metrics = tzoo.lm_loss(
            p, cfg, {"tokens": torch.empty((SMOKE_B, SMOKE_S),
                                           dtype=torch.int32)})
    reduced = 4.0 * (flat + 1 + len(metrics))
    norm_ops = 0
    for used, n in norm_groups.items():
        reduced += 4.0 * n * len(used)
        norm_ops += len(used)
    # expert parallelism, a MoE layer: t tokens of the rank's batch rows
    moe_layers = cfg.n_layers
    t = SMOKE_B // mesh.shape["data"] * SMOKE_S
    E, K, D = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    gathered += moe_layers * 2 * 4.0 * t * E
    gathers += moe_layers * 2
    reduced += moe_layers * (4.0 * t * D + 4.0 * t * D + 4.0 * t * K)
    tp_reduces = moe_layers * 3
    got = world["collectives"]
    assert got["collectives"] == {
        "all-gather": gathered, "reduce-scatter": scattered,
        "all-reduce": 2.0 * reduced,
        "total": gathered + scattered + 2.0 * reduced}
    assert got["collective_ops"] == {
        "c10d._allgather_base_": gathers,
        "c10d._reduce_scatter_base_": scatters,
        "c10d.allreduce_": 1 + norm_ops + tp_reduces}
    assert got["step_layout"] == "sharded_tp"
    assert got["roofline"]["link_bytes_per_dev"] == got["collectives"]["total"]


def test_a_model_rank_computes_half_the_layers_and_holds_half_the_cache(
        world):
    """seamless-m4t-medium's smoke config under ``tp_fsdp`` traced on a
    fake world's (1, 1) and (1, 2) meshes at 2 and 4 layers each side: on
    the ``model`` axis of 2 the layers' matrix-product operations a rank
    (a train step's, the difference between the two depths) are half the
    one-rank step's, the whole step's about half (the frontend's stub
    projection is replicated), its KV cache bytes (self- and
    cross-attention K and V of a decode cell) half; the (1, 2) record's
    layout is ``"sharded_tp"``, its links the activations' all-reduces
    over ``model`` and no all-gather (the data axis of 1 gathers nothing,
    and no weight split over ``model`` is gathered over it)."""
    tp = world["tp"]
    lo, hi = worker.TP_DEPTHS
    one = tp[f"1/{hi}"]["dot_flops"] - tp[f"1/{lo}"]["dot_flops"]
    two = tp[f"2/{hi}"]["dot_flops"] - tp[f"2/{lo}"]["dot_flops"]
    assert two / one == pytest.approx(0.5, rel=1e-6)
    for depth in worker.TP_DEPTHS:
        a, b = tp[f"1/{depth}"], tp[f"2/{depth}"]
        assert 0.5 <= b["dot_flops"] / a["dot_flops"] < 0.55
        assert 2 * b["kv_bytes"] == a["kv_bytes"] > 0
        assert a["step_layout"] == "one device"
        assert b["step_layout"] == "sharded_tp"
        assert a["collectives"] == {"total": 0.0}
        assert b["collectives"]["all-reduce"] > 0
        assert set(b["collectives"]) == {"all-reduce", "total"}


def test_a_rank_on_shards_holds_less_than_the_whole_model(world):
    """qwen2-1.5b's full width cut to 2 layers (``remat="full"``), 4 x 64
    tokens on (data 2, model 4) under ``fsdp``: the traced temp bytes (the
    peak less the rank's arguments) are below the bytes of the full
    params and AdamW state (fp32 moments and master), which a gathered
    layout would hold on top of its arguments."""
    cfg = get_config("qwen2-1.5b").with_overrides(**worker.MEMORY_CUT)
    shapes = tzoo.param_shapes(cfg)
    with torch.device("meta"):
        state = make_optimizer(cfg, "adamw").init(shapes)
    full = sum(t.numel() * t.element_size()
               for t in tree_flatten((shapes, state))[0])
    mem = world["memory"]["memory"]
    assert world["memory"]["step_layout"] == "sharded"
    assert 0 < mem["temp_size_in_bytes"] < full


# ---------------------------------------------------------------------------
# records, report, tuner
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "recipe", "impl", "tag", "overrides",
               "device", "note", "ok", "trace_s", "memory", "cost",
               "collectives", "collective_ops", "roofline", "step_layout",
               "params_total", "params_active", "total_s"}


def test_run_cell_records(world):
    cut = jget("qwen2-1.5b").with_overrides(**worker.CUT)
    for shape_name, rec in world["cells"].items():
        assert rec["ok"], rec.get("traceback")
        assert set(rec) == RECORD_KEYS
        assert rec["mesh"] == "pod_16x16" and rec["overrides"] == worker.CUT
        mem = rec["memory"]
        assert mem["total_per_device"] == (mem["argument_size_in_bytes"]
                                           + mem["temp_size_in_bytes"])
        assert mem["temp_size_in_bytes"] > 0
        assert set(rec["roofline"]) == set(jrf.Roofline(1, 1, 1, 1).to_dict())
        s = SHAPES_BY_NAME[shape_name]
        assert rec["roofline"]["model_flops_global"] == jrf.model_flops(
            cut, JInputShape(s.name, s.seq_len, s.global_batch, s.kind))
        assert rec["roofline"]["flops_per_dev"] == rec["cost"]["dot_flops"]
        assert rec["roofline"]["chips"] == 256
        assert rec["step_layout"] == "sharded"
        assert rec["params_total"] == cut.param_counts()["total"]
        # each layer's weights gathered where it runs, on every cell
        assert rec["collectives"]["all-gather"] > 0
    train = world["cells"]["train_4k"]["collectives"]
    assert train["all-reduce"] > 0 and train["reduce-scatter"] > 0
    for shape in worker.SERVE_CELLS:
        assert set(world["cells"][shape]["collectives"]) == {"all-gather",
                                                              "total"}


def test_run_cell_rereads_a_green_cell(world):
    assert world["reread"] == world["cells"]["train_4k"]
    assert world["reread_untouched"]


def test_a_failing_cell_is_recorded_and_main_exits_1(world):
    rec = world["failed"]
    assert not rec["ok"] and rec["recipe"] == "bogus"
    assert rec["error"].startswith("ValueError: unknown recipe 'bogus'")
    assert "Traceback" in rec["traceback"]
    assert world["main_rc"] == 1


def test_report_matches_the_reference(world, monkeypatch):
    monkeypatch.setattr(treport, "DRYRUN",
                        pathlib.Path(world["out_dir"]) / "dryrun_torch")
    rows = treport.table("pod_16x16")
    assert sorted(r["shape"] for r in rows) == sorted(world["cells"])
    assert treport.render_markdown(rows) == jreport.render_markdown(rows)
    assert treport.pick3(rows) == jreport.pick3(rows)
    assert [treport._row(c) for c in treport.load_cells("pod_16x16")] == rows
    for r in rows:
        assert treport._row(world["cells"][r["shape"]]) == r
        ref = jreport._row(world["cells"][r["shape"]])
        assert {k: r[k] for k in ref} == ref
    traced = treport.render_traced(rows)
    assert len(traced.splitlines()) == 2 + len(rows)
    assert "failed:" in treport.render_traced([treport._row(world["failed"])])


# each scripted verdict: (note, ok, mem_gib, bound_s)
TUNE_SCRIPTS = (
    (("a", True, 20.0, 9.0), ("b", True, 12.0, 8.0), ("c", True, 12.0, 7.9),
     ("d", True, 11.0, 7.8), ("e", True, 10.0, 7.7), ("f", True, 1.0, 1.0)),
    (("a", False, 0.0, 0.0), ("b", True, 30.0, 5.0), ("c", True, 25.0, 6.0),
     ("d", False, 0.0, 0.0), ("e", True, 14.0, 4.0), ("f", True, 15.0, 3.0)),
    (("a", True, 8.0, 10.0), ("b", True, 8.0, 5.0), ("c", True, 8.0, 4.9),
     ("d", True, 17.0, 1.0), ("e", True, 8.0, 2.0), ("f", True, 8.0, 1.9),
     ("g", True, 8.0, 1.89), ("h", True, 8.0, 1.0)),
)


def _scripted(module, script):
    by_note = {n: (ok, mem, bound) for n, ok, mem, bound in script}

    def evaluate(arch, shape_name, cand, **kw):
        ok, mem, bound = by_note[cand.note]
        if not ok:
            return module.TuneResult(cand, False, error=f"scripted {cand.note}")
        return module.TuneResult(cand, True, mem_gib=mem, bound_s=bound,
                                 dominant="compute",
                                 roofline_fraction=1.0 / bound,
                                 useful_ratio=0.5)
    return evaluate


@pytest.mark.parametrize("script", TUNE_SCRIPTS)
def test_tune_greedy_loop_matches_the_reference(script, monkeypatch,
                                                tmp_path):
    """Both tuners over the same scripted verdicts: the same best, the
    same candidates evaluated before the early stop, the same log."""
    out = {}
    for name, module in (("ref", jst), ("port", tst)):
        monkeypatch.setattr(module, "evaluate_candidate",
                            _scripted(module, script))
        cands = [module.Candidate({}, note=n) for n, *_ in script]
        log = tmp_path / f"{name}.jsonl"
        best, results = module.tune("qwen2-1.5b", "train_4k", cands,
                                    log_path=str(log))
        out[name] = (best.candidate.note, [r.candidate.note for r in results],
                     log.read_text())
    assert out["port"] == out["ref"]


def test_evaluate_candidate_on_a_cut_config(world):
    """A real ``evaluate_candidate`` (qwen2-1.5b at 2 layers, train_4k,
    over the fake world's 256-rank mesh): the verdict is the reference's
    reading of the record."""
    c = world["candidate"]
    rec, rf = c["record"], c["record"]["roofline"]
    assert c["ok"] and rec["ok"] and rec["tag"] == "tune"
    assert rec["overrides"] == worker.CUT
    assert c["mem_gib"] == rec["memory"]["total_per_device"] / 2 ** 30
    assert c["bound_s"] == max(rf["t_compute_s"], rf["t_memory_s"],
                               rf["t_collective_s"])
    assert (c["dominant"], c["roofline_fraction"], c["useful_ratio"]) == (
        rf["dominant"], rf["roofline_fraction"], rf["useful_flops_ratio"])
    assert rec["cost"] == world["cells"]["train_4k"]["cost"]


# ---------------------------------------------------------------------------
# refusals in this process
# ---------------------------------------------------------------------------

def test_the_dry_run_refuses_the_kernel_route():
    cfg = get_config("qwen2-1.5b", smoke=True)
    with pytest.raises(ValueError, match="chunked paths"):
        dryrun.build_cell(cfg, SHAPES_BY_NAME["train_4k"], None, None,
                          impl="kernel", device="cpu")


def test_the_analysis_takes_fake_tensors_only():
    with pytest.raises(ValueError, match="fake tensors"):
        ha.analyze(lambda x: x @ x, (torch.ones(4, 4),))


def test_the_cli_without_a_card_raises():
    """``--device cuda`` (the default) on a machine with no card raises
    before any cell, rather than trace on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                     "--mesh", "single", "--force"])


# ---------------------------------------------------------------------------
# what the dry run needed of the models
# ---------------------------------------------------------------------------

def test_constrain_caches_under_a_mesh_keeps_the_tree():
    """Under an active mesh each cache leaf meets its logical axes (the
    tree of axes is walked with ``is_axes``, so a tuple of names is one
    leaf); on plain tensors every constraint is the identity."""
    from repro_torch.dist import use_mesh
    cfg = get_config("qwen2-1.5b", smoke=True)
    caches = tzoo.init_caches(cfg, 2, 16, device="cpu")
    with use_mesh(_StandIn({"data": 2, "model": 1}), build_rules(cfg)):
        out = tzoo.constrain_caches(caches)
    a, b = tree_flatten(out)[0], tree_flatten(caches)[0]
    assert len(a) == len(b) and all(x is y for x, y in zip(a, b))


def test_the_stacked_write_back_compares_memory_not_pointers():
    """A fake tensor has no data pointer: the stacked caches' write-back
    tells a layer's own view from another tensor by storage and offset."""
    from repro_torch.models.transformer import _same_memory
    for mode in (None, ha.fake_tensor_mode()):
        with mode or torch.device("cpu"):
            buf, other = torch.empty(3, 4), torch.empty(4)
            assert _same_memory(buf[1], buf[1])
            assert not _same_memory(buf[0], other)
            assert not _same_memory(buf[1], buf[2])
            assert not _same_memory(buf[1].view(torch.int32), buf[1])


@pytest.mark.parametrize("seq_shard,shape,want", [
    (True, "prefill_32k", "sharded_tp_seq"),
    (True, "train_4k", "sharded_tp_seq"),
    (False, "prefill_32k", "sharded_tp"),
    (True, "decode_32k", "sharded_tp"),     # the rules drop seq_sp
])
def test_step_layout_names_the_seq_form(seq_shard, shape, want):
    """seamless-m4t-medium's full config on pod_16x16: a record of the
    ``seq_sp`` form (``seq_shard=True`` under ``tp_fsdp``, not at decode)
    says ``"sharded_tp_seq"``, so a saved ``"sharded_tp"`` record of the
    all-reduce form is not returned for it (``run_cell`` traces a cell
    whose layout differs again); a sequence that does not divide by the
    ``model`` axis keeps ``"sharded_tp"``."""
    step_layout = dryrun.step_layout
    cfg = get_config("seamless-m4t-medium").with_overrides(
        seq_shard=seq_shard)
    sh = SHAPES_BY_NAME[shape]
    rules = build_rules(cfg, shape=sh)
    sizes = {"data": 16, "model": 16}
    assert step_layout(sizes, rules, sh.seq_len) == want
    assert step_layout(sizes, rules, 16 * 7 + 1) == "sharded_tp"
    assert step_layout({"data": 1, "model": 1}, rules, sh.seq_len) == \
        "one device"
