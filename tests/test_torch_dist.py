"""The port's distributed substrate (``repro_torch.dist``, ``launch.mesh``
and the models' mesh-dependent pieces) against the JAX package's, on the
CPU: ``tests/test_dist.py`` and the sharding property of
``tests/test_property.py`` mirrored, then the two packages on the same
inputs.

Specs, rules, logical axes, ``axis_size``, ``kv_repeat_factor`` and the
MoE grouping must equal the reference's exactly. A mesh the reference
only reads the shape of is a stand-in here (``_FakeMesh``); the meshes
the port places tensors on are a 4-rank gloo world, spawned once for the
file (``torch_dist_ranks.py``): ``reshard_tree``'s shards against
``NamedSharding.devices_indices_map`` on the reference's (2, 2) mesh,
``rebuild_mesh`` after failures against the reference's shapes and
devices, ``compressed_allreduce_mean``'s group route against its host
route (1e-6) and the mean (the reference's ``atol`` 2e-2), and the steps on the rank's shards
(``dist/fsdp.py``, ``remat="full"``) on a (2, 2) mesh: one step of
qwen2-1.5b's smoke config under ``tp_fsdp`` (SGD; SGD with the int8 wire
format and 2 microbatches) and ``fsdp`` (AdamW, Adafactor) against the
single-process step and, for ``tp_fsdp`` SGD and ``fsdp`` AdamW, the
reference's unsharded step (``rtol`` 2e-3, ``atol`` 2e-4: the reference's
bounds for its sharded step), each rank's local shapes, its optimizer
moments' too, as the rules say; the same for granite-moe-1b-a400m's smoke
config under ``ep_fsdp``, against the single-process step with two token
groups (the reference's grouping on that mesh); seamless-m4t-medium's
prefill and 4 greedy decode steps under ``tp_fsdp``, the tokens the single
process's.
"""

import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from repro import dist as jdist
from repro.configs import get_config as jget
from repro.configs.base import InputShape as JInputShape
from repro.dist import api as japi
from repro.dist import compression as jcomp
from repro.dist import elastic as jel
from repro.dist import sharding as jsharding
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.train import optim as joptim
from repro.train.train_step import make_train_step as jmake_train_step

import torch_dist_ranks as ranks
from repro_torch import convert, dist
from repro_torch._tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.configs import ARCH_IDS, get_config as tget
from repro_torch.configs.base import DECODE_32K, PREFILL_32K, InputShape
from repro_torch.dist import api
from repro_torch.dist import compression as tcomp
from repro_torch.dist import elastic as tel
from repro_torch.dist import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.train.optim import constant_schedule, sgd
from repro_torch.train.train_step import make_train_step

RECIPES = ("dp", "fsdp", "tp_fsdp", "ep_fsdp", "ep_tp_fsdp")
STEP_TOL = dict(rtol=2e-3, atol=2e-4)     # the reference's sharded-step bounds
MEAN_ATOL = 2e-2                          # the reference's compressed mean
ROUTE_TOL = 1e-6                          # group route against host route
SPAWN_TIMEOUT_S = 300


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


class _FakeDeviceMesh:
    """What ``spec_to_placements`` reads of a ``DeviceMesh``."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)


def _is_axes(x):
    return isinstance(x, tuple) and not hasattr(type(x), "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _jaxes(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=_is_axes)


def _taxes(tree):
    return tree_flatten(tree, is_leaf=api.is_axes)[0]


# ---------------------------------------------------------------------------
# logical_to_spec
# ---------------------------------------------------------------------------

def test_shard_is_noop_outside_mesh():
    x = torch.ones((4, 8))
    assert not dist.mesh_active()
    assert dist.shard(x, "batch", "embed") is x
    assert dist.shard_param(x, ("embed", "ff")) is x
    assert dist.pin_params({"w": x}, {"w": ("embed", "ff")})["w"] is x


@pytest.mark.parametrize("mesh,rules,axes,shape", [
    ({"data": 2, "model": 4}, {"batch": ("data", "model")}, ("batch",), (8,)),
    ({"data": 2, "model": 4}, {"batch": ("data", "model")}, ("batch",), (6,)),
    ({"data": 2, "model": 4}, {"batch": ("data", "model")}, ("batch",), (5,)),
    ({"model": 4}, {"heads": ("model",), "ff": ("model",)}, ("heads", "ff"),
     (8, 8)),
    ({"data": 2}, {"batch": ("pod", "data")}, ("layers", "batch"), (3, 4)),
    ({"pod": 2, "data": 4, "model": 2}, {"batch": ("pod", "data"),
     "ff": "model"}, ("batch", None, "ff"), (16, 3, 6)),
    ({"data": 2, "model": 4}, {"embed": "data", "ff": "model"},
     ("embed", "ff"), None),
])
def test_logical_to_spec_matches_the_reference(mesh, rules, axes, shape):
    """The reference's ``_FakeMesh`` cases (divisibility, no reused mesh
    axis, absent mesh axes skipped) and a multipod one: the same spec,
    dim for dim."""
    want = japi.logical_to_spec(axes, rules, _FakeMesh(mesh), shape)
    got = api.logical_to_spec(axes, rules, _FakeMesh(mesh), shape)
    assert tuple(got) == tuple(want)
    assert api.spec_is_replicated(got) == japi.spec_is_replicated(want)


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.integers(1, 4096), min_size=1, max_size=3),
       sizes=st.tuples(st.sampled_from([1, 2, 4, 8, 16]),
                       st.sampled_from([1, 2, 4, 8, 16]),
                       st.sampled_from([1, 2])),
       recipe=st.sampled_from(RECIPES))
def test_logical_to_spec_always_divides_and_matches(dims, sizes, recipe):
    """Whatever the dims, mesh sizes and recipe: the chosen axes always
    divide their dim, and the spec is the reference's."""
    mesh = _FakeMesh({"pod": sizes[2], "data": sizes[0], "model": sizes[1]})
    rules = sharding.build_rules(recipe=recipe)["act"]
    names = ("batch", "heads", "ff")[:len(dims)]
    got = api.logical_to_spec(names, rules, mesh, dims)
    assert tuple(got) == tuple(japi.logical_to_spec(names, rules, mesh, dims))
    for dim, part in zip(dims, got):
        prod = 1
        for a in ((part,) if isinstance(part, str) else (part or ())):
            prod *= mesh.shape[a]
        assert dim % prod == 0


def test_spec_to_placements_follows_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m = _FakeDeviceMesh(("pod", "data", "model"), (2, 2, 2))
    spec = api.PartitionSpec(("pod", "data"), None, "model")
    assert api.spec_to_placements(spec, m) == [Shard(0), Shard(0), Shard(2)]
    assert api.spec_to_placements(api.PartitionSpec(None, None), m) == [
        Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        api.spec_to_placements(api.PartitionSpec(("data", "pod")), m)


def test_tree_walks_leave_no_reference_cycle():
    """A flatten, an unflatten and a two-tree map with axes leaves: the
    tensors die with the last name for them, with the collector off (a
    walk that was a closure calling itself held them in a cycle)."""
    import gc
    import weakref
    from repro_torch._tree import tree_unflatten

    tree = {"a": [torch.ones(3), (torch.zeros(2),)], "b": None,
            "c": tattn.KVCache(torch.ones(1), torch.ones(1), torch.ones(()))}
    axes = {"a": [("x",), ((None,),)], "b": None,
            "c": tattn.KVCache(("k",), ("v",), ())}
    refs = [weakref.ref(t) for t in tree_flatten(tree)[0]]
    gc.collect()
    gc.disable()
    try:
        leaves, treedef = tree_flatten(tree)
        again = tree_unflatten(treedef, leaves)
        pairs = tree_map(lambda t, ax: (t, ax), again, axes,
                         is_leaf=api.is_axes)
        assert pairs["c"].length[1] == () and pairs["a"][0][1] == ("x",)
        del tree, leaves, again, pairs
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# build_rules, param_sharding_tree, axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", RECIPES)
def test_build_rules_match_the_reference(recipe):
    """Every recipe x the ten configurations x a prefill and a decode
    shape, and with no config at all."""
    for arch in ARCH_IDS:
        for smoke in (False, True):
            tc, jc = tget(arch, smoke=smoke), jget(arch, smoke=smoke)
            for shp in (PREFILL_32K, DECODE_32K, None):
                jshp = None if shp is None else JInputShape(
                    shp.name, shp.seq_len, shp.global_batch, shp.kind)
                assert sharding.build_rules(tc, shape=shp, recipe=recipe) \
                    == jsharding.build_rules(jc, shape=jshp, recipe=recipe)
    assert sharding.build_rules(recipe=recipe) == \
        jsharding.build_rules(recipe=recipe)
    with pytest.raises(ValueError, match="unknown recipe"):
        sharding.build_rules(recipe="zero3")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_and_input_specs_match_the_reference(arch):
    """``param_axes`` of the full config and ``cache_axes`` of the smoke
    config's caches, leaf for leaf; ``input_specs`` of a train, a prefill
    and a decode cell, shape and dtype for shape and dtype;
    ``param_sharding_tree``'s placements those of the reference's
    ``NamedSharding`` specs on a (2, 4) mesh."""
    tc, jc = tget(arch), jget(arch)
    assert _taxes(tzoo.param_axes(tc)) == _jaxes(jzoo.param_axes(jc))

    sc, sj = tget(arch, smoke=True), jget(arch, smoke=True)
    src = sc.frontend_len if sc.family in ("encdec", "vlm") else 0
    got = _taxes(tzoo.cache_axes(tzoo.init_caches(sc, 2, 16, src,
                                                  device="cpu")))
    want = _jaxes(jzoo.cache_axes(jzoo.init_caches(sj, 2, 16, src)))
    assert got == want

    for kind in ("train", "prefill", "decode"):
        ts = InputShape("cell", 64, 4, kind)
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
               for t in tree_flatten(tzoo.input_specs(sc, ts))[0]]
        want = [(tuple(s.shape), str(s.dtype))
                for s in jax.tree.leaves(jzoo.input_specs(
                    sj, JInputShape("cell", 64, 4, kind)))]
        assert got == want

    rules = sharding.build_rules(tc, recipe="ep_tp_fsdp")
    fake = _FakeDeviceMesh(("data", "model"), (2, 4))
    got = [pl for _, pl in tree_flatten(
        sharding.param_sharding_tree(tc, fake, rules),
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and x[0] is fake)[0]]
    jm = jax.make_mesh((2, 4), ("data", "model"),
                       devices=jax.devices()[:8])
    want = [api.spec_to_placements(tuple(ns.spec), fake) for ns in
            jax.tree.leaves(jsharding.param_sharding_tree(jc, jm, rules))]
    assert got == want


# ---------------------------------------------------------------------------
# axis_size, use_mesh, mesh_context
# ---------------------------------------------------------------------------

def test_axis_size_defaults_to_one():
    assert dist.axis_size("heads") == 1
    rules = {"param": {}, "act": {"heads": ("model",)}}
    for mod in (dist, jdist):
        with mod.use_mesh(_FakeMesh({"data": 2, "model": 2}), rules):
            assert mod.axis_size("heads") == 2      # mapped logical axis
            assert mod.axis_size("data") == 2       # physical axis by name
            assert mod.axis_size("no_such_axis") == 1
    assert not dist.mesh_active()


def test_use_mesh_degrades_to_single_device():
    with dist.use_mesh(device="cpu") as mesh:
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data", "model")
        assert dist.mesh_active()
        assert dist.current_rules() == {"param": {}, "act": {}}
        x = torch.ones((4, 4))
        assert dist.shard(x, "batch", None) is x
    assert not dist.mesh_active() and dist.current_mesh() is None
    with pytest.raises(ValueError, match=r"needs 8 devices, have 1"):
        with dist.use_mesh({"data": 2, "model": 4}, device="cpu"):
            pass


def test_mesh_context_activates_recipe_rules():
    cfg = tget("qwen2-1.5b", smoke=True).with_overrides(recipe="tp_fsdp")
    with tmesh.mesh_context(cfg, device="cpu") as mesh:
        assert dist.mesh_active() and tuple(mesh.shape) == (1, 1)
        assert dist.current_rules() == sharding.build_rules(cfg)
        assert dist.axis_size("heads") == 1
    assert not dist.mesh_active()
    with pytest.raises(RuntimeError, match="need 256 devices"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_local_mesh(2, 2, device="cpu")


def test_use_mesh_none_leaves_a_train_step_bitwise():
    """A step under the degenerate mesh is the step without it."""
    cfg = tget("qwen2-1.5b", smoke=True).with_overrides(recipe="tp_fsdp")
    opt = sgd(constant_schedule(1e-2))
    p0 = tzoo.init_params(cfg, 0, "cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    outs = []
    for ctx in (None, "mesh"):
        p = tree_map(torch.clone, p0)
        fn = make_train_step(cfg, opt)
        if ctx is None:
            outs.append(fn(p, opt.init(p), 0, {"tokens": tok})[0])
        else:
            with dist.use_mesh(None, sharding.build_rules(cfg), device="cpu"):
                outs.append(fn(p, opt.init(p), 0, {"tokens": tok})[0])
    for a, b in zip(tree_flatten(outs[0])[0], tree_flatten(outs[1])[0]):
        assert torch.equal(a, b)


def test_remat_recompute_sees_the_contexts_of_its_forward():
    """A checkpointed layer's recompute runs where the backward runs: on
    the card, the autograd engine's own thread, which has no mesh and no
    step on shards active. It re-enters the contexts its forward ran
    under: a backward on another thread sees the same ``axis_size`` and
    sharded step as the forward."""
    import threading
    from repro_torch.dist import fsdp
    from repro_torch.models.transformer import _remat_wrap

    cfg = tget("qwen2-1.5b", smoke=True).with_overrides(remat="full")
    seen = []

    def layer(x, lp):
        seen.append((dist.axis_size("model"), fsdp.current() is not None))
        return x * lp["w"], 0.0

    w = torch.ones(3, requires_grad=True)
    with fsdp.sharded(_FakeMesh({"data": 2, "model": 2}), {"act": {}}, ("data",)):
        y, _ = _remat_wrap(layer, cfg)(torch.arange(3.0), {"w": w})
    grads = []
    t = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y.sum(), [w])[0]))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and torch.equal(grads[0], torch.arange(3.0))
    assert seen == [(2, True), (2, True)]


# ---------------------------------------------------------------------------
# kv_repeat_factor and the MoE grouping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", [1, 2, 4, 8, 16])
def test_kv_repeat_factor_matches_the_reference(model):
    rules = sharding.build_rules(recipe="tp_fsdp")
    mesh = _FakeMesh({"data": 2, "model": model})
    for arch in ARCH_IDS:
        tc, jc = tget(arch), jget(arch)
        with dist.use_mesh(mesh, rules):
            got = tattn.kv_repeat_factor(tc)
        with jdist.use_mesh(mesh, rules):
            want = jattn.kv_repeat_factor(jc)
        assert got == want, arch
    if model == 4:     # qwen2-1.5b: 12 heads on 2 KV heads
        with dist.use_mesh(mesh, rules):
            assert tattn.kv_repeat_factor(tget("qwen2-1.5b")) == 2


def test_repeated_kv_heads_attend_as_grouped_ones():
    """At smoke width the factor stays 1; with n_heads 8 on 2 KV heads
    and model 4 it is 2: the repeated heads give the reference's output
    (no mesh, plain grouping) within 1e-6, and the KV cache keeps the
    model's 2 KV heads."""
    over = dict(n_heads=8, n_kv_heads=2, d_head=8)
    jc = dataclasses.replace(jget("qwen2-1.5b", smoke=True), **over)
    tc = dataclasses.replace(tget("qwen2-1.5b", smoke=True), **over)
    jp = jzoo.init_params(jc, 0)
    pnp = jax.tree.map(lambda a: np.asarray(a[0]),
                       jax.tree.map(np.asarray, jp)["stack"][0]["mixer"])
    x = np.random.default_rng(2).normal(size=(2, 12, jc.d_model)
                                        ).astype(np.float32)
    want, _ = jattn.self_attention(jax.tree.map(jnp.asarray, pnp), jc,
                                   jnp.asarray(x),
                                   positions=jnp.arange(12)[None],
                                   impl="dense")
    rules = sharding.build_rules(recipe="tp_fsdp")
    tp = {k: torch.tensor(v) for k, v in pnp.items()}
    with dist.use_mesh(_FakeMesh({"data": 1, "model": 4}), rules):
        assert tattn.kv_repeat_factor(tc) == 2
        cache = tattn.init_kv_cache(tc, 2, 16, torch.float32)
        got, cache = tattn.self_attention(
            tp, tc, torch.from_numpy(x), positions=torch.arange(12)[None],
            cache=cache, impl="dense")
    assert tuple(cache.k.shape) == (2, 16, 2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_token_groups_match_the_reference(cf, monkeypatch):
    """``expert_groups`` 2 (a data axis of 2): output and aux loss within
    1e-5 of the reference's, each group's expert ids, destinations and
    keep masks bitwise; at capacity factor 0.5 the groups drop other
    assignments than one group of all the tokens would. The reference's
    ``shard`` (a layout constraint, no value) is the identity here: its
    constraint needs a mesh of real devices."""
    jc = jget("granite-moe-1b-a400m", smoke=True)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=cf))
    tc = tget("granite-moe-1b-a400m", smoke=True)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=cf))
    p_np = jax.tree.map(np.asarray, jzoo.init_params(jc, 0))
    moe_np = jax.tree.map(lambda a: a[0], p_np["stack"])[0]["mlp"]
    x = np.random.default_rng(3).normal(size=(4, 16, jc.d_model)
                                        ).astype(np.float32)
    rules = {"param": {}, "act": {"expert_groups": ("pod", "data")}}
    mesh = _FakeMesh({"data": 2, "model": 1})
    monkeypatch.setattr(jmoe, "shard", lambda x, *axes: x)
    with jdist.use_mesh(mesh, rules):
        want_y, want_aux = jmoe.apply_moe(jax.tree.map(jnp.asarray, moe_np),
                                          jc, jnp.asarray(x))
    tp = jax.tree.map(torch.from_numpy, moe_np)
    with dist.use_mesh(mesh, rules):
        got_y, got_aux = tmoe.apply_moe(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5)

    t = 4 * 16
    groups = x.reshape(2, t // 2, -1)
    whole = []
    for xf in (groups[0], groups[1], x.reshape(t, -1)):
        probs = jax.nn.softmax(jnp.asarray(xf @ moe_np["router"]), axis=-1)
        gv, ids = jax.lax.top_k(probs, jc.moe.top_k)
        _, dest, _, keep = jmoe._dispatch_group(
            jc, jmoe._capacity(jc, xf.shape[0]), jnp.asarray(xf), ids, gv)
        tpr = torch.softmax(torch.from_numpy(xf) @ tp["router"], dim=-1)
        _, tids = tmoe.top_k(tpr, tc.moe.top_k)
        _, tdest, _, tkeep = tmoe._dispatch_group(
            tc, tmoe._capacity(tc, xf.shape[0]), torch.from_numpy(xf), tids)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
        np.testing.assert_array_equal(tdest.numpy(), np.asarray(dest))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
        whole.append(tkeep.numpy())
    if cf < 1.0:
        grouped = np.concatenate([whole[0].reshape(t // 2, -1),
                                  whole[1].reshape(t // 2, -1)])
        assert not grouped.all()
        with dist.use_mesh(_FakeMesh({"data": 1}), rules):
            one_y, _ = tmoe.apply_moe(tp, tc, torch.from_numpy(x))
        assert not np.allclose(one_y.numpy(), got_y.numpy())


# ---------------------------------------------------------------------------
# compression (host route) and the elastic mechanism in one process
# ---------------------------------------------------------------------------

def test_compressed_mean_host_side_matches_the_reference():
    rng = np.random.default_rng(1)
    for shape in ((8, 64), (4, 3, 5), (6,)):
        x = rng.normal(size=shape).astype(np.float32)
        mean, err = tcomp.compressed_allreduce_mean(torch.from_numpy(x))
        jmean, jerr = jcomp.compressed_allreduce_mean(jnp.asarray(x))
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean),
                                   rtol=1e-6, atol=1e-7)
        assert float(err) == pytest.approx(float(jerr), rel=1e-6)
        np.testing.assert_allclose(mean.numpy(), x.mean(0), atol=MEAN_ATOL)


def test_rescale_cycle_preserves_values(tmp_path):
    """save -> rebuild_mesh -> reshard_tree in a world of one: the same
    values back on a (1, 1) mesh, the checkpoint left behind."""
    tree = {"params": {"w": torch.arange(32.0).reshape(8, 4)},
            "opt": {"m": torch.ones((8, 4))}}
    axes = {"params": {"w": ("embed", "ff")},
            "opt": tel.replicated_axes(tree["opt"])}
    assert axes["opt"] == {"m": (None, None)}
    rules = {"param": {"embed": "data", "ff": "model"}, "act": {}}
    out, mesh = tel.rescale_cycle(tmp_path, 7, tree, axes, rules,
                                  new_workers=2)
    assert tuple(mesh.shape) == (1, 1)
    for a, b in zip(tree_flatten(out)[0], tree_flatten(tree)[0]):
        assert torch.equal(a, b) and type(a) is torch.Tensor
    assert dist.checkpoint.latest_step(tmp_path) == 7


def test_factor_and_plans_match_the_reference():
    for n in range(1, 20):
        for pm in (1, 2, 4, 8):
            assert tel.factor_mesh(n, pm) == jel.factor_mesh(n, pm)
    for a, b in ((2, 4), (4, 2), (4, 6), (3, 3)):
        assert dataclasses.astuple(tel.plan_reshard(a, b)) == \
            dataclasses.astuple(jel.plan_reshard(a, b))


# ---------------------------------------------------------------------------
# a 4-rank gloo world: one spawn for the file
# ---------------------------------------------------------------------------

GATES = {"gate_attn": 0.7, "gate_mlp": -0.45}


def _open_gates(tree):
    """The vision gates opened (each layer's its own value): at their
    initial 0 the cross layer adds nothing and no check could see it."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATES[k]) + 0.1 * np.arange(
            v.size, dtype=v.dtype).reshape(v.shape)
                    if k in GATES else _open_gates(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_open_gates(v) for v in tree]
    return tree


def _params(jc, tc):
    """Both packages' seed-0 parameters of ``jc``/``tc`` (the vision
    gates opened)."""
    np_tree = _open_gates(jax.tree.map(np.asarray, jzoo.init_params(jc, 0)))
    return (jax.tree.map(jnp.asarray, np_tree),
            convert.params_from_numpy(tc, np_tree, device="cpu"))


def _inputs(cfg, rng, B, S) -> dict:
    """Tokens and the frontend's stub input of ``cfg``, as numpy."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(B, cfg.frontend_len,
                                          cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, S, cfg.frontend_dim)
                                   ).astype(np.float32)
    return out


def _seq(name) -> dict:
    """``seq_shard=True`` for the cases of ``ranks.SEQ_SHARD``."""
    return {"seq_shard": True} if name in ranks.SEQ_SHARD else {}


def _train_case(name):
    arch, recipe, opt, mb, compression = ranks.TRAIN_CASES[name]
    jc = jget(arch, smoke=True).with_overrides(recipe=recipe, remat="full",
                                               **_seq(name))
    tc = tget(arch, smoke=True).with_overrides(recipe=recipe, remat="full",
                                               **_seq(name))
    jp, tp = _params(jc, tc)
    inputs = _inputs(jc, np.random.default_rng(0), 8, 32)
    tokens = inputs.pop("tokens")
    return jc, tc, jp, tokens, {"arch": arch, "recipe": recipe, "lr": 1e-2,
                                "opt": opt, "microbatches": mb,
                                "compression": compression, "params": tp,
                                "tokens": torch.from_numpy(tokens),
                                "extra": {k: torch.from_numpy(v)
                                          for k, v in inputs.items()},
                                **_seq(name)}


def _serve_case(name):
    arch, recipe = ranks.SERVE_CASES[name]
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    jp, tp = _params(jc, tc)
    S = ranks.SERVE_PROMPT.get(name, 12)
    batch = _inputs(tc, np.random.default_rng(4), 4, S)
    return jc, jp, {"arch": arch, "recipe": recipe, "params": tp,
                    "batch": {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                    "max_len": S + ranks.SERVE_TOKENS, **_seq(name)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4 ranks once; each one's saved results, and the inputs."""
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("ranks")
    cases = {name: _train_case(name) for name in ranks.TRAIN_CASES}
    serve = {name: _serve_case(name) for name in ranks.SERVE_CASES}
    wx = np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32)
    payload = {"workers_x": torch.from_numpy(wx),
               **{k: c[-1] for k, c in cases.items()},
               **{"serve/" + k: c[-1] for k, c in serve.items()}}
    torch.save(payload, d / "payload.pt")
    ctx = mp.start_processes(
        ranks.run, args=(4, str(d / "store"), str(d), str(d / "payload.pt")),
        nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("a rank hung")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    return {"res": res, "cases": cases, "workers_x": wx, "serve": serve}


def test_reshard_tree_shards_as_the_reference_places_them(world):
    """Each rank's local shard is the slice JAX's ``devices_indices_map``
    gives the same device of the reference's (2, 2) mesh (rank r, device
    r, row-major), ``("data", "model")`` on one dim included; every leaf
    round-trips bitwise. ``fsdp.Layout``'s shards of the full values (the
    step's) are the same slices, and its DTensors hold the full values."""
    jm = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    tree = ranks.reshard_tree_input()
    for r, res in enumerate(world["res"]):
        assert res["coordinate"] == (r // 2, r % 2)
        assert all(res["roundtrip"].values())
        for k, full in tree.items():
            spec = japi.logical_to_spec(ranks.RESHARD_AXES[k],
                                        ranks.RESHARD_RULES["param"], jm,
                                        tuple(full.shape))
            idx = NamedSharding(jm, spec).devices_indices_map(
                tuple(full.shape))[jax.devices()[r]]
            want = torch.from_numpy(np.asarray(full.numpy()[idx]))
            assert torch.equal(res["local"][k], want), k
            assert torch.equal(res["layout_local"][k], want), k
        assert all(res["layout_roundtrip"].values())
    assert world["res"][0]["placements"] == {"w": [0, 1], "b": [None, None],
                                             "v": [0, 0], "s": [None, None]}


def test_rebuild_mesh_after_failures_matches_the_reference(world):
    devs = jax.devices()[:4]
    for (failed, prefer), (shape, members) in zip(ranks.REBUILD_CASES,
                                                  world["res"][0]["rebuild"]):
        jm = jel.rebuild_mesh(devs, failed=failed, prefer_model=prefer)
        assert shape == tuple(jm.devices.shape)
        assert members == [d.id for d in jm.devices.flat]
    for res in world["res"][1:]:
        assert res["rebuild"] == world["res"][0]["rebuild"]


def test_compressed_allreduce_group_route_matches_host_route(world):
    wx = world["workers_x"]
    host, herr = tcomp.compressed_allreduce_mean(torch.from_numpy(wx))
    for res in world["res"]:
        for key in ("cmean_mesh", "cmean_world"):
            mean, err = res[key]
            np.testing.assert_allclose(mean.numpy(), host.numpy(),
                                       rtol=0, atol=ROUTE_TOL)
            assert float(err) == pytest.approx(float(herr), abs=ROUTE_TOL)
            np.testing.assert_allclose(mean.numpy(), wx.mean(0),
                                       atol=MEAN_ATOL)


def _expected_local(axes_tree, shape_tree, rules):
    """Each leaf's local shape on the (2, 2) mesh by the param rules."""
    fake = _FakeMesh({"data": 2, "model": 2})
    out = {}
    for (path, ax), t in zip(
            tree_flatten_with_path(axes_tree, is_leaf=api.is_axes)[0],
            tree_flatten(shape_tree)[0]):
        spec = api.logical_to_spec(ax, rules["param"], fake, t.shape)
        shp = list(t.shape)
        for i, part in enumerate(spec):
            for a in ((part,) if isinstance(part, str) else (part or ())):
                shp[i] //= fake.shape[a]
        out[path] = tuple(shp)
    return out


MOE = ("moe", "hybrid", "mla_moe", "mla_tp", "hybrid_seq", "mla_tp_seq")
GRAD_TOL = 1e-4      # a gradient leaf's error, of its largest element


@contextlib.contextmanager
def _token_groups(enabled: bool, rules):
    """Both packages under a stand-in (data 2, model 1) mesh: MoE token
    groups of the (2, 2) mesh's rank (two), and no other split; the
    reference's layout constraints (which need real devices) are the
    identity. Nothing where ``enabled`` is false."""
    if not enabled:
        yield
        return
    groups = _FakeMesh({"data": 2, "model": 1})
    real = jdist._constrain
    jdist._constrain = lambda x, axes, key: x
    try:
        with dist.use_mesh(groups, rules), jdist.use_mesh(groups, rules):
            yield
    finally:
        jdist._constrain = real


def _grad_gap(got, want, tol):
    """Each leaf's largest error against ``want``'s, over ``tol`` of its
    largest element: the worst leaf's ratio (at most 1 passes)."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        worst = max(worst, np.abs(a - b).max() / (tol * scale))
    return worst


# one process's results by case arguments: a ``seq_shard`` twin (the
# same config, params and batch) shares them, the split being the
# mesh's only
_STEPS = {}


def _single_step(case, tc, payload, batch, rules):
    """The single-process step of ``case``: (params, state, metrics,
    the recorded clipped gradients)."""
    key = ("single",) + ranks.TRAIN_CASES[case]
    if key not in _STEPS:
        grads = []
        opt = ranks.recording(ranks.make_opt(tc, payload), grads)
        p = tree_map(torch.clone, payload["params"])
        step = make_train_step(tc, opt,
                               microbatches=payload["microbatches"],
                               grad_compression=payload["compression"])
        with _token_groups(case in MOE, rules):
            single, single_state, _, m = step(p, opt.init(p), 0, batch)
        _STEPS[key] = (single, single_state, m, grads)
    return _STEPS[key]


def _reference_step(case, jc, jp, payload, batch, rules):
    """The reference's unsharded jitted step and ``jax.grad`` of
    ``case``: (params, loss, gradients)."""
    key = ("reference",) + ranks.TRAIN_CASES[case]
    if key not in _STEPS:
        jopt = joptim.make_optimizer(jc, payload["opt"],
                                     lr=lambda s: payload["lr"])
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        with _token_groups(case in MOE, rules):
            jstep = jax.jit(jmake_train_step(jc, jopt, microbatches=1))
            pj, *_ = jstep(jp, jopt.init(jp), jnp.asarray(0), jb)
            jl, jg = jax.jit(jax.value_and_grad(
                lambda q: jzoo.lm_loss(q, jc, jb)[0]))(jp)
        _STEPS[key] = (pj, jl, jg)
    return _STEPS[key]


@pytest.mark.parametrize("case", list(ranks.TRAIN_CASES))
def test_sharded_train_step_matches_single_process(world, case):
    """One step on a (2, 2) mesh on the rank's shards (``remat="full"``):
    ``tp_fsdp`` and ``fsdp`` dense (SGD, AdamW, Adafactor; ``tp_fsdp``
    also with Adafactor, whose factored means reduce over the ``model``
    slices, and with the int8 wire format and 2 microbatches, split from
    the rank's slice), ``ep_fsdp`` MoE (granite; deepseek's MLA with its
    shared experts), ``tp_fsdp`` rwkv6 and vision (cross-attention, its
    gates opened), ``ep_tp_fsdp`` jamba (Mamba, attention and MoE) and
    deepseek (MLA's heads and the shared experts' ``ff`` split too). On
    the ``model`` axis of 2 the tp/ep recipes compute on the rank's slice
    of heads, ``ff``, ``vocab``, ``dinner`` and experts
    (``dist/tp.py``). The loss and the gradient norm within 1e-5, the
    params within ``rtol`` 2e-3, ``atol`` 2e-4 and the clipped gradients
    within 1e-4 of each leaf's largest (the int8 wire format: one
    quantization step, 1/127 of it) of the single-process step (MoE under
    two token groups, the reference's grouping on that mesh) and, for
    every case but the int8 one, of the reference's unsharded jitted step
    and its ``jax.grad`` on the same converted inputs (the params within
    the same bounds, the gradients within 1e-3 of each leaf's largest);
    each rank holds the shapes the param rules give, its optimizer
    moments too."""
    jc, tc, jp, tokens, payload = world["cases"][case]
    rules = sharding.build_rules(tc)
    batch = {"tokens": torch.from_numpy(tokens), **payload["extra"]}
    single, single_state, m, grads = _single_step(case, tc, payload, batch,
                                                  rules)
    axes = tzoo.param_axes(tc)
    want_local = _expected_local(axes, single, rules)
    want_state = _expected_local(
        ranks.make_opt(tc, payload).state_axes(axes), single_state, rules)
    grad_tol = 1 / 127 if payload["compression"] else GRAD_TOL
    moved = False
    for res in world["res"]:
        got = res[case]
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                 rel=1e-5)
        assert got["local_shapes"] == want_local
        assert got["state_local"] == want_state
        for a, b, c in zip(tree_flatten(got["params"])[0],
                           tree_flatten(single)[0],
                           tree_flatten(payload["params"])[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)
            moved |= not torch.equal(b, c)
        assert _grad_gap(tree_flatten(got["grads"])[0],
                         tree_flatten(grads[0])[0], grad_tol) <= 1.0
    assert moved
    full = {k: tuple(v.shape) for k, v in tree_flatten_with_path(single)[0]}
    assert any(want_local[k] != full[k] for k in full)     # shards held
    if payload["compression"]:
        return
    pj, jl, jg = _reference_step(case, jc, jp, payload, batch, rules)
    assert world["res"][0][case]["loss"] == pytest.approx(float(jl),
                                                          rel=1e-5)
    for a, b in zip(tree_flatten(world["res"][0][case]["params"])[0],
                    jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
    # the reference's gradients, clipped by their global norm as the step
    # clips them
    jg = jax.tree.leaves(jg)
    norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jg)))
    clip = min(1.0, 1.0 / norm)
    assert _grad_gap(tree_flatten(world["res"][0][case]["grads"])[0],
                     [np.asarray(g) * clip for g in jg], 1e-3) <= 1.0


_jprefill = jax.jit(jzoo.prefill, static_argnums=(1, 3),
                    static_argnames=("impl",))
_jdecode = jax.jit(jzoo.decode_step, static_argnums=(1,),
                   static_argnames=("impl",))


def _reference_greedy(jc, jp, batch, max_len, new_tokens):
    """The reference's prefill and greedy decode steps (chunked paths)."""
    logits, caches = _jprefill(jp, jc, batch, max_len, impl="chunked")
    out = []
    for i in range(new_tokens):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        if i + 1 < new_tokens:
            logits, caches = _jdecode(jp, jc, caches, tok, impl="chunked")
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("case", list(ranks.SERVE_CASES))
def test_sharded_serving_matches_single_process(world, case):
    """The smoke configs served on the (2, 2) mesh: seamless-m4t-medium
    (enc-dec, ``tp_fsdp``), rwkv6 and vision (``tp_fsdp``), jamba
    (``ep_tp_fsdp``), deepseek (``ep_fsdp``, and ``ep_tp_fsdp`` for MLA's
    split heads): prefill and 4 greedy decode steps on each rank's shards
    of the params (each layer gathered over ``data`` where it runs, the
    ``model`` splits computed on) and its slice of the 4 prompts; the
    tokens equal the single process's and the reference's on the same
    rows, every MoE layer's expert ids are the single process's bit for
    bit (the router's logits gathered, so every rank routes alike), each
    rank holds the shapes the param rules give, and its caches hold its
    share of the KV heads, ``dinner`` channels or RWKV heads (the act
    rules' split of each cache leaf)."""
    jc, jp, payload = world["serve"][case]
    tc = tget(payload["arch"], smoke=True).with_overrides(
        recipe=payload["recipe"], remat="full", **_seq(case))
    rules = sharding.build_rules(tc)
    want_local = _expected_local(tzoo.param_axes(tc), payload["params"],
                                 rules)
    for res in world["res"]:
        got = res["serve/" + case]
        lo, hi = got["rows"]
        rows = {k: v[lo:hi] for k, v in payload["batch"].items()}
        with torch.no_grad(), ranks.RoutingLog() as routing:
            want, caches = ranks.greedy(payload["params"], tc, rows,
                                        payload["max_len"],
                                        ranks.SERVE_TOKENS, with_caches=True)
        assert torch.equal(got["tokens"], want)
        # every MoE layer's expert ids, bitwise (each rank routes alike)
        assert len(got["routing"]) == len(routing.ids)
        assert all(torch.equal(a, b)
                   for a, b in zip(got["routing"], routing.ids))
        assert bool(routing.ids) == (tc.moe is not None
                                     and tc.moe.num_experts > 0)
        key = ("greedy", payload["arch"], lo, hi, payload["max_len"])
        if key not in _STEPS:
            _STEPS[key] = _reference_greedy(
                jc, jp, {k: jnp.asarray(v.numpy()) for k, v in rows.items()},
                payload["max_len"], ranks.SERVE_TOKENS)
        ref = _STEPS[key]
        np.testing.assert_array_equal(got["tokens"].numpy(), ref)
        assert got["local_shapes"] == want_local
        cache_axes = tzoo.cache_axes(caches)
        whole = {k: tuple(v.shape) for k, v in
                 tree_flatten_with_path(caches)[0]}
        # the rank's rows are the single process's: split the rest
        act = {k: v for k, v in rules["act"].items() if k != "batch"}
        split = _expected_local(cache_axes, caches, {"param": act})
        assert got["cache_shapes"] == split
        if payload["recipe"] != "ep_fsdp" and tc.mla is None:
            assert split != whole                  # a cache leaf is split
    assert {r["serve/" + case]["rows"] for r in world["res"]} == {(0, 2),
                                                                (2, 4)}


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_no_model_split_param_is_gathered_over_model(world, kind):
    """Every all-gather of every rank's train and serving steps, by the
    mesh axis of its group and what made it: under ``tp_fsdp``,
    ``ep_fsdp`` and ``ep_tp_fsdp`` no parameter is all-gathered over
    ``model`` (``fsdp._Gather`` gathers over ``data`` only: the dims the
    param rules map to ``model`` stay the rank's slice), while the
    activations the layers gather over ``model`` (``tp.gather_out``: the
    router's logits, the channel mix's receptance, Mamba's input
    projection, the last position's logits) are; under ``fsdp`` nothing
    is gathered over ``model``."""
    names = (ranks.TRAIN_CASES if kind == "train" else
             {k: (a, r, None, None, None)
              for k, (a, r) in ranks.SERVE_CASES.items()})
    seen = set()
    for name, (arch, recipe, *_) in names.items():
        key = name if kind == "train" else "serve/" + name
        for res in world["res"]:
            g = res[key]["gathers"]
            assert g.get(("model", "_Gather"), 0) == 0, (name, g)
            assert g.get(("model", "other"), 0) == 0, (name, g)
            assert g.get(("data", "_Gather"), 0) > 0, (name, g)
            if recipe == "fsdp":
                assert not any(a == "model" for a, _ in g), (name, g)
            seen.add(recipe)
            if g.get(("model", "_GatherOut"), 0):
                seen.add("activations over model")
    assert {"tp_fsdp", "ep_fsdp", "ep_tp_fsdp",
            "activations over model"} <= seen


def _count(table: dict, axis: str, kind: str, who: str, phase=None) -> int:
    return sum(v for (a, k, w, p), v in table.items()
               if a == axis and k == kind and w == who
               and (phase is None or p == phase))


def _twin(name: str) -> str:
    """The ``seq_shard=False`` case a ``_seq`` case is the twin of."""
    return name[:-len("_seq")]


def test_seq_shard_train_step_reduce_scatters_the_residual(world):
    """With ``seq_shard=True`` under ``tp_fsdp`` and ``ep_tp_fsdp`` (each
    ``_seq`` train case: its twin's config, params and batch; dense,
    rwkv6's time and channel mix, jamba's Mamba, attention and experts,
    the vision model's gated cross-attention, deepseek's MLA on its heads
    with the latent whole) the residual stream is the
    rank's slice of the 32-token sequence: each layer's output products
    reduce-scatter over ``model`` (the backward all-gathers their
    gradients) and the norms' outputs are all-gathered over ``model``
    before the next column-parallel product (``tp.gather_in``), in place
    of the ``seq_shard=False`` twin's all-reduces of those products: the
    twin's extra all-reduces over ``model`` are exactly the
    reduce-scatters. Nothing is reduce-scattered over ``model`` without
    ``seq_shard``."""
    names = [n for n in ranks.TRAIN_CASES if n in ranks.SEQ_SHARD]
    assert len(names) == 5, names
    for res, name in ((r, n) for r in world["res"] for n in names):
        seq, twin = res[name], res[_twin(name)]
        rs = _count(seq["reductions"], "model", "reduce_scatter",
                    "_ReduceScatterOut.forward")
        ar_seq = _count(seq["reductions"], "model", "all_reduce",
                        "_ReduceOut.forward")
        ar_twin = _count(twin["reductions"], "model", "all_reduce",
                         "_ReduceOut.forward")
        assert rs > 0 and ar_twin - ar_seq == rs, (name, rs, ar_seq,
                                                   ar_twin)
        g = seq["gathers"]
        assert g.get(("model", "gather_in"), 0) > 0, (name, g)
        assert g.get(("model", "_ReduceScatterOut.backward"), 0) > 0, g
        assert _count(twin["reductions"], "model", "reduce_scatter",
                      "_ReduceScatterOut.forward") == 0
        assert not any(a == "model" and (w == "gather_in" or
                                         w.startswith("_ReduceScatter"))
                       for a, w in twin["gathers"])


def test_seq_shard_serving_scatters_prefill_and_keeps_decode_whole(world):
    """Serving with ``seq_shard=True``: seamless-m4t-medium's, rwkv6's,
    jamba's (Mamba, attention, experts) and deepseek's (MLA on its heads,
    experts) 12-token prefills (seamless's encoder and decoder) reduce-
    scatter their layers' output products over ``model`` and all-gather
    the norms' outputs; their decode steps (one position, which does not
    divide) all-reduce as before and reduce-scatter nothing; an 11-token
    prompt (and frames) does not divide either, so that prefill keeps the
    all-reduce. The ``seq_shard`` off cases reduce-scatter nothing over
    ``model``."""
    for res, name in ((r, n) for r in world["res"]
                      for n in ("encdec_seq", "rwkv_seq", "hybrid_seq",
                                "mla_tp_seq")):
        enc = res["serve/" + name]["reductions"]
        assert _count(enc, "model", "reduce_scatter",
                      "_ReduceScatterOut.forward", "prefill") > 0, enc
        assert _count(enc, "model", "reduce_scatter",
                      "_ReduceScatterOut.forward", "decode") == 0, enc
        assert _count(enc, "model", "all_reduce", "_ReduceOut.forward",
                      "decode") > 0, enc
        assert res["serve/" + name]["gathers"].get(
            ("model", "gather_in"), 0) > 0
    for res in world["res"]:
        odd = res["serve/encdec_seq_odd"]["reductions"]
        assert _count(odd, "model", "reduce_scatter",
                      "_ReduceScatterOut.forward") == 0, odd
        assert _count(odd, "model", "all_reduce", "_ReduceOut.forward",
                      "prefill") > 0, odd
        for name in ranks.SERVE_CASES:
            if name not in ranks.SEQ_SHARD:
                assert _count(res["serve/" + name]["reductions"], "model",
                              "reduce_scatter",
                              "_ReduceScatterOut.forward") == 0, name


def test_chip_smoke_phase_17_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 17 end to end on the CPU at smoke size
    (``torch_dist_ranks.phase17_stubs`` in this process and in each one
    the phase starts): the one-rank references, the two gloo ranks on
    their shards and the (2, 1) dry run pass their checks (loss, grad
    norm, params, arguments against the rules and the dry run, tokens),
    and the ranks' flash launches are the path's."""
    import pathlib
    import subprocess

    here = pathlib.Path(__file__).resolve().parent
    monkeypatch.syspath_prepend(str(here.parent))
    import chip_smoke as cs

    ranks.phase17_stubs(monkeypatch.setattr)
    monkeypatch.setattr(cs, "log", lambda *a: None)
    prelude = (f"import sys; sys.path.insert(0, {str(here)!r}); "
               "import torch_dist_ranks; torch_dist_ranks.phase17_stubs()\n")
    popen = subprocess.Popen

    def with_stubs(cmd, *a, **k):
        if cmd[1] == "-c":
            cmd = [cmd[0], "-c", prelude + cmd[2]]
        return popen(cmd, *a, **k)
    monkeypatch.setattr(subprocess, "Popen", with_stubs)
    counts = cs.sharded_phase(torch.device("cpu"))
    assert counts["flash_attention"] > 0
    assert not any(v for k, v in counts.items() if k != "flash_attention")


def test_chip_smoke_phase_18_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 18 end to end on the CPU at smoke size
    (the same stubs as phase 17's, in this process and in each one the
    phase starts): the one-rank references, the two gloo ranks of the
    (1, 2) mesh computing on their heads and experts (and, in 18d, with
    the config's ``seq_shard`` flipped: on their slice of the sequence
    here) and the (1, 2) dry runs pass their checks (tokens, the
    kernels' heads, the split caches' bytes, 18d's reduce-scatters,
    loss, grad norm, params, arguments against the rules and the dry
    run's ``"sharded_tp"`` record), and the ranks' flash and WKV
    launches are the path's. 18e-18g at smoke size: jamba's Mamba and
    deepseek's MLA split served under ``ep_tp_fsdp`` (tokens, routing
    flips, each step's logits on every row, jamba's K, V, conv and SSM
    states halved, deepseek's latent cache whole, the params the rules'
    shapes), deepseek's 4-layer step on the ranks and its dry run's
    ``"sharded_tp_seq"`` record (loss), and the fp32 twins in both
    ``seq_shard`` forms (tokens bitwise, routing, reduce-scatters only
    in the ``seq_sp`` form)."""
    import pathlib
    import subprocess

    here = pathlib.Path(__file__).resolve().parent
    monkeypatch.syspath_prepend(str(here.parent))
    import chip_smoke as cs

    ranks.phase17_stubs(monkeypatch.setattr)
    lines = []
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    prelude = (f"import sys; sys.path.insert(0, {str(here)!r}); "
               "import torch_dist_ranks; torch_dist_ranks.phase17_stubs()\n")
    popen = subprocess.Popen

    def with_stubs(cmd, *a, **k):
        if cmd[1] == "-c":
            cmd = [cmd[0], "-c", prelude + cmd[2]]
        return popen(cmd, *a, **k)
    monkeypatch.setattr(subprocess, "Popen", with_stubs)
    counts = cs.tp_phase(torch.device("cpu"))
    assert counts["flash_attention"] > 0 and counts["rwkv6_wkv"] > 0
    assert not any(v for k, v in counts.items()
                   if k not in ("flash_attention", "rwkv6_wkv"))
    text = "\n".join(lines)
    for r in range(2):
        for tag, split in (("18a", "['k', 'v']"), ("18b", "['wkv']")):
            line = next(ln for ln in lines if f"rank {r} {tag}: " in ln)
            assert "tokens equal the one rank's: True" in line
            assert f"split cache leaves {split}" in line
        # the smoke config's seq_shard is off, so 18d runs the seq_sp form
        assert (f"rank {r} 18d (seq_shard=True; 18a seq_shard=False): "
                "tokens equal the one rank's: True") in text
        assert f"rank {r} 18c: loss" in text
        assert f"rank {r} 18g: loss" in text
        for tag, split, whole in (
                ("18e", "['conv', 'h', 'k', 'v']", "['length']"),
                ("18f", "[]", "['c_kv', 'k_rope', 'length']")):
            line = next(ln for ln in lines if f"rank {r} {tag}: " in ln)
            assert "tokens equal the one rank's: True" in line
            assert "routing flips by layer [" in line
            held = [cs.SERVE_BATCH] * (1 + cs.SHARD_DECODES)
            assert f"logits held on {held} rows a step" in line
            assert f"cache leaves split {split}" in line
            assert f"whole {whole}" in line
            assert "hand-kernel launches 0" in line
        for arch in cs.TP_TWIN_ARCHS:
            for seq in (False, True):
                line = next(ln for ln in lines if
                            f"rank {r} twin {arch} seq_shard={seq}: " in ln)
                assert "tokens bitwise the one rank's: True" in line
                assert "parted at one: False" in line
                rs = int(line.split("'reduce_scatter_tensor': ")[2]
                         .split(",")[0])
                assert (rs > 0) == seq, line


@pytest.mark.parametrize("arch,recipe", [
    ("seamless-m4t-medium", "tp_fsdp"), ("rwkv6-1.6b", "tp_fsdp"),
    ("jamba-1.5-large-398b", "ep_tp_fsdp"),
    ("deepseek-v2-lite-16b", "ep_tp_fsdp")])
def test_phase_18_cache_split_is_held_to_the_named_leaves(monkeypatch, arch,
                                                          recipe):
    """``chip_smoke.split_cache_check`` on a smoke config's cache after
    one greedy step: a rank's leaves at the act rules' split pass, the
    split leaves ``TP_CACHE_SPLIT``'s names and exactly half the one
    rank's bytes (MLA's latent whole); where the rules stopped splitting
    a named leaf (the rank's leaf then whole too), it fails."""
    import pathlib
    import re

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve()
                                    .parents[1]))
    import chip_smoke as cs
    from repro_torch.serve.engine import wave_inputs

    for k, v in {"PROMPT": 8, "MAX_LEN": 32, "SHARD_DECODES": 1,
                 "SERVE_BATCH": 2}.items():
        monkeypatch.setattr(cs, k, v)
    cfg = tget(arch, smoke=True).with_overrides(recipe=recipe)
    params = tzoo.init_params(cfg, 0, "cpu")
    _, want, _ = cs.greedy_tokens(params, cfg, wave_inputs(
        cfg, cs.serve_prompts(cfg), torch.device("cpu")))

    def rank_of(split):
        return {p: (None, None, b) for p, (b, _) in split(cfg, want).items()}

    mine, ones, split, whole = cs.split_cache_check(
        arch, arch, cfg, rank_of(cs.act_split), want)
    assert split == cs.TP_CACHE_SPLIT[arch] and 2 * mine == ones
    if cfg.mla is not None:
        assert {"c_kv", "k_rope"} <= set(whole) and not split
        return
    real = cs.act_split

    def unsplit(cfg, cache):
        return {p: (cache[p][2], False)
                if re.findall(r"\w+", p)[-1] == split[0] else v
                for p, v in real(cfg, cache).items()}
    monkeypatch.setattr(cs, "act_split", unsplit)
    with pytest.raises(AssertionError, match="halved"):
        cs.split_cache_check(arch, arch, cfg, rank_of(unsplit), want)


def test_row_parallel_partials_are_fp32_products_of_bf16_operands():
    """``tp._MatmulF32`` (a row-parallel product's partial sums): bf16
    operands, an fp32 result equal to the fp32 product of the same
    operands within fp32 rounding (no bf16 rounding of the result); its
    backward's products in bf16, within a bf16 ulp of the fp32 ones."""
    from repro_torch.dist import tp
    g = torch.Generator().manual_seed(0)
    a = torch.randn((6, 40), generator=g).to(torch.bfloat16)
    b = torch.randn((40, 5), generator=g).to(torch.bfloat16)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = tp._MatmulF32.apply(a, b)
    want = a.detach().double() @ b.detach().double()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().double().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-5)
    assert not torch.equal(out.detach(), out.detach().to(torch.bfloat16)
                           .float())
    gy = torch.randn((6, 5), generator=g)
    ga, gb = torch.autograd.grad(out, (a, b), gy)
    assert ga.dtype == gb.dtype == torch.bfloat16
    eps = float(torch.finfo(torch.bfloat16).eps)
    for got, w in ((ga, gy.double() @ b.detach().double().t()),
                   (gb, a.detach().double().t() @ gy.double())):
        err = (got.double() - w).abs().max().item()
        assert err <= 2 * eps * w.abs().max().item()


def test_the_steps_on_a_mesh_gather_no_whole_tree():
    """The train step's and the dry run's step code gathers no whole
    tree: neither calls ``gather_tree`` nor ``full_tensor``."""
    import inspect
    from repro_torch.launch import dryrun
    from repro_torch.train import train_step
    for mod in (train_step, dryrun):
        src = inspect.getsource(mod)
        assert "gather_tree" not in src and "full_tensor" not in src, mod


def test_mesh_context_on_four_ranks_sizes_the_axes(world):
    """Every rank saw axis_size("heads") == 2 under mesh_context((2, 2))."""
    assert [r["axis_heads"] for r in world["res"]] == [2, 2, 2, 2]
