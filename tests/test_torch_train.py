"""The port's training path (``repro_torch.train``, gradients through
``repro_torch.models``) against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
port's weights and optimizer state are the JAX package's, converted leaf
for leaf (``convert.params_from_numpy``, ``convert.opt_state_from_numpy``).
The JAX side runs its own chunked paths (``impl="chunked"``, the
reference trains only through them) under ``jax.jit``.

Tolerances, and why:

* gradients in fp32: each leaf within 1e-4 of its largest |grad|; the
  two packages sum in other orders and XLA contracts multiply-adds. The
  key bias ``bk`` of a model without rotary positions is the exception:
  its gradient is zero in exact arithmetic (softmax does not move when
  one shift is added to every key), so both packages' are held to 1e-6
  of the tree's largest |grad| instead;
* gradients in bf16 (the dense config with ``fp32_master``): each leaf
  within 4 bf16 ulps of its largest |grad|, of the reference's and of
  the fp32 gradient of the same weights. Looser than 2 ulps because the
  reference itself lies up to 3.4 ulps from that fp32 gradient: XLA on
  the CPU keeps fused bf16 intermediates in fp32 (excess precision),
  where torch rounds every op's output to bf16;
* optimizers on the same gradients: fp32 state within 2e-6 relative,
  bf16 within one ulp (the roundings of the same ops, XLA's FMAs aside);
* train steps (3 of them, lr 1e-2): losses, gradient norms, and every
  leaf of the parameters and moments within 1e-4 of its largest value.
  AdamW's normalised update moves a coordinate whose gradient is near
  zero by a good part of ``lr`` whatever the gradient's last bits are,
  so the gradients' rounding-level differences reach the parameters as
  differences of up to 6e-5 of a leaf (rwkv, the third step), and of up
  to 1e-3 ``lr`` on a leaf of small gradients (qwen2's rotary key bias):
  parameters get 2e-3 ``lr`` on top. A wrong update would show at the
  scale of ``lr``. The key biases whose gradient is rounding noise
  (above) move by noise on both sides: each side is held to AdamW's
  bound of ``lr`` a step, and its moments to 1e-6 of the largest.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.models import model_zoo as jzoo
from repro.streams import drift as jdrift
from repro.streams.generators import DriftSpec as JDriftSpec
from repro.streams.generators import TokenStream as JTokenStream
from repro.train import optim as JO
from repro.train.ops import train_state_bytes as j_train_state_bytes
from repro.train.train_step import make_train_step as j_make_train_step

from repro_torch import convert
from repro_torch._tree import (tree_flatten_with_path, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.configs import get_config as tget
from repro_torch.core.pipeline import OpGraph
from repro_torch.dist import checkpoint as tckpt
from repro_torch.launch.roofline import dl_operator_cost
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve.ops import param_bytes
from repro_torch.streams import drift as tdrift
from repro_torch.streams.generators import DriftSpec, TokenStream
from repro_torch.train import optim as O
from repro_torch.train.ops import dl_train_op, train_state_bytes
from repro_torch.train.train_step import (clip_by_global_norm, global_norm,
                                          make_train_step)

ARCHS = ("qwen2-1.5b", "rwkv6-1.6b", "seamless-m4t-medium",
         "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b", "llama-3.2-vision-90b",
         "mistral-large-123b", "nemotron-4-15b", "qwen1.5-4b")
GRAD_TOL = 1e-4          # of each leaf's largest |grad|, fp32
ZERO_GRAD_TOL = 1e-6     # of the tree's largest |grad|: leaves zero in exact math
BF16_ULPS = 4.0
STEP_TOL = 1e-4
LR = 1e-2
NEAR_ZERO_MOVE = 2e-3   # of lr: a coordinate whose gradient is near zero
_CACHE = {}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree) -> dict:
    """``{path: float32 numpy}`` for a JAX tree or a port tree."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().numpy()
        return np.asarray(a, np.float32)
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        return {p: leaf(a) for p, a in tree_flatten_with_path(tree)[0]}
    return {p: leaf(a) for p, a in tree_flatten_with_path(
        jax.tree.map(np.asarray, tree))[0]}


def _cfgs(arch, **overrides):
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    if overrides:
        jc = dataclasses.replace(jc, **overrides)
        tc = dataclasses.replace(tc, **overrides)
    return jc, tc


def _model(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        jc, tc = _cfgs(arch, **overrides)
        jp = jzoo.init_params(jc, 0)
        _CACHE[key] = (jc, tc, jp)
    jc, tc, jp = _CACHE[key]
    return jc, tc, jp, convert.params_from_numpy(tc, jax.tree.map(
        np.asarray, jp), device="cpu")


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        fr = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    if cfg.family == "vlm":
        pa = rng.normal(size=(B, cfg.frontend_len, cfg.frontend_dim)
                        ).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pa), torch.from_numpy(pa)
    return jb, tb


def _port_grads(tc, tp, tb):
    flat, treedef = tree_flatten_with_path(tp)
    xs = [t.detach().requires_grad_(True) for _, t in flat]
    loss, _ = tzoo.lm_loss(tree_unflatten(treedef, xs), tc, tb)
    gs = torch.autograd.grad(loss, xs)
    return float(loss.detach()), {p: g.float().numpy()
                                  for (p, _), g in zip(flat, gs)}


def _jax_grads(jc, jp, jb):
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jzoo.lm_loss(p, jc, jb)[0]))(jp)
    return float(loss), _flat(g)


def _is_zero_in_exact_math(cfg, path: str) -> bool:
    """The key bias where no rotary embedding turns it with the key's
    position: every key of a query gains the same score."""
    return path.endswith("['bk']") and cfg.pos_embed != "rope"


# ---------------------------------------------------------------------------
# gradients: the port's lm_loss under autograd against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax_grad(arch):
    jc, tc, jp, tp = _model(arch)
    jb, tb = _batch(jc, 2, 24, seed=1)
    jl, jg = _jax_grads(jc, jp, jb)
    tl, tg = _port_grads(tc, tp, tb)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert set(jg) == set(tg)
    top = max(np.abs(g).max() for g in jg.values())
    for p, want in jg.items():
        got = tg[p]
        if _is_zero_in_exact_math(jc, p):
            assert np.abs(got).max() <= ZERO_GRAD_TOL * top, p
            assert np.abs(want).max() <= ZERO_GRAD_TOL * top, p
            continue
        err = np.abs(got - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (p, err)


def test_bf16_gradients_with_fp32_master_match_jax_grad():
    """The dense config in bf16 (params and compute) with fp32 master
    weights: the port's gradients within 4 bf16 ulps of each leaf's
    largest |grad| of the reference's, and of the fp32 gradient of the
    same (bf16-valued) weights; one AdamW step then keeps fp32 masters
    on both sides."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16",
              fp32_master=True)
    jc, tc, jp, tp = _model("qwen2-1.5b", **kw)
    j32 = jget("qwen2-1.5b", smoke=True)
    jb, tb = _batch(jc, 2, 24, seed=1)
    _, jg = _jax_grads(jc, jp, jb)
    _, jg32 = _jax_grads(j32, jax.tree.map(
        lambda a: a.astype(jnp.float32), jp), jb)
    _, tg = _port_grads(tc, tp, tb)
    for p, want in jg.items():
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(tg[p] - want).max() <= BF16_ULPS * ulp, p
        assert np.abs(tg[p] - jg32[p]).max() <= BF16_ULPS * ulp, p
    opt = O.make_optimizer(tc, "adamw", lr=1e-3, total_steps=4, warmup=0)
    st = opt.init(tp)
    assert set(st) == {"m", "v", "master"}
    assert all(t.dtype == torch.float32 for t in tree_leaves(st))
    step = make_train_step(tc, opt)
    tp, st, _, m = step(tp, st, 0, tb)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    assert torch.equal(tp["embed"]["tok"],
                       st["master"]["embed"]["tok"].bfloat16())
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# optimizers: 3 steps on the same gradients
# ---------------------------------------------------------------------------

SHAPES = {"mat": (6, 5), "vec": (5,), "stack": {"w": (2, 3, 4)},
          "layers": [(4, 3), (7,)]}


def _shape_tree(fn, tree=SHAPES):
    if isinstance(tree, dict):
        return {k: _shape_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and not isinstance(tree[0], int):
        return [_shape_tree(fn, v) for v in tree]
    return fn(tuple(tree))


def _optimizers(name):
    jsched = JO.cosine_schedule(5e-2, 1, 5)
    tsched = O.cosine_schedule(5e-2, 1, 5)
    return {
        "adamw": (JO.adamw(jsched), O.adamw(tsched)),
        "adamw_master": (JO.adamw(jsched, fp32_master=True),
                         O.adamw(tsched, fp32_master=True)),
        "lion": (JO.lion(jsched), O.lion(tsched)),
        "adafactor": (JO.adafactor(jsched, weight_decay=0.01),
                      O.adafactor(tsched, weight_decay=0.01)),
        "sgd": (JO.sgd(jsched), O.sgd(tsched)),
        "sgd_nesterov": (JO.sgd(jsched, nesterov=True),
                         O.sgd(tsched, nesterov=True)),
    }[name]


def _close_trees(want, got, what):
    fw, fg = _flat(want), _flat(got)
    assert set(fw) == set(fg), what
    for p, a in fw.items():
        b = fg[p]
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= 2e-6 * scale, (what, p)


@pytest.mark.parametrize("name", ["adamw", "adamw_master", "lion",
                                  "adafactor", "sgd", "sgd_nesterov"])
def test_optimizer_three_steps_match_reference(name):
    jopt, topt = _optimizers(name)
    rng = np.random.default_rng(7)
    p_np = _shape_tree(lambda s: rng.normal(size=s).astype(np.float32))
    dt = jnp.bfloat16 if name == "adamw_master" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, dt), p_np)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if dt == jnp.bfloat16 else torch.float32), p_np)
    js = jopt.init(jp)
    ts = convert.opt_state_from_numpy(topt, tp, jax.tree.map(np.asarray, js),
                                      device="cpu")
    for step in range(3):
        g = _shape_tree(lambda s: rng.normal(size=s).astype(np.float32))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(step))
        tp, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp,
                             step)
    if name in ("adamw_master", "lion"):   # bf16 params or bf16 moments
        fw, fg = _flat(jp), _flat(tp)
        for p, a in fw.items():
            ulp = 2.0 ** (np.floor(np.log2(np.abs(a) + 1e-30)) - 7)
            assert (np.abs(a - fg[p]) <= ulp).all(), p
        if name == "adamw_master":
            _close_trees(js, ts, "state")
        else:
            fw, fg = _flat(js), _flat(ts)
            for p, a in fw.items():
                ulp = 2.0 ** (np.floor(np.log2(np.abs(a) + 1e-30)) - 7)
                assert (np.abs(a - fg[p]) <= ulp).all(), p
    else:
        _close_trees(jp, tp, "params")
        _close_trees(js, ts, "state")


def test_schedules_match_reference_in_fp32():
    js, ts = JO.cosine_schedule(3e-4, 7, 50), O.cosine_schedule(3e-4, 7, 50)
    for step in range(0, 60, 3):
        a = np.float32(js(jnp.asarray(step)))
        b = ts(torch.tensor(step))
        assert b.dtype == torch.float32
        assert abs(float(b) - float(a)) <= 1e-7 * abs(float(a)), step
    assert float(O.constant_schedule(0.25)(3)) == 0.25


# ---------------------------------------------------------------------------
# make_train_step: 3 steps against the reference's
# ---------------------------------------------------------------------------

STEP_CASES = {
    # (arch, optimizer, microbatches, grad_compression)
    "dense_adamw_mb1": ("qwen2-1.5b", "adamw", 1, None),
    "dense_adamw_mb2": ("qwen2-1.5b", "adamw", 2, None),
    "dense_sgd_int8": ("qwen2-1.5b", "sgd", 1, "int8"),
    "rwkv_adamw_mb2": ("rwkv6-1.6b", "adamw", 2, None),
    "encdec_adamw_mb1": ("seamless-m4t-medium", "adamw", 1, None),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_three_steps_match_reference(case):
    arch, opt_name, mb, comp = STEP_CASES[case]
    jc, tc, jp, tp = _model(arch)
    # the cosine schedule: warm-up over the first step, then the decay
    jopt = JO.make_optimizer(jc, opt_name, lr=LR, total_steps=4, warmup=1)
    topt = O.make_optimizer(tc, opt_name, lr=LR, total_steps=4, warmup=1)
    js = jopt.init(jp)
    ts = convert.opt_state_from_numpy(topt, tp, jax.tree.map(np.asarray, js),
                                      device="cpu")
    jstep = jax.jit(j_make_train_step(jc, jopt, microbatches=mb,
                                      grad_compression=comp))
    tstep = make_train_step(tc, topt, microbatches=mb, grad_compression=comp)
    jn, tn = jnp.asarray(0), convert.step_from_numpy(0, device="cpu")
    for i in range(3):
        jb, tb = _batch(jc, 4, 16, seed=10 + i)
        jp, js, jn, jm = jstep(jp, js, jn, jb)
        tp, ts, tn, tm = tstep(tp, ts, tn, tb)
        for k in ("loss", "grad_norm"):
            assert tm[k].dtype == torch.float32
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=STEP_TOL)
    assert int(tn) == int(jn) == 3
    for what, want, got in (("params", jp, tp), ("state", js, ts)):
        fw, fg = _flat(want), _flat(got)
        top = max(np.abs(a).max() for a in fw.values())
        for p, a in fw.items():
            b = fg[p]
            if _is_zero_in_exact_math(jc, p):
                # rounding noise on both sides: each held to its bound
                bound = 3 * LR if what == "params" else ZERO_GRAD_TOL * top
                assert max(np.abs(a).max(), np.abs(b).max()) <= bound, p
                continue
            tol = STEP_TOL * np.abs(a).max() + (
                NEAR_ZERO_MOVE * LR if what == "params" else 0.0)
            assert np.abs(a - b).max() <= tol, (what, p)


# ---------------------------------------------------------------------------
# mirrors of tests/test_optim.py
# ---------------------------------------------------------------------------

def _quadratic_losses(opt, steps=200, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(rng.normal(size=(dim,)).astype(np.float32))
    params = {"w": torch.zeros((dim,))}
    state = opt.init(params)
    losses = []
    for step in range(steps):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(torch.square(w - target)), w)
        params, state = opt.update({"w": g}, state, params, step)
        losses.append(float(torch.sum(torch.square(params["w"] - target))))
    return losses


@pytest.mark.parametrize("name,opt", [
    ("adamw", O.adamw(1e-1, weight_decay=0.0)),
    ("lion", O.lion(3e-2, weight_decay=0.0)),
    ("adafactor", O.adafactor(1e-1)),
    ("sgd", O.sgd(5e-2)),
])
def test_optimizer_converges_on_quadratic(name, opt):
    losses = _quadratic_losses(opt)
    tol = 0.15 if name == "lion" else 0.05   # sign updates plateau in an lr-ball
    assert losses[-1] < losses[0] * tol, f"{name}: {losses[-1]} vs {losses[0]}"


def test_adamw_first_step_matches_hand_math():
    opt = O.adamw(0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0)
    params = {"w": torch.tensor([1.0])}
    state = opt.init(params)
    new_p, _ = opt.update({"w": torch.tensor([0.5])}, state, params, 0)
    # bias-corrected mhat = g, vhat = g^2 -> step = lr * g/|g| = lr
    np.testing.assert_allclose(new_p["w"].numpy(), [1.0 - 0.1], rtol=1e-4)


def test_adamw_fp32_master_keeps_precision_with_bf16_params():
    opt = O.adamw(1e-3, weight_decay=0.0, fp32_master=True)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    p, s = params, state
    for i in range(10):
        p, s = opt.update(g, s, p, i)
    # master accumulated updates far below bf16 resolution of 1.0
    assert float(s["master"]["w"][0]) < 1.0 - 5e-3
    assert p["w"].dtype == torch.bfloat16


def test_adafactor_memory_is_sublinear():
    st = O.adafactor(1e-2).init({"w": torch.zeros((64, 128))})
    assert sum(t.numel() for t in tree_leaves(st)) == 64 + 128


def test_state_axes_tree_matches_state_structure():
    params = {"a": torch.zeros((4, 8)), "b": torch.zeros((8,))}
    axes = {"a": ("embed", "ff"), "b": ("ff",)}
    for opt in [O.adamw(1e-3, fp32_master=True), O.lion(1e-3),
                O.adafactor(1e-3), O.sgd(1e-3)]:
        st = opt.init(params)
        ax = opt.state_axes(axes)
        # an axes tuple above each state leaf, the same tree above it
        paths = [p for p, _ in tree_flatten_with_path(st)[0]]
        for p in paths:
            node = ax
            for key in p.strip("[]").split("]["):
                if isinstance(node, tuple):
                    break
                node = node[key.strip("'")]
            assert isinstance(node, tuple), (opt, p)


def test_grad_accum_equivalence():
    """M microbatches must match a single full-batch step (linear loss)."""
    cfg = tget("qwen2-1.5b", smoke=True)
    opt = O.sgd(1e-2, momentum=0.0)

    def loss_fn(p, b):
        emb = p["embed"]["tok"]
        idx = b["tokens"].reshape(-1).long()
        return torch.mean(torch.square(emb[idx].sum(-1))), {}

    params = tzoo.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    out = []
    for m in (1, 4):
        p = tree_map(torch.clone, params)
        s1 = make_train_step(cfg, opt, loss_fn=loss_fn, microbatches=m)
        p, *_ = s1(p, opt.init(p), 0, {"tokens": tokens})
        out.append(p["embed"]["tok"])
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=2e-4,
                               atol=2e-5)


def test_global_norm_and_clip():
    tree = {"a": torch.tensor([3.0]), "b": [torch.tensor([4.0])]}
    assert float(global_norm(tree)) == 5.0
    clipped, n = clip_by_global_norm(tree, 1.0)
    assert float(n) == 5.0
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------------------------
# tests/test_dist.py:257 (int8 gradient compression), on the port
# ---------------------------------------------------------------------------

def test_train_step_int8_grad_compression():
    cfg = tget("qwen2-1.5b", smoke=True)
    opt = O.make_optimizer(cfg, "sgd", lr=lambda step: 0.1)  # no warmup
    params = {"w": torch.ones((4,))}

    def loss_fn(p, b):
        return torch.sum(torch.square(p["w"] - b["x"])), {}

    ts = make_train_step(cfg, opt, loss_fn=loss_fn, microbatches=1,
                         grad_compression="int8")
    new_p, *_ = ts(params, opt.init(params), 0, {"x": torch.zeros((4,))})
    # grads survive the int8 wire well enough to descend
    assert float(torch.max(new_p["w"])) < 1.0
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(cfg, opt, grad_compression="zfp")


# ---------------------------------------------------------------------------
# tests/test_smoke_archs.py:40, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step(arch):
    cfg = tget(arch, smoke=True)
    params = tzoo.init_params(cfg, seed=1, device="cpu")
    _, batch = _batch(cfg, 2, 16, seed=1)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = tzoo.lm_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss)
    with torch.no_grad():
        new = [p - 1e-3 * g for p, g in zip(leaves, grads)]
    it = iter(new)
    loss2, _ = tzoo.lm_loss(tree_map(lambda _: next(it), params), cfg, batch)
    assert torch.isfinite(loss2)
    gnorm = sum(float(torch.sum(torch.square(g))) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0.0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    """``cfg.remat`` changes what the backward saves, not what it
    computes: every policy's gradients are bitwise ``"none"``'s."""
    jc, tc, _, tp = _model("qwen2-1.5b")
    _, tb = _batch(jc, 2, 16, seed=3)
    _, want = _port_grads(tc, tp, tb)
    _, got = _port_grads(dataclasses.replace(tc, remat=remat), tp, tb)
    for p, a in want.items():
        assert np.array_equal(a, got[p]), p


def test_stack_backward_stacks_once_a_leaf():
    """The stack's layers are taken by one ``unbind`` a leaf: the
    backward of a stacked leaf is one ``stack``, not a zero tensor the
    size of the stack for every layer."""
    cfg = dataclasses.replace(tget("qwen2-1.5b", smoke=True), remat="none")
    params = tzoo.init_params(cfg, seed=0, device="cpu")
    w = params["stack"][0]["mlp"]["w_up"].requires_grad_(True)
    _, tb = _batch(cfg, 1, 8, seed=0)
    loss, _ = tzoo.lm_loss(params, cfg, tb)
    seen, todo, readers = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is not None and getattr(nxt, "variable", None) is w:
                readers.append(type(fn).__name__)
            todo.append(nxt)
    assert readers == ["UnbindBackward0"]
    (g,) = torch.autograd.grad(loss, w)
    assert g.shape == w.shape


# ---------------------------------------------------------------------------
# tests/test_dl_ops.py:115,145,165 on the port
# ---------------------------------------------------------------------------

def test_train_op_bitwise_vs_standalone():
    cfg = tget("qwen2-1.5b", smoke=True)
    opt = O.adamw(1e-3)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))
    step_fn = make_train_step(cfg, opt, impl="chunked", clip_norm=1.0)
    p = tzoo.init_params(cfg, 0, device="cpu")
    o, s = opt.init(p), torch.zeros((), dtype=torch.int32)
    ref_losses = []
    for _ in range(2):
        p, o, s, m = step_fn(p, o, s, {"tokens": tokens})
        ref_losses.append(m["loss"])

    op = dl_train_op(cfg, opt, batch_size=2, seq_len=16, device="cpu")
    g = OpGraph([op])
    states = g.init_states("cpu")
    batch = {"tokens": tokens, "rng": torch.tensor(0)}
    for i in range(2):
        states, out = g.run(states, batch, frozenset())
        assert torch.equal(ref_losses[i], out["loss"])
    pw, ow, sw = states[op.name]
    for a, b in zip(tree_leaves((p, o)), tree_leaves((pw, ow))):
        assert torch.equal(a, b)
    assert int(sw) == 2 and sw.dtype == torch.int32


def test_dl_operator_cost_roofline_rules():
    cfg = tget("qwen2-1.5b", smoke=True)
    n = cfg.param_counts()["active"]
    pb = param_bytes(cfg)
    tr = dl_operator_cost("t", cfg, phase="train", batch=4, seq_len=64,
                          param_bytes=pb)
    assert tr.flops_per_event == pytest.approx(6.0 * n * 64)
    assert tr.bytes_per_event == pytest.approx(3.0 * pb / 4)
    op = dl_train_op(cfg, O.adamw(1e-3), batch_size=4, seq_len=64,
                     device="cpu")
    assert op.cost.flops_per_event == pytest.approx(6.0 * n * 64)
    assert op.cost.state_bytes == train_state_bytes(cfg, O.adamw(1e-3))
    assert not op.cost.edge_capable and not op.cost.downlink_ok
    assert op.reads == ("tokens",) and op.writes == ("loss", "grad_norm")
    with pytest.raises(ValueError):
        dl_operator_cost("x", cfg, phase="nope", batch=1, seq_len=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_bytes_counts_params_and_moments(arch):
    jc, tc = _cfgs(arch)
    sb = train_state_bytes(tc, O.adamw(1e-3))
    assert sb >= 2 * param_bytes(tc)
    assert sb == j_train_state_bytes(jc, JO.adamw(1e-3))
    # the full config, from meta tensors: bf16 params, an fp32 master
    # where the config keeps one, m and v in its optimizer-state dtype
    full = tget(arch)
    moment = 4 if full.opt_state_dtype == "float32" else 2
    master = 4 if full.fp32_master else 0
    assert train_state_bytes(full, O.make_optimizer(full)) == \
        (2 + master + 2 * moment) * tzoo.param_count(full)


# ---------------------------------------------------------------------------
# optimizer state carried across from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw_master", "lion", "adafactor"])
def test_opt_state_from_numpy_continues_the_reference(name):
    """Both packages take 2 steps from the same start on their own, the
    port's state is replaced by the reference's (converted), and one
    more step on each lands the same."""
    jopt, topt = _optimizers(name)
    rng = np.random.default_rng(3)
    p_np = _shape_tree(lambda s: rng.normal(size=s).astype(np.float32))
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init(jp)
    gs = [_shape_tree(lambda s: rng.normal(size=s).astype(np.float32))
          for _ in range(3)]
    for i in range(2):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, gs[i]), js, jp,
                             jnp.asarray(i))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                      _np(jp))
    ts = convert.opt_state_from_numpy(topt, tp, jax.tree.map(np.asarray, js),
                                      device="cpu")
    want_dtypes = [t.dtype for t in tree_leaves(topt.init(tp))]
    assert [t.dtype for t in tree_leaves(ts)] == want_dtypes
    step = convert.step_from_numpy(jnp.asarray(2), device="cpu")
    assert step.dtype == torch.int32 and int(step) == 2
    jp, js = jopt.update(jax.tree.map(jnp.asarray, gs[2]), js, jp,
                         jnp.asarray(2))
    tp, ts = topt.update(jax.tree.map(torch.from_numpy, gs[2]), ts, tp, step)
    fw, fg = _flat(jp), _flat(tp)
    for p, a in fw.items():
        assert np.abs(a - fg[p]).max() <= 2e-6 * np.abs(a).max(), p


def test_opt_state_from_numpy_raises_on_a_bad_tree():
    opt = O.adamw(1e-3)
    params = {"w": torch.zeros((3, 2))}
    good = {"m": {"w": np.zeros((3, 2), np.float32)},
            "v": {"w": np.zeros((3, 2), np.float32)}}
    convert.opt_state_from_numpy(opt, params, good, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.opt_state_from_numpy(opt, params, {"m": good["m"]},
                                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.opt_state_from_numpy(
            opt, params, {**good, "v": {"w": np.zeros(6, np.float32)}},
            device="cpu")


# ---------------------------------------------------------------------------
# the slice as a whole: examples/train_stream_lm.py's loop on both packages
# ---------------------------------------------------------------------------

STREAM_STEPS, STREAM_B, STREAM_S, CKPT_AT = 12, 4, 32, 6


def _stream_loop_jax(jc, jp):
    gen = JTokenStream(vocab_size=jc.vocab_size, seq_len=STREAM_S,
                       drift=JDriftSpec("abrupt", at=0.5),
                       horizon=float(STREAM_STEPS * STREAM_B * STREAM_S))
    opt = JO.make_optimizer(jc, "adamw", lr=3e-3, total_steps=STREAM_STEPS,
                            warmup=2)
    step_fn = jax.jit(j_make_train_step(jc, opt, microbatches=1,
                                        clip_norm=1.0))
    params, state, step = jp, opt.init(jp), jnp.asarray(0)
    ph, losses, levels = jdrift.ph_init(), [], []
    for i in range(STREAM_STEPS):
        batch = {"tokens": jnp.asarray(gen.batch(i, STREAM_B).data["tokens"])}
        params, state, step, m = step_fn(params, state, step, batch)
        losses.append(float(m["loss"]))
        ph, level = jdrift.ph_step(ph, jnp.asarray(m["loss"]))
        levels.append(int(level))
    return losses, levels, state


def _stream_loop_port(tc, tp, ts, start=0, stop=STREAM_STEPS, saver=None):
    gen = TokenStream(vocab_size=tc.vocab_size, seq_len=STREAM_S,
                      drift=DriftSpec("abrupt", at=0.5),
                      horizon=float(STREAM_STEPS * STREAM_B * STREAM_S))
    opt = O.make_optimizer(tc, "adamw", lr=3e-3, total_steps=STREAM_STEPS,
                           warmup=2)
    step_fn = make_train_step(tc, opt, microbatches=1, clip_norm=1.0)
    if ts is None:
        ts = opt.init(tp)
    step = torch.tensor(start, dtype=torch.int32)
    ph, losses, levels = tdrift.ph_init(), [], []
    for i in range(start, stop):
        batch = {"tokens": torch.from_numpy(
            gen.batch(i, STREAM_B).data["tokens"])}
        tp, ts, step, m = step_fn(tp, ts, step, batch)
        losses.append(float(m["loss"]))
        ph, level = tdrift.ph_step(ph, m["loss"])
        levels.append(int(level))
        if saver is not None and i + 1 == CKPT_AT:
            saver.save(int(step), {"params": tp, "opt": ts})
            # the optimizer overwrites the tensors right after save returns
    return losses, levels, tp, ts


def test_stream_lm_loop_matches_reference_and_resumes_bitwise(tmp_path):
    jc, tc, jp, tp = _model("qwen2-1.5b")
    jl, jlev, jstate = _stream_loop_jax(jc, jp)
    with tckpt.AsyncCheckpointer(tmp_path) as saver:
        tl, tlev, tp_end, ts_end = _stream_loop_port(tc, tp, None,
                                                     saver=saver)
        saver.wait()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tlev == jlev
    assert all(np.isfinite(tl)) and np.mean(tl[-3:]) < np.mean(tl[:3])
    # resume from the async checkpoint into fresh state, run on to the end
    *_, fresh = _model("qwen2-1.5b")
    opt = O.make_optimizer(tc, "adamw", lr=3e-3, total_steps=STREAM_STEPS,
                           warmup=2)
    like = {"params": fresh, "opt": opt.init(fresh)}
    tree, meta = tckpt.restore(tmp_path, like)
    assert meta["step"] == CKPT_AT == tckpt.latest_step(tmp_path)
    rl, _, rp, rs = _stream_loop_port(tc, tree["params"], tree["opt"],
                                      start=CKPT_AT)
    assert rl == tl[CKPT_AT:]
    for a, b in zip(tree_leaves((tp_end, ts_end)), tree_leaves((rp, rs))):
        assert torch.equal(a, b)
