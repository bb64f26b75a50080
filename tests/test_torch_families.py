"""The model families of the port's last serving slice (MoE, MLA,
Mamba/ssm, hybrid, vision) against the JAX package, on the CPU.

Inputs are numpy draws from a seed handed to both packages; the port's
weights are the JAX package's, converted leaf for leaf
(``convert.params_from_numpy``). The vision family's gates
(``gate_attn``, ``gate_mlp``) start at zero, which multiplies its
cross-attention layer's output by 0: they are set non-zero in the numpy
tree before both packages take it, and its patches are drawn, so that a
wrong cross-attention shows. The smoke configurations are fp32.
Tolerances: logits and caches rtol = atol = 1e-4 (other summation
orders, XLA's contracted multiply-adds); a Mamba layer's output and
state 1e-5; MoE routing integers (expert ids, destination slots, keep
masks) bitwise, except at a token whose K-th and (K+1)-th router
probabilities lie within 1e-6 of each other, where fp32 rounding may
order them differently: such a token is reported and left out of the
logits comparison. Gradients within 1e-4 of each leaf's largest |grad|,
as ``tests/test_torch_train.py`` holds them. Where the JAX side reaches
a Pallas kernel it runs in interpret mode.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.serve import engine as jengine

from repro_torch import convert
from repro_torch._tree import tree_flatten_with_path, tree_map, tree_unflatten
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as tengine

ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b", "llama-3.2-vision-90b")
SSM = "jamba-ssm"          # jamba's smoke config with family="ssm"
ALL = ARCHS + (SSM,)
TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
NEAR_TIE = 1e-6
GATES = {"gate_attn": 0.7, "gate_mlp": -0.45}
_CACHE = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")


def _cfgs(arch, **over):
    name = "jamba-1.5-large-398b" if arch == SSM else arch
    jc, tc = jget(name, smoke=True), tget(name, smoke=True)
    if arch == SSM:
        over = {"family": "ssm", **over}
    if over:
        jc, tc = (dataclasses.replace(c, **over) for c in (jc, tc))
    return jc, tc


def _set_gates(tree):
    """The vision gates set to ``GATES`` (each layer's its own value)."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATES[k]) + 0.1 * np.arange(
            v.size, dtype=v.dtype).reshape(v.shape)
                    if k in GATES else _set_gates(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_set_gates(v) for v in tree]
    return tree


def _model(arch, **over):
    """Both configs (with ``over``) and both packages' parameters, drawn
    once an architecture (no override changes the parameter tree)."""
    if arch not in _CACHE:
        jc, tc = _cfgs(arch)
        np_tree = _set_gates(_np(jax.jit(jzoo.init_params, static_argnums=(
            0, 1))(jc, 0)))
        jp = jax.tree.map(jnp.asarray, np_tree)
        tp = convert.params_from_numpy(tc, np_tree, device="cpu")
        _CACHE[arch] = (jp, tp)
    jc, tc = _cfgs(arch, **over)
    return (jc, tc) + _CACHE[arch]


# the reference's entry points, compiled once a configuration
_jforward = jax.jit(jzoo.forward_lm, static_argnums=(1,),
                    static_argnames=("impl",))
_jprefill = jax.jit(jzoo.prefill, static_argnums=(1, 3),
                    static_argnames=("impl",))
_jdecode = jax.jit(jzoo.decode_step, static_argnums=(1,),
                   static_argnames=("impl",))


def _batches(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.family == "vlm":
        pa = rng.normal(size=(B, cfg.frontend_len, cfg.frontend_dim)
                        ).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pa), _t(pa)
    return jb, tb


class NearTies:
    """Records, at every MoE layer the port runs, the tokens whose K-th
    and (K+1)-th router probabilities lie within ``NEAR_TIE``."""

    def __init__(self, monkeypatch):
        self.tokens = set()
        top_k = tmoe.top_k

        def recording(probs, k):
            vals, idx = top_k(probs, k)
            if probs.shape[-1] > k:
                srt = torch.sort(probs, dim=-1, descending=True).values
                gap = (srt[..., k - 1] - srt[..., k]).reshape(-1)
                self.tokens |= set(torch.nonzero(gap <= NEAR_TIE)
                                   .reshape(-1).tolist())
            return vals, idx
        monkeypatch.setattr(tmoe, "top_k", recording)

    def keep_rows(self, B, S):
        """A (B, S) mask of the positions to compare; logs the near
        ties it leaves out."""
        keep = np.ones((B * S,), bool)
        if self.tokens:
            print(f"near-tie tokens left out of the comparison: "
                  f"{sorted(self.tokens)}")
            keep[sorted(self.tokens)] = False
        return keep.reshape(B, S)


# ---------------------------------------------------------------------------
# MoE: apply_moe and its routing integers
# ---------------------------------------------------------------------------

def _moe_case(arch, cf, seed, B=2, S=32):
    jc, tc, jp, _ = _model(arch, moe=dataclasses.replace(
        jget(arch, smoke=True).moe, capacity_factor=cf))
    p_np = _np(jp)
    moe_np = next(sl["mlp"] for sl in p_np["prefix"] + [
        jax.tree.map(lambda a: a[0], st) for st in p_np["stack"]]
        if "router" in sl.get("mlp", {}))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    return jc, tc, moe_np, x


@functools.partial(jax.jit, static_argnums=(0,))
def _jrouting(jc, router, xf):
    probs = jax.nn.softmax((xf @ router).astype(jnp.float32), axis=-1)
    gv, ids = jax.lax.top_k(probs, jc.moe.top_k)
    C = jmoe._capacity(jc, xf.shape[0])
    _, dest, _, keep = jmoe._dispatch_group(jc, C, xf, ids, gv)
    return probs, ids, dest, keep


def _reference_routing(jc, p, x):
    xf = jnp.asarray(x.reshape(x.shape[0] * x.shape[1], -1))
    return tuple(np.asarray(a) for a in _jrouting(jc, jnp.asarray(
        p["router"]), xf))


_japply_moe = jax.jit(jmoe.apply_moe, static_argnums=(1,))


def _port_routing(tc, p, x):
    """The port's routing integers on ``x``: expert ids, destination
    slots and keep masks of ``apply_moe``'s one group."""
    t = x.shape[0] * x.shape[1]
    xf = _t(x).reshape(t, -1)
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    _, ids = tmoe.top_k(probs, tc.moe.top_k)
    _, dest, _, keep = tmoe._dispatch_group(tc, tmoe._capacity(tc, t), xf,
                                            ids)
    return ids, dest, keep


def _near_ties(probs, K):
    srt = -np.sort(-probs, axis=-1)
    return np.nonzero(srt[:, K - 1] - srt[:, K] <= NEAR_TIE)[0]


@pytest.mark.parametrize("arch,cf", [
    ("granite-moe-1b-a400m", 2.0),
    ("deepseek-v2-lite-16b", 2.0),     # shared experts
    ("jamba-1.5-large-398b", 2.0),
    ("granite-moe-1b-a400m", 0.5),     # capacity overflows: drops
])
def test_apply_moe_matches_the_reference(arch, cf):
    jc, tc, p_np, x = _moe_case(arch, cf, seed=3)
    want_y, want_aux = _japply_moe(jax.tree.map(jnp.asarray, p_np), jc,
                                   jnp.asarray(x))
    tp = jax.tree.map(_t, p_np)
    got_y, got_aux = tmoe.apply_moe(tp, tc, _t(x))
    probs, ids, dest, keep = _reference_routing(jc, p_np, x)
    tids, tdest, tkeep = _port_routing(tc, tp, x)
    ties = _near_ties(probs, jc.moe.top_k)
    print(f"{arch} cf={cf}: near-tie tokens {ties.tolist()}")
    if ties.size == 0:
        np.testing.assert_array_equal(tids.numpy(), ids)
        np.testing.assert_array_equal(tdest.numpy(), dest)
        np.testing.assert_array_equal(tkeep.numpy(), keep)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    else:
        rows = np.setdiff1d(np.arange(ids.shape[0]), ties)
        np.testing.assert_array_equal(tids.numpy()[rows], ids[rows])
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5)
    if cf < 1.0:
        assert not keep.all()             # the case drops assignments


def test_router_ties_go_to_the_lower_expert():
    """Two experts with the same router column tie exactly on every
    token; ``lax.top_k`` keeps the lower index, and so must the port."""
    jc, tc, p_np, x = _moe_case("granite-moe-1b-a400m", 2.0, seed=5)
    E = jc.moe.num_experts
    p_np["router"][:, E - 1] = p_np["router"][:, 1]
    probs, ids, dest, keep = _reference_routing(jc, p_np, x)
    assert (probs[:, 1] == probs[:, E - 1]).all()
    tied = np.isin(ids, [1, E - 1]).sum(-1) == 1
    assert tied.any()                     # the tie decides some tokens
    assert not (ids == E - 1)[tied].any()
    tp = jax.tree.map(_t, p_np)
    tids, tdest, tkeep = _port_routing(tc, tp, x)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_array_equal(tdest.numpy(), dest)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    want_y, _ = _japply_moe(jax.tree.map(jnp.asarray, p_np), jc,
                            jnp.asarray(x))
    got_y, _ = tmoe.apply_moe(tp, tc, _t(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)


def test_router_jitter_draws_from_the_callers_generator():
    jc, tc, p_np, x = _moe_case("granite-moe-1b-a400m", 2.0, seed=6)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         router_jitter=0.5))
    tp = jax.tree.map(_t, p_np)
    plain, _ = tmoe.apply_moe(tp, tc, _t(x))
    a, _ = tmoe.apply_moe(tp, tc, _t(x), torch.Generator().manual_seed(1))
    b, _ = tmoe.apply_moe(tp, tc, _t(x), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, plain)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_mla_attention_matches_the_reference(cached):
    jc, tc, jp, tp = _model("deepseek-v2-lite-16b")
    jm, tm = jp["prefix"][0]["mixer"], tp["prefix"][0]["mixer"]
    rng = np.random.default_rng(11)
    B, S, T, start = 2, 3, 12, 5
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S)[None] + (start if cached else 0)
    jcache = tcache = None
    if cached:
        m = jc.mla
        cache_np = jattn.MLACache(
            rng.normal(size=(B, T, m.kv_lora_rank)).astype(np.float32),
            rng.normal(size=(B, T, m.rope_head_dim)).astype(np.float32),
            np.asarray(start, np.int32))
        jcache = jax.tree.map(jnp.asarray, cache_np)
        tcache = convert.cache_from_numpy(
            tattn.init_mla_cache(tc, B, T, torch.float32, "meta"), cache_np,
            device="cpu")
        assert tcache.length.device.type == "cpu"
    want, wc = jattn.mla_attention(jm, jc, jnp.asarray(x),
                                   positions=jnp.asarray(pos), cache=jcache)
    got, gc = tattn.mla_attention(tm, tc, _t(x), positions=_t(pos),
                                  cache=tcache, impl="kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cached:
        for a, b in zip(gc, wc):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
        assert gc.c_kv is tcache.c_kv        # written in place


def test_flash_gate_refuses_mla_where_the_reference_crashes(interpret):
    """Fault 15: the reference's gate compares q's head dim with k's
    only, so MLA's uncached forward (keys nope + rope wide, values
    ``v_head_dim``) reaches its flash kernel under ``impl="pallas"``,
    which then reshapes v with k's dim and raises. The port's gate also
    compares v's: ``impl="kernel"`` takes the chunked path and equals
    the reference's ``impl="chunked"``."""
    jc, tc, jp, tp = _model("deepseek-v2-lite-16b")
    jb, tb = _batches(jc, 2, 16, seed=1)
    with pytest.raises(TypeError, match="reshape"):
        _jforward(jp, jc, jb, impl="pallas")
    q = torch.zeros(1, 2, 2, 24)
    assert not kops.flash_supported(q, q, torch.zeros(1, 2, 2, 16), False,
                                    0, None)
    kops.reset_launch_counts()
    calls = []
    real = kops.flash_attention
    kops.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got, _ = tzoo.forward_lm(tp, tc, tb, impl="kernel")
    finally:
        kops.flash_attention = real
    assert calls == []
    want, _ = _jforward(jp, jc, jb, impl="chunked")
    real_v = slice(0, jc.vocab_size)
    np.testing.assert_allclose(got.numpy()[..., real_v],
                               np.asarray(want)[..., real_v], **TOL)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_layer():
    jc, tc, jp, tp = _model("jamba-1.5-large-398b")
    jm = jax.tree.map(lambda a: a[0], jp["stack"][0]["mixer"])
    tm = {k: v[0] for k, v in tp["stack"][0]["mixer"].items()}
    return jc, tc, jm, tm


def _mamba_state(cfg, rng, B):
    m = cfg.mamba
    return jssm.MambaState(
        rng.normal(size=(B, m.d_conv - 1, cfg.d_inner_mamba)
                   ).astype(np.float32),
        rng.normal(size=(B, cfg.d_inner_mamba, m.d_state)
                   ).astype(np.float32))


# S = 32: two chunks of 16; S = 13: the single-chunk fallback
@pytest.mark.parametrize("S", [32, 13])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_mixer_matches_the_reference(S, with_state):
    jc, tc, jm, tm = _mamba_layer()
    rng = np.random.default_rng(S)
    B = 2
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    st_np = _mamba_state(jc, rng, B) if with_state else None
    jst = jax.tree.map(jnp.asarray, st_np) if with_state else None
    tst = (convert.cache_from_numpy(tssm.init_mamba_state(tc, B, "meta"),
                                    st_np, device="cpu")
           if with_state else None)
    want, wst = jssm.mamba_mixer(jm, jc, jnp.asarray(x), jst)
    got, gst = tssm.mamba_mixer(tm, tc, _t(x), tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MAMBA_TOL)
    for a, b in zip(gst, wst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MAMBA_TOL)
    if with_state:
        assert gst.h is tst.h and gst.conv is tst.conv     # in place


def test_mamba_decode_step_matches_the_reference():
    jc, tc, jm, tm = _mamba_layer()
    rng = np.random.default_rng(21)
    B = 3
    st_np = _mamba_state(jc, rng, B)
    jst = jax.tree.map(jnp.asarray, st_np)
    tst = convert.cache_from_numpy(tssm.init_mamba_state(tc, B, "meta"),
                                   st_np, device="cpu")
    for step in range(3):
        x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
        want, jst = jssm.mamba_decode_step(jm, jc, jnp.asarray(x), jst)
        got, tst2 = tssm.mamba_decode_step(tm, tc, _t(x), tst)
        assert tst2.h is tst.h
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MAMBA_TOL)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **MAMBA_TOL)


def test_ssm_chunk_scan_never_divides():
    """Decays that underflow a prefix product (a ~ 1e-30 a step) leave
    the doubling scan finite and equal to the per-step recurrence."""
    rng = np.random.default_rng(2)
    a = np.full((1, 16, 3, 2), 1e-30, np.float32)
    a[:, ::5] = 0.9
    b = rng.normal(size=a.shape).astype(np.float32)
    h0 = rng.normal(size=(1, 3, 2)).astype(np.float32)
    h_all, h_last = tssm._ssm_chunk(_t(a), _t(b), _t(h0))
    h, want = h0, []
    for t in range(16):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(h_all.numpy(), np.stack(want, 1), rtol=1e-6,
                               atol=1e-6)
    assert torch.isfinite(h_last).all()


# ---------------------------------------------------------------------------
# whole models: forward, loss, prefill + decode, serving, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_forward_and_loss_match_the_reference(arch, interpret, monkeypatch):
    jc, tc, jp, tp = _model(arch)
    B, S = 2, 16
    jb, tb = _batches(jc, B, S, seed=1)
    real = slice(0, jc.vocab_size)
    # the reference's pallas path crashes on MLA (fault 15): its chunked
    # path is the function both mean
    jimpl = "chunked" if jc.mla is not None else "pallas"
    ties = NearTies(monkeypatch)
    for ji, ti in (("chunked", "chunked"), (jimpl, "kernel")):
        want, want_aux = _jforward(jp, jc, jb, impl=ji)
        got, got_aux = tzoo.forward_lm(tp, tc, tb, impl=ti)
        keep = ties.keep_rows(B, S)
        np.testing.assert_allclose(got.numpy()[keep][..., real],
                                   np.asarray(want)[keep][..., real], **TOL)
        assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5,
                                               abs=1e-7)
    want_l, want_m = jax.jit(jzoo.lm_loss, static_argnums=(1,))(jp, jc, jb)
    got_l, got_m = tzoo.lm_loss(tp, tc, tb)
    assert float(got_l) == pytest.approx(float(want_l), rel=1e-5)
    assert float(got_m["aux"]) == pytest.approx(float(want_m["aux"]),
                                                rel=1e-5, abs=1e-7)
    assert (float(got_m["aux"]) > 0) == bool(jc.moe.num_experts)


def _flat(tree):
    """``{path: float32 numpy}`` of a port or a JAX cache tree."""
    if not isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = _np(tree)
    return {p: np.asarray(v, np.float32) for p, v in
            tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ALL)
def test_prefill_and_decode_steps_match_the_reference(arch, interpret,
                                                      monkeypatch):
    """Logits of a prefill and 3 decode steps, and every cache leaf after
    each. The caches are held in fp32 here (``kv_cache_dtype``), where
    1e-4 is a meaningful bound; the bf16 caches are served to equal
    greedy tokens below. The reference's last cache, carried across by
    ``convert.cache_from_numpy``, has the port's structure."""
    jc, tc, jp, tp = _model(arch, kv_cache_dtype="float32")
    B, S, steps = 2, 12, 3
    jb, tb = _batches(jc, B, S + steps, seed=4)
    prompt = lambda b: {**b, "tokens": b["tokens"][:, :S]}   # noqa: E731
    ties = NearTies(monkeypatch)
    jl, jcache = _jprefill(jp, jc, prompt(jb), S + steps + 1, impl="pallas")
    tl, tcache = tzoo.prefill(tp, tc, prompt(tb), max_len=S + steps + 1,
                              impl="kernel")
    real = slice(0, jc.vocab_size)
    for i in range(steps + 1):
        if i:
            tok = jb["tokens"][:, S + i - 1:S + i]
            jl, jcache = _jdecode(jp, jc, jcache, tok, impl="pallas")
            tl, tcache = tzoo.decode_step(tp, tc, tcache, _t(tok),
                                          impl="kernel")
        assert not ties.tokens, f"near ties {sorted(ties.tokens)}"
        np.testing.assert_allclose(tl.numpy()[..., real],
                                   np.asarray(jl)[..., real], **TOL)
        want, got = _flat(jcache), _flat(tcache)
        assert set(want) == set(got)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, **TOL, err_msg=path)
    assert int(tzoo._cache_length(tcache)) == int(
        jzoo._cache_length(jcache)) == (0 if tc.family == "ssm"
                                        else S + steps)
    carried = convert.cache_from_numpy(tcache, _np(jcache), device="cpu")
    for path, w in _flat(carried).items():
        np.testing.assert_array_equal(w, want[path], err_msg=path)
    assert all(c.length.device.type == "cpu" for c in jax.tree.leaves(
        carried, is_leaf=lambda c: isinstance(
            c, (tattn.KVCache, tattn.MLACache))) if hasattr(c, "length"))


def _prompts(vocab, n=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(3, 9))
                         ).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("arch", ALL)
def test_greedy_tokens_equal_the_reference(arch, interpret):
    jc, tc, jp, tp = _model(arch)
    prompts = _prompts(jc.vocab_size)
    out = {}
    for pkg, cfg, params, impl in ((jengine, jc, jp, "pallas"),
                                   (tengine, tc, tp, "kernel")):
        eng = pkg.ServeEngine(cfg, params, batch_size=2, max_len=24,
                              impl=impl)
        reqs = [pkg.Request(i, p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        out[pkg] = [r.out_tokens for r in reqs]
    assert out[tengine] == out[jengine]


def _grads(tc, tp, tb):
    flat, treedef = tree_flatten_with_path(tp)
    xs = [t.detach().clone().requires_grad_(True) for _, t in flat]
    loss, _ = tzoo.lm_loss(tree_unflatten(treedef, xs), tc, tb)
    gs = torch.autograd.grad(loss, xs)
    return float(loss.detach()), {p: g.numpy() for (p, _), g in zip(flat, gs)}


@pytest.mark.parametrize("arch", ALL)
def test_lm_loss_gradients_match_jax_grad(arch):
    jc, tc, jp, tp = _model(arch)
    jb, tb = _batches(jc, 2, 16, seed=2)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jzoo.lm_loss(p, jc, jb)[0]))(jp)
    tl, tg = _grads(tc, tp, tb)
    assert tl == pytest.approx(float(jl), rel=1e-5)
    jg = {p: np.asarray(g) for p, g in tree_flatten_with_path(_np(jg))[0]}
    assert set(jg) == set(tg)
    for p, want in jg.items():
        err = np.abs(tg[p] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (p, err)
    if jc.family == "vlm":     # the gates open the cross layer's gradients
        cross = [p for p in jg if "gate_attn" in p]
        assert cross and all(np.abs(jg[p]).max() > 0 for p in cross)


def test_train_op_loss_carries_the_moe_aux():
    """``dl_train_op``'s loss is ``lm_loss``'s ``ce + aux``, as the
    reference's: one step of each package's op from the same weights on
    granite's smoke config."""
    from repro.train import optim as JO
    from repro.train.ops import dl_train_op as j_dl_train_op
    from repro_torch.core.pipeline import OpGraph
    from repro_torch.train import optim as TO
    from repro_torch.train.ops import dl_train_op

    jc, tc, jp, tp = _model("granite-moe-1b-a400m")
    jb, tb = _batches(jc, 2, 16, seed=9)
    jop = j_dl_train_op(jc, JO.adamw(1e-3), batch_size=2, seq_len=16)
    jstate = (jp, JO.adamw(1e-3).init(jp), jnp.asarray(0, jnp.int32))
    _, jout = jop.fn(jstate, dict(jb))
    op = dl_train_op(tc, TO.adamw(1e-3), batch_size=2, seq_len=16,
                     device="cpu")
    tp2 = tree_map(lambda t: t.clone(), tp)
    _, out = OpGraph([op]).run(
        {op.name: (tp2, TO.adamw(1e-3).init(tp2),
                   torch.zeros((), dtype=torch.int32))},
        {**tb, "rng": torch.tensor(0)}, frozenset())
    loss, m = tzoo.lm_loss(tp, tc, tb)
    assert float(m["aux"]) > 0
    assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-6)
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-5)
