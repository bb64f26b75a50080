"""The port's model path (``repro_torch.models``) and its two kernels'
plain versions against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
port's weights are the JAX package's, converted leaf for leaf
(``convert.params_from_numpy``). The smoke configurations are fp32, so
the tolerances are fp32 ones: the two packages sum in other orders, and
the kernels' plain versions compute the same functions by other schedules
(the naive WKV recurrence against the chunked kernel). Where the JAX side
reaches a Pallas kernel it runs in interpret mode
(``REPRO_FORCE_PALLAS_INTERPRET=1``), as its own tests run it. The CUDA
kernels are held to the same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro.kernels.flash_attention import flash_attention_bhsd as jx_flash_bhsd
from repro.kernels.rwkv6_wkv import rwkv6_wkv as jx_wkv
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.models import rwkv as jrwkv

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import params as tparams
from repro_torch.models import rwkv as trwkv

ARCHS = ("qwen2-1.5b", "rwkv6-1.6b", "seamless-m4t-medium",
         "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b", "llama-3.2-vision-90b",
         "mistral-large-123b", "nemotron-4-15b", "qwen1.5-4b")
# fp32 end to end on the smoke configs; logits are O(1..60)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randn(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.fixture
def interpret(monkeypatch):
    """Let the JAX package take its Pallas kernels, in interpret mode."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# flash attention: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

# (S, T, causal, block): S = 1 is a decode step; S != T non-causal is
# cross-attention; blocks smaller than S or T make the kernel pad
FLASH_CASES = [(16, 16, True, 256), (16, 16, False, 256), (1, 24, False, 256),
               (11, 24, False, 8), (13, 13, True, 8), (10, 24, True, 8)]
# the head dims the CUDA kernels are built for (kernels/flash_attention.py)
FLASH_HEAD_DIMS = (16, 64, 128)
# fp32 on both sides, other summation orders (the twin materialises the
# softmax, the Pallas kernel runs it online over blocks)
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("S,T,causal,block", FLASH_CASES)
def test_flash_plain_matches_pallas_kernel(S, T, causal, block, D):
    rng = np.random.default_rng(S * 31 + T + D)
    BH = 3
    q, k, v = (_randn(rng, BH, n, D) for n in (S, T, T))
    want = jx_flash_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, bq=block, bk=block, interpret=True)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("D", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("groups", (1, 2, 8))
def test_flash_model_layout_expands_gqa_like_the_reference(groups, D):
    """H = 2 x groups query heads on 2 KV heads: query head h reads KV
    head h // groups, as the reference's repeat does."""
    rng = np.random.default_rng(3 + groups + D)
    H, KV = 2 * groups, 2
    q, k, v = _randn(rng, 2, 9, H, D), _randn(rng, 2, 14, KV, D), \
        _randn(rng, 2, 14, KV, D)
    want = jx_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, interpret=True)
    got = kops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    assert got.shape == (2, 9, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("causal", (False, True))
def test_flash_strided_views_give_the_references_result(causal):
    """q, k, v as transposed views of (B, H, S, D) buffers and as slices
    of a fused qkv buffer: the wrapper reads them as they are."""
    rng = np.random.default_rng(11)
    B, S, H, KV, D = 2, 10, 4, 2, 16
    q, k, v = _randn(rng, B, S, H, D), _randn(rng, B, S, KV, D), \
        _randn(rng, B, S, KV, D)
    want = np.asarray(jx_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               interpret=True))
    views = [_t(a.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
             for a in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    got = kops.flash_attention(*views, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)
    qkv = torch.cat([_t(q), _t(k), _t(v)], dim=2)      # (B, S, H+2KV, D)
    got = kops.flash_attention(qkv[:, :, :H], qkv[:, :, H:H + KV],
                               qkv[:, :, H + KV:], causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


@pytest.mark.parametrize("D", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_argument_checks_accept_the_built_head_dims(D, dtype):
    q = torch.zeros((2, 3, 4, D), dtype=dtype)
    kv = torch.zeros((2, 5, 2, D), dtype=dtype)
    tfa.check_args(q, kv, kv)
    # transposed views with a contiguous last axis are taken as they are
    tfa.check_args(torch.zeros((2, 4, 3, D), dtype=dtype).transpose(1, 2),
                   kv, kv)
    # on a CPU tensor the kernel's wrapper checks, then refuses the device
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa.flash_attention_cuda(q, kv, kv)


def test_flash_argument_checks_refuse_what_no_kernel_takes():
    q, kv = torch.zeros((2, 3, 4, 64)), torch.zeros((2, 5, 2, 64))
    for D in (8, 32, 96, 260):
        with pytest.raises(ValueError, match="head dim"):
            tfa.check_args(torch.zeros((2, 3, 4, D)),
                           torch.zeros((2, 5, 2, D)),
                           torch.zeros((2, 5, 2, D)))
    # above 256 the wide kernel takes every multiple of 8
    for D in (264, 512):
        tfa.check_args(torch.zeros((2, 3, 4, D)), torch.zeros((2, 5, 2, D)),
                       torch.zeros((2, 5, 2, D)))
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            tfa.check_args(q.to(dt), kv.to(dt), kv.to(dt))
    with pytest.raises(TypeError):
        tfa.check_args(q, kv.bfloat16(), kv)
    # a last axis with stride 2
    wide = torch.zeros((2, 3, 4, 128))
    with pytest.raises(ValueError, match="stride"):
        tfa.check_args(wide[..., ::2], kv, kv)
    with pytest.raises(ValueError, match="stride"):
        tfa.check_args(q, torch.zeros((2, 5, 2, 128))[..., ::2], kv)
    # rows that do not start 16 bytes aligned (a 2-element offset in bf16)
    flat = torch.zeros(2 * 3 * 4 * 64 + 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        tfa.check_args(flat[2:].view(2, 3, 4, 64), kv.bfloat16(),
                       kv.bfloat16())
    # H not a multiple of KV, mismatched k and v
    with pytest.raises(ValueError):
        tfa.check_args(torch.zeros((2, 3, 3, 64)), kv, kv)
    with pytest.raises(ValueError):
        tfa.check_args(q, kv, torch.zeros((2, 6, 2, 64)))


@pytest.mark.parametrize("shape,causal,want", [
    # seamless-m4t-medium at full width (B 8, 16 heads): prefill, decode
    ((8, 512, 512, 16, 16), False, 0),
    ((8, 1, 512, 16, 16), False, 1),
    # llama-3.2-vision-90b cross-attention: 64 heads on 8, 1,600 image
    # tokens; a decode step at batch 1 and 2 splits T to fill the card
    ((1, 512, 1600, 64, 8), False, 0),
    ((1, 1, 1600, 64, 8), False, 25),
    ((2, 1, 1600, 64, 8), False, 13),
    # ... and at its serving batch, 8: prefill and a decode step
    ((8, 512, 1600, 64, 8), False, 0),
    ((8, 1, 1600, 64, 8), False, 4),
    # 16 rows a KV head still take the decode kernel, 17 do not
    ((64, 2, 512, 16, 2), False, 1),
    ((64, 3, 512, 12, 2), False, 0),
    # causal at S <= 16: only the first tile is attended, nothing to split
    ((1, 4, 1600, 8, 2), True, 1),
    # one (batch, KV head) and a long T: at most MAX_SPLITS splits
    ((1, 1, 65536, 8, 1), False, 128),
])
def test_flash_launch_shape(shape, causal, want):
    B, S, T, H, KV = shape
    assert tfa.kv_splits(B, S, T, H, KV, torch.bfloat16, causal) == want
    # fp32 always takes its CUDA-core kernel
    assert tfa.kv_splits(B, S, T, H, KV, torch.float32, causal) == 0


@pytest.mark.parametrize("S,T", [(12, 12), (5, 12)])
def test_attention_twin_against_the_jax_oracle(S, T):
    """The twin takes the kernel's start-aligned causal mask; the JAX
    oracle's is end-aligned. They agree without a mask, and with one
    only at S = T."""
    rng = np.random.default_rng(S)
    q, k, v = _randn(rng, 2, S, 4, 8), _randn(rng, 2, T, 2, 8), \
        _randn(rng, 2, T, 2, 8)
    for causal in (False, True):
        got = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
        want = np.asarray(jref.attention_ref(q, k, v, causal=causal))
        if causal and S != T:
            assert not np.allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# RWKV6 WKV: the plain version against the Pallas kernel and wkv_chunked
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, S, H, hs, h0=True):
    r, k, v = (_randn(rng, B, S, H, hs, scale=0.5) for _ in range(3))
    lw = -np.exp(_randn(rng, B, S, H, hs, scale=0.5) - 2.0).astype(np.float32)
    u = _randn(rng, H, hs, scale=0.5)
    h = _randn(rng, B, H, hs, hs) if h0 else np.zeros((B, H, hs, hs),
                                                      np.float32)
    return r, k, v, lw, u, h


# (S, chunk): a multiple of the chunk, one that pads, a decode step
@pytest.mark.parametrize("S,chunk", [(16, 8), (20, 8), (1, 8)])
def test_wkv_plain_matches_pallas_kernel(S, chunk):
    rng = np.random.default_rng(S)
    args = _wkv_inputs(rng, 2, S, 3, 8)
    want_o, want_h = jx_wkv(*map(jnp.asarray, args), chunk=chunk,
                            interpret=True)
    got_o, got_h = kops.rwkv6_wkv(*map(_t, args), chunk=chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-4, atol=1e-4)


# (S, chunk): chunked, the single-chunk fallback (S % chunk != 0), decode
@pytest.mark.parametrize("S,chunk", [(16, 4), (10, 4), (1, 4)])
def test_wkv_chunked_matches_the_reference(S, chunk):
    rng = np.random.default_rng(100 + S)
    args = _wkv_inputs(rng, 2, S, 2, 8)
    want_o, want_h = jrwkv.wkv_chunked(*map(jnp.asarray, args), chunk)
    got_o, got_h = trwkv.wkv_chunked(*map(_t, args), chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# attention paths against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("cached", [False, True])
def test_attention_matches_the_reference(impl, cached):
    """Offsets as tensors (the self-attention path) and a KV length (the
    cached path), causal, GQA, and a chunk smaller than T."""
    rng = np.random.default_rng(7)
    B, S, T, H, KV, D = 2, 5, 12, 4, 2, 8
    q, k, v = _randn(rng, B, S, H, D), _randn(rng, B, T, KV, D), \
        _randn(rng, B, T, KV, D)
    if cached:
        joff, toff = jnp.asarray(4, jnp.int32), torch.tensor(4, dtype=torch.int32)
        jkl, tkl = joff + S, toff + S
    else:
        joff, toff = jnp.asarray([0, 3]), torch.tensor([0, 3])
        jkl = tkl = None
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, impl=impl, chunk=4, q_offset=joff,
                           kv_len=jkl)
    got = tattn.attention(_t(q), _t(k), _t(v), causal=True, impl=impl,
                          chunk=4, q_offset=toff, kv_len=tkl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_flash_supported_is_the_references_rule():
    q = torch.zeros(1, 2, 2, 8)
    assert kops.flash_supported(q, q, q, False, 0, None)
    assert not kops.flash_supported(q, q, q, True, torch.tensor(0), None)
    assert not kops.flash_supported(q, q, q, True, 3, None)
    assert not kops.flash_supported(q, q, q, True, 0, torch.tensor(2))
    assert not kops.flash_supported(q, torch.zeros(1, 2, 2, 4), q, True, 0,
                                    None)


def test_self_attention_never_reaches_the_flash_kernel(monkeypatch):
    """As in the reference: self-attention passes its offset as a tensor,
    so impl="kernel" falls back to the chunked/dense path there."""
    cfg = tget("qwen2-1.5b", smoke=True)
    params = tzoo.init_params(cfg, 0, device="cpu")
    calls = []
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1))
    tzoo.forward_lm(params, cfg, {"tokens": torch.zeros(1, 6,
                                                        dtype=torch.int32)},
                    impl="kernel")
    assert calls == []


# ---------------------------------------------------------------------------
# whole models: logits on the same weights
# ---------------------------------------------------------------------------

_CACHE = {}


def _model(arch):
    if arch not in _CACHE:
        jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
        jp = jzoo.init_params(jc, 0)
        tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")
        _CACHE[arch] = (jc, tc, jp, tp)
    return _CACHE[arch]


def _batches(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.family == "encdec":
        fr = _randn(rng, B, S, cfg.frontend_dim)
        jb["frames"], tb["frames"] = jnp.asarray(fr), _t(fr)
    if cfg.family == "vlm":
        pa = _randn(rng, B, cfg.frontend_len, cfg.frontend_dim)
        jb["patches"], tb["patches"] = jnp.asarray(pa), _t(pa)
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_logits_match_the_reference(arch, interpret):
    jc, tc, jp, tp = _model(arch)
    jb, tb = _batches(jc, 2, 12, seed=1)
    # the reference's pallas path crashes on MLA's uncached forward
    # (fault 15); the port's kernel path is its chunked function there
    jkernel = "chunked" if jc.mla is not None else "pallas"
    for jimpl, timpl in (("chunked", "chunked"), (jkernel, "kernel")):
        want, _ = jzoo.forward_lm(jp, jc, jb, impl=jimpl)
        got, _ = tzoo.forward_lm(tp, tc, tb, impl=timpl)
        real = slice(0, jc.vocab_size)
        np.testing.assert_allclose(got.numpy()[..., real],
                                   np.asarray(want)[..., real], **LOGIT_TOL)
        want_p, _ = jzoo.prefill(jp, jc, jb, max_len=16, impl=jimpl)
        got_p, _ = tzoo.prefill(tp, tc, tb, max_len=16, impl=timpl)
        np.testing.assert_allclose(got_p.numpy()[..., real],
                                   np.asarray(want_p)[..., real], **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The port's own consistency, as the reference's smoke test: prefill
    on S tokens then one decode step equals the forward pass on S+1. The
    smoke configs keep the KV cache in bf16, so the cached path rounds k
    and v (the reference shows the same 1e-2 gap): its tolerance,
    rtol = atol = 2e-2."""
    _, cfg, _, params = _model(arch)
    B, S = 2, 12
    _, batch = _batches(cfg, B, S + 1, seed=2)
    full, _ = tzoo.forward_lm(params, cfg, batch, impl="kernel")
    prompt = {**batch, "tokens": batch["tokens"][:, :S]}
    if cfg.family == "encdec":
        # the decoder attends to one encoding of the S+1 frames
        prompt["frames"] = batch["frames"]
    lp, caches = tzoo.prefill(params, cfg, prompt, max_len=S + 4,
                              impl="kernel")
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)
    ld, caches = tzoo.decode_step(params, cfg, caches,
                                  batch["tokens"][:, S:S + 1], impl="kernel")
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, S].numpy(),
                               rtol=2e-2, atol=2e-2)
    assert int(tzoo._cache_length(caches)) == (
        0 if cfg.family in ("rwkv", "ssm") else S + 1)


def test_cache_overflow_raises_where_the_reference_clamps():
    _, cfg, _, params = _model("qwen2-1.5b")
    _, batch = _batches(cfg, 1, 4, seed=3)
    _, caches = tzoo.prefill(params, cfg, batch, max_len=5)
    tok = batch["tokens"][:, :1]
    _, caches = tzoo.decode_step(params, cfg, caches, tok)
    with pytest.raises(ValueError, match="KV cache overflow"):
        tzoo.decode_step(params, cfg, caches, tok)


# ---------------------------------------------------------------------------
# parameters, configs, casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_shapes_and_counts_match_the_reference(arch):
    for smoke in (True, False):
        jc, tc = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        js = jax.tree.map(lambda s: s.shape, jzoo.param_shapes(jc))
        jflat = {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in p): v
                 for p, v in jax.tree_util.tree_leaves_with_path(
                     js, is_leaf=lambda x: isinstance(x, tuple))}
        tflat = {}
        tparams._map_with_path(
            lambda p, t: tflat.__setitem__(tuple(p.split("/")),
                                           tuple(t.shape)),
            tzoo.param_shapes(tc))
        assert tflat == jflat
        assert tzoo.param_count(tc) == jzoo.param_count(jc)
        assert tc.param_counts() == jc.param_counts()


def test_init_params_is_deterministic_per_leaf_path():
    cfg = tget("rwkv6-1.6b", smoke=True)
    a = tzoo.init_params(cfg, 3, device="cpu")
    b = tzoo.init_params(cfg, 3, device="cpu")
    c = tzoo.init_params(cfg, 4, device="cpu")
    assert torch.equal(a["stack"][0]["mixer"]["wr"], b["stack"][0]["mixer"]["wr"])
    assert not torch.equal(a["stack"][0]["mixer"]["wr"],
                           c["stack"][0]["mixer"]["wr"])
    assert not torch.equal(a["stack"][0]["mixer"]["wr"],
                           a["stack"][0]["mixer"]["wk"])
    assert float(a["stack"][0]["mixer"]["w0"].mean()) == -2.0
    tok = a["embed"]["tok"]
    assert abs(float(tok.std()) - 1.0) < 0.1       # scale=1.0 leaf


def test_params_from_numpy_raises_on_a_bad_tree():
    jc, tc, jp, _ = _model("qwen2-1.5b")
    np_tree = jax.tree.map(np.asarray, jp)
    extra = {**np_tree, "bogus": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        convert.params_from_numpy(tc, extra, device="cpu")
    missing = {k: v for k, v in np_tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(tc, missing, device="cpu")
    bad = jax.tree.map(lambda a: a, np_tree)
    bad["final_norm"] = {"scale": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(tc, bad, device="cpu")


def test_entry_points_default_to_the_card():
    cfg = tget("qwen2-1.5b", smoke=True)
    if torch.cuda.is_available():
        assert tzoo.init_params(cfg, 0)["embed"]["tok"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tzoo.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert.params_from_numpy(cfg, {})


def test_int8_cast_saturates_then_truncates_like_xla():
    x = np.array([200.7, -300.2, 127.9, -128.9, -3.7, 3.7, 0.5, -0.5],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int8))
    got = tlayers.cast_like_xla(_t(x), torch.int8).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 127 and got[1] == -128
    assert _t(x).to(torch.int8)[0] != 127      # torch alone wraps
