"""The kernels' pad routes and their refusal of autograd, on the CPU.

A head size (WKV), state size (Mamba) or head dim (flash attention) that
the CUDA kernels are not built for, up to the largest built one, runs on
the card zero-padded up to the next built size, with the outputs sliced
back (``padded_call`` in each wrapper). Above the largest built size
every size reaches a kernel too: flash attention's wide kernel takes
any multiple of 8 (a dim in between is padded up to one); WKV splits a
head into (key block, value block) heads of 128 in one call and sums
the key blocks; Mamba runs groups of at most 64 states, one call a
group, and sums their y. Only sizes below 1 are refused. The card's computation is the
kernel at the padded size; here the same padding drives the kernel's
CPU twin (the tensor-core WKV's ``rwkv6_wkv_chunked_ref``, the lane
Mamba scan's ``mamba_scan_lanes_ref``) or the plain version, at the
padded size, and is held to the plain version at the original size and
to the JAX package's Pallas kernel there (interpret mode). ``chip_smoke.py``
holds each pad route to its plain version on the card.

Tolerances: the flash pad route keeps the original dim's scale, so its
scores are the unpadded ones (the padded columns add zeros) and it agrees
with the plain version within fp32 rounding (1e-5). WKV and Mamba: the
twins' own bounds against the per-step recurrences (``test_torch_wkv.py``
2e-5 of the largest entry, ``test_torch_norm_mamba.py`` 1e-5).

The CUDA routes launch through ``ctypes``, which autograd cannot see:
each kernel's wrapper raises where an input requires grad in grad mode,
before it looks at the device, so the refusal shows on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro.kernels.mamba_scan import mamba_scan_bd as jx_mamba
from repro.kernels.rwkv6_wkv import rwkv6_wkv as jx_wkv

from repro_torch.kernels import detector_scan as tds
from repro_torch.kernels import ef_codec as tef
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import preprocess as tpp
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as twkv
from repro_torch.streams import drift as tdrift

FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
WKV_REL = 2e-5
MAMBA_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the sizes each pad route runs at
# ---------------------------------------------------------------------------

def _mamba_route(N):
    """What the Mamba route's groups add up to (64 states a group, the
    rest at its built size)."""
    return sum(p for _, _, p in tms.state_groups(N))


PAD_ROUTES = [
    (tfa.padded_head_dim, tfa.HEAD_DIMS,
     {8: 16, 16: 16, 17: 64, 32: 64, 64: 64, 96: 128, 128: 128, 129: 256,
      192: 256, 256: 256, 257: 264, 320: 320, 321: 328, 1000: 1000},
     256, lambda D: -(-D // 8) * 8),
    (twkv.padded_head_size, twkv.HEAD_SIZES,
     {1: 16, 8: 16, 16: 16, 32: 64, 48: 64, 64: 64, 65: 128, 96: 128,
      128: 128, 129: 256, 160: 256, 256: 256, 257: 384},
     128, lambda hs: -(-hs // 128) * 128),
    (tms.padded_state_size, tms.STATE_SIZES,
     {1: 4, 2: 4, 4: 4, 8: 16, 12: 16, 16: 16, 17: 32, 24: 32, 32: 32,
      33: 64, 48: 64, 64: 64, 65: 68, 80: 80, 128: 128, 130: 132},
     64, _mamba_route),
]


@pytest.mark.parametrize("fn,built,cases,top,above", PAD_ROUTES)
def test_pad_routes_take_the_next_built_size_and_refuse_above(fn, built,
                                                               cases, top,
                                                               above):
    """Each size runs at the size its route gives; above the largest
    built size the new routes take it (no ``ValueError``), and only sizes
    below 1 are refused."""
    for size, want in cases.items():
        assert fn(size) == want
    for size in (top + 1, 2 * top, 5 * top + 3):
        assert fn(size) == above(size) >= size
    for size in (0, -1):
        with pytest.raises(ValueError):
            fn(size)


@pytest.mark.parametrize("fn,built,cases,top,above", PAD_ROUTES)
def test_every_size_up_to_the_largest_reaches_a_built_kernel(fn, built,
                                                             cases, top,
                                                             above):
    """Flash up to D 256, WKV up to head size 128 and Mamba up to 64
    states: every size maps to the smallest built size at or above it.
    Above, up to three times the largest: flash a multiple of 8, WKV a
    multiple of 128, Mamba its groups of built sizes; the ``ValueError``
    names a size below 1."""
    assert max(built) == top
    for size in range(1, top + 1):
        got = fn(size)
        assert got in built and got >= size
        assert got == min(b for b in built if b >= size)
    for size in range(top + 1, 3 * top + 1):
        assert fn(size) == above(size) >= size
    with pytest.raises(ValueError, match="0"):
        fn(0)
    groups = tms.state_groups(3 * 64 + 5)
    assert [g[1] for g in groups] == [64, 64, 64, 5]
    assert all(p in tms.STATE_SIZES for _, _, p in groups)


# ---------------------------------------------------------------------------
# flash attention at head dims 32 and 96
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [32, 96])
@pytest.mark.parametrize("S,T,H,KV,causal", [
    (16, 16, 4, 2, True),      # causal self-attention, GQA
    (11, 24, 4, 4, False),     # cross-attention
    (1, 24, 4, 1, False),      # a decode step
])
def test_flash_pad_route_matches_plain_and_pallas(D, S, T, H, KV, causal):
    rng = np.random.default_rng(D * 7 + S + T)
    q = rng.normal(size=(2, S, H, D)).astype(np.float32)
    k = rng.normal(size=(2, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(2, T, KV, D)).astype(np.float32)
    got = tfa.padded_call(tfa.flash_attention_plain, _t(q), _t(k), _t(v),
                          causal=causal)
    assert got.shape == (2, S, H, D)
    want = tfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FLASH_TOL)
    pallas = jx_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **FLASH_TOL)


@pytest.mark.parametrize("D", [320, 321])
@pytest.mark.parametrize("S,T,H,KV,causal", [
    (16, 16, 4, 2, True),      # causal self-attention, GQA
    (11, 24, 4, 4, False),     # cross-attention
    (1, 24, 4, 1, False),      # a decode step
])
def test_flash_wide_route_matches_plain_and_pallas(D, S, T, H, KV, causal):
    """Above the largest built dim the route hands the wide kernel (here
    its plain version) a multiple of 8: D 320 as it is, 321 padded to
    328 with the original scale; against the plain version and the
    Pallas kernel at D (interpret mode)."""
    rng = np.random.default_rng(D * 7 + S + T)
    q = rng.normal(size=(2, S, H, D)).astype(np.float32)
    k = rng.normal(size=(2, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(2, T, KV, D)).astype(np.float32)
    seen = []

    def wide(q, k, v, *, causal, scale_dim=None):
        seen.append((q.shape[-1], scale_dim))
        return tfa.flash_attention_plain(q, k, v, causal=causal,
                                         scale_dim=scale_dim)
    got = tfa.padded_call(wide, _t(q), _t(k), _t(v), causal=causal)
    assert seen == [(-(-D // 8) * 8, None if D % 8 == 0 else D)]
    assert got.shape == (2, S, H, D)
    want = tfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FLASH_TOL)
    pallas = jx_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **FLASH_TOL)


def test_flash_pad_route_keeps_the_original_scale():
    """Without the original dim's scale the padded call would scale the
    scores by 1/sqrt(64) where they want 1/sqrt(32)."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.normal(size=(1, 8, 2, 32)).astype(np.float32) * 3)
               for _ in range(3))
    pad = [torch.nn.functional.pad(t, (0, 32)) for t in (q, k, v)]
    wrong = tfa.flash_attention_plain(*pad, causal=True)[..., :32]
    right = tfa.padded_call(tfa.flash_attention_plain, q, k, v, causal=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    assert not np.allclose(wrong.numpy(), want.numpy(), **FLASH_TOL)
    np.testing.assert_allclose(right.numpy(), want.numpy(), **FLASH_TOL)
    assert tfa._scale(32) == float(np.float32(1) / np.sqrt(np.float32(32)))


# ---------------------------------------------------------------------------
# WKV at head size 32 (and 8)
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, S, H, hs):
    r, k, v = (rng.normal(size=(B, S, H, hs)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.normal(size=(B, S, H, hs)) * 0.5 - 2.0).astype(np.float32)
    u = rng.normal(size=(H, hs)).astype(np.float32) * 0.5
    h0 = rng.normal(size=(B, H, hs, hs)).astype(np.float32)
    return r, k, v, lw, u, h0


def _rel_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= WKV_REL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("hs,S,chunk", [(32, 64, 32), (32, 37, 16),
                                        (32, 1, 32), (8, 48, 16)])
def test_wkv_pad_route_matches_plain_and_pallas(hs, S, chunk):
    """The tensor-core kernel's twin at the padded head size, sliced
    back, against the per-step recurrence and the Pallas kernel at hs."""
    rng = np.random.default_rng(hs * 100 + S)
    args = _wkv_inputs(rng, 2, S, 2, hs)
    ts = [_t(a) for a in args]

    def twin(r, k, v, lw, u, h0, *, chunk):
        assert r.shape[-1] == twkv.padded_head_size(hs)
        return tref.rwkv6_wkv_chunked_ref(r, k, v, lw, u, h0, chunk=chunk)

    o, h = twkv.padded_call(twin, *ts, chunk=chunk)
    assert o.shape == ts[0].shape and h.shape == ts[5].shape
    po, ph = twkv.rwkv6_wkv_plain(*ts, chunk=chunk)
    jo, jh = jx_wkv(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    for want_o, want_h, name in ((po, ph, "plain"), (jo, jh, "pallas")):
        _rel_close(o, want_o, f"o vs {name}")
        _rel_close(h, want_h, f"h_last vs {name}")
    # the plain version itself through the same padding: the padded rows
    # and columns add exact zeros
    o2, h2 = twkv.padded_call(twkv.rwkv6_wkv_plain, *ts, chunk=chunk)
    _rel_close(o2, po, "padded plain")
    _rel_close(h2, ph, "padded plain h")


@pytest.mark.parametrize("hs,S,dtype", [(160, 9, torch.float32),
                                        (160, 1, torch.float32),
                                        (160, 6, torch.bfloat16),
                                        (300, 5, torch.float32)])
def test_wkv_block_route_matches_plain_and_pallas(hs, S, dtype):
    """Above head size 128: one call of (key block, value block) heads of
    128 in fp32 (here the plain version in the kernel's place), o summed
    over the key blocks, h_last's blocks put back; against the per-step
    recurrence at hs and the Pallas kernel (interpret mode). bf16 inputs
    round once, at the end: within a bf16 ulp of the plain version's."""
    rng = np.random.default_rng(hs + S)
    args = _wkv_inputs(rng, 2, S, 2, hs)
    ts = [_t(a) for a in args]
    ts[:3] = [t.to(dtype) for t in ts[:3]]
    seen = []

    def kernel(r, k, v, lw, u, h0, *, chunk):
        seen.append((tuple(r.shape), r.dtype, tuple(h0.shape)))
        return twkv.rwkv6_wkv_plain(r, k, v, lw, u, h0, chunk=chunk)

    o, h = twkv.padded_call(kernel, *ts, chunk=16)
    nb = -(-hs // 128)
    assert seen == [((2, S, 2 * nb * nb, 128), torch.float32,
                     (2, 2 * nb * nb, 128, 128))]
    assert o.shape == ts[0].shape and o.dtype == dtype
    assert h.shape == ts[5].shape
    po, ph = twkv.rwkv6_wkv_plain(*ts, chunk=16)
    if dtype == torch.bfloat16:
        eps = float(torch.finfo(torch.bfloat16).eps)
        assert float((o.float() - po.float()).abs().max()) <= \
            eps * float(po.float().abs().max())
        _rel_close(h, ph, "h_last vs plain (bf16 inputs)")
        return
    jo, jh = jx_wkv(*map(jnp.asarray, args), chunk=16, interpret=True)
    for want_o, want_h, name in ((po, ph, "plain"), (jo, jh, "pallas")):
        _rel_close(o, want_o, f"o vs {name}")
        _rel_close(h, want_h, f"h_last vs {name}")


# ---------------------------------------------------------------------------
# Mamba at state size 8, and above 64 states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,dI,N", [(2, 13, 40, 80), (1, 1, 24, 80),
                                      (1, 7, 16, 132)])
def test_mamba_group_route_matches_plain_and_pallas(B, S, dI, N):
    """Above 64 states: one call of the lane kernel's twin a group of at
    most 64 states (each at its built size), y summed in fp32, h_last
    concatenated; against the per-step scan and the Pallas kernel at N
    (interpret mode)."""
    rng = np.random.default_rng(B * 1000 + S + N)
    z = rng.normal(size=(B, S, dI)).astype(np.float32)
    ins = (np.log1p(np.exp(z - 2.0)).astype(np.float32),
           rng.normal(size=(B, S, dI)).astype(np.float32),
           rng.normal(size=(B, S, N)).astype(np.float32),
           rng.normal(size=(B, S, N)).astype(np.float32),
           -np.exp(rng.normal(size=(dI, N)) * 0.5).astype(np.float32),
           rng.normal(size=(B, dI, N)).astype(np.float32))
    ts = [_t(a) for a in ins]
    sizes = []

    def kernel(dt, x, Bm, Cm, A, h0):
        sizes.append(Bm.shape[-1])
        assert Bm.shape[-1] in tms.STATE_SIZES
        return tref.mamba_scan_lanes_ref(dt, x, Bm, Cm, A, h0)

    y, h = tms.padded_call(kernel, *ts)
    assert sizes == [p for _, _, p in tms.state_groups(N)]
    assert y.shape == (B, S, dI) and h.shape == (B, dI, N)
    py, ph = tref.mamba_scan_ref(*ts)
    jin = [jnp.asarray(a) for a in ins]
    for wy, wh in ((py.numpy(), ph.numpy()),
                   jx_mamba(*jin, chunk=8, bd=dI, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                   rtol=MAMBA_TOL, atol=MAMBA_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh),
                                   rtol=MAMBA_TOL, atol=MAMBA_TOL)


@pytest.mark.parametrize("B,S,dI,N", [(2, 21, 64, 8), (1, 1, 40, 8),
                                      (2, 9, 33, 2)])
def test_mamba_pad_route_matches_plain_and_pallas(B, S, dI, N):
    """The lane kernel's twin at the padded state size, sliced back,
    against the per-step scan and the Pallas kernel at N."""
    rng = np.random.default_rng(B * 1000 + S + N)
    z = rng.normal(size=(B, S, dI)).astype(np.float32)
    ins = (np.log1p(np.exp(z - 2.0)).astype(np.float32),
           rng.normal(size=(B, S, dI)).astype(np.float32),
           rng.normal(size=(B, S, N)).astype(np.float32),
           rng.normal(size=(B, S, N)).astype(np.float32),
           -np.exp(rng.normal(size=(dI, N)) * 0.5).astype(np.float32),
           rng.normal(size=(B, dI, N)).astype(np.float32))
    ts = [_t(a) for a in ins]
    y, h = tms.padded_call(tref.mamba_scan_lanes_ref, *ts)
    assert y.shape == (B, S, dI) and h.shape == (B, dI, N)
    py, ph = tref.mamba_scan_ref(*ts)
    jin = [jnp.asarray(a) for a in ins]
    for wy, wh in ((py.numpy(), ph.numpy()), jref.mamba_scan_ref(*jin),
                   jx_mamba(*jin, chunk=8, bd=dI, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                   rtol=MAMBA_TOL, atol=MAMBA_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh),
                                   rtol=MAMBA_TOL, atol=MAMBA_TOL)


# ---------------------------------------------------------------------------
# the CUDA routes refuse autograd
# ---------------------------------------------------------------------------

def _grad_cases():
    f = lambda *s: torch.zeros(s, requires_grad=True)   # noqa: E731
    ph = tdrift.ph_init()
    return {
        "flash_attention": lambda: tfa.flash_attention_cuda(
            f(1, 4, 2, 16), torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16)),
        "rwkv6_wkv": lambda: twkv.rwkv6_wkv_cuda(
            torch.zeros(1, 4, 2, 16), f(1, 4, 2, 16), torch.zeros(1, 4, 2, 16),
            torch.zeros(1, 4, 2, 16), torch.zeros(2, 16),
            torch.zeros(1, 2, 16, 16), chunk=16),
        "mamba_scan": lambda: tms.mamba_scan_cuda(
            torch.zeros(1, 3, 8), torch.zeros(1, 3, 8), torch.zeros(1, 3, 4),
            torch.zeros(1, 3, 4), f(8, 4), torch.zeros(1, 8, 4)),
        "fused_normalize": lambda: tpp.fused_normalize_cuda(
            f(4, 8), 0.0, torch.zeros(8), torch.zeros(8)),
        "fused_hash_features": lambda: tpp.fused_hash_features_cuda(
            torch.zeros(4, 2, dtype=torch.int32), f(4, 2), 16),
        "ef_int8_roundtrip": lambda: tef.ef_int8_roundtrip_cuda(
            torch.zeros(8), f(8)),
        "ef_topk_int8_roundtrip": lambda: tef.ef_topk_int8_roundtrip_cuda(
            f(8), torch.zeros(8), 2),
        "detector_scan": lambda: tds.detector_scan_cuda(
            "ph", ph._replace(mean=torch.zeros((), requires_grad=True)),
            torch.zeros(8)),
    }


@pytest.mark.parametrize("name", sorted(_grad_cases()))
def test_cuda_routes_refuse_inputs_that_require_grad(name):
    """In grad mode the kernel's wrapper raises before anything else: the
    gradient through a ctypes launch would come back silently zero. Under
    ``torch.no_grad`` the same call goes on to its usual checks (here: a
    CPU tensor is not a CUDA device)."""
    call = _grad_cases()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        with pytest.raises((ValueError, RuntimeError)) as e:
            call()
        assert "requires grad" not in str(e.value)


def test_model_kernel_path_refuses_training_on_the_card(monkeypatch):
    """``attention(impl="kernel")`` in a training forward reaches the
    refusal: the flash wrapper's CUDA branch is taken (the device check
    stubbed as the card's), and the kernel's wrapper raises."""
    from repro_torch.models import attention as tattn

    def on_card(q, k, v, *, causal=True):
        return tfa.padded_call(tfa.flash_attention_cuda, q, k, v,
                               causal=causal)
    monkeypatch.setattr(tfa, "flash_attention", on_card)
    monkeypatch.setattr("repro_torch.kernels.ops.flash_attention", on_card)
    q = torch.zeros(1, 4, 2, 32, requires_grad=True)
    kv = torch.zeros(1, 6, 2, 32)
    with pytest.raises(RuntimeError, match="requires grad"):
        tattn.attention(q, kv, kv, causal=False, impl="kernel")
