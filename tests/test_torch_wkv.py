"""The WKV kernel's decomposition and its wrapper, on the CPU.

``kernels/ref.py::rwkv6_wkv_chunked_ref`` is a torch twin of the
tensor-core kernel's algorithm (``csrc/rwkv6_wkv.cu``, ``wkv_chunk_mma``):
sub-chunks of 16 steps, decays as running products of exp(lw), the
off-diagonal block of the scores factored, the diagonal blocks pairwise,
the bonus on the scores' diagonal, and the bf16 hi/lo split of every
fp32 operand of a product. It is held here to the JAX
package's Pallas kernel (``kernels/rwkv6_wkv.py``, run in interpret mode)
and to the per-step recurrence ``rwkv6_wkv_ref``, over every head size and
chunk a configuration reaches, at S = 1, at multiples of the chunk and at
ragged S, and under decays down to -20 a step. The model-layout wrapper's
CPU path (the plain version) is held to the JAX wrapper on strided inputs
with u as (H, hs). The kernel itself runs only on the card
(``chip_smoke.py`` phase 6).

Tolerances: the twin and the Pallas kernel compute the same chunked
function in fp32 by other schedules and summation orders, and the twin's
operand split keeps about 16 bits of each operand (about 2^-16 relative a
term), so outputs and states agree within 2e-5 of their largest entry
(observed up to ~5e-6). The per-step recurrence sums in yet another
order: the same bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import model_zoo as jzoo

from repro.kernels.rwkv6_wkv import rwkv6_wkv as jx_wkv
from repro.kernels.rwkv6_wkv import rwkv6_wkv_bh as jx_wkv_bh

from repro_torch import convert
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import RWKVConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as twkv
from repro_torch.models import model_zoo as tzoo

# the twin against the JAX kernel and the per-step recurrence, relative to
# the largest entry of the expected o or h_last
REL = 2e-5


def _inputs(rng, B, S, H, hs, *, strong=False):
    r, k, v = (rng.normal(size=(B, S, H, hs)).astype(np.float32) * 0.5
               for _ in range(3))
    if strong:      # a step's log decay down to -20
        lw = -20.0 * rng.random(size=(B, S, H, hs)).astype(np.float32)
    else:
        lw = -np.exp(rng.normal(size=(B, S, H, hs)) * 0.5 - 2.0)
    u = rng.normal(size=(H, hs)).astype(np.float32) * 0.5
    h0 = rng.normal(size=(B, H, hs, hs)).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u, h0


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), f"{what}: non-finite"
    err = float(np.abs(got - want).max())
    bound = REL * float(np.abs(want).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def _both(args, chunk):
    """The JAX Pallas kernel (interpret mode) and the per-step recurrence."""
    jo, jh = jx_wkv(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    po, ph = tref.rwkv6_wkv_ref(*map(torch.from_numpy, args))
    return (np.asarray(jo), np.asarray(jh)), (po.numpy(), ph.numpy())


@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", ["decode", "multiple", "ragged"])
def test_decomposition_matches_pallas_and_plain(hs, chunk, S):
    S = {"decode": 1, "multiple": 2 * chunk, "ragged": 2 * chunk + 5}[S]
    rng = np.random.default_rng(hs * 100 + chunk + S)
    args = _inputs(rng, 2, S, 2, hs)
    got_o, got_h = tref.rwkv6_wkv_chunked_ref(
        *map(torch.from_numpy, args), chunk=chunk)
    for (want_o, want_h), name in zip(_both(args, chunk),
                                      ("pallas", "plain")):
        _close(got_o, want_o, f"o vs {name}")
        _close(got_h, want_h, f"h_last vs {name}")


@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("chunk", [16, 32])
def test_decomposition_strong_decay(hs, chunk):
    rng = np.random.default_rng(7 + hs + chunk)
    args = _inputs(rng, 2, 2 * chunk + 3, 2, hs, strong=True)
    # a factoring across the whole chunk, exp(L_excl[t] - L[0]) against
    # exp(L[0] - L[s]), would overflow fp32 here
    L = np.cumsum(args[3][:, :chunk], axis=1)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(-L.min(axis=1)).astype(np.float32)
                               ).all()
    got_o, got_h = tref.rwkv6_wkv_chunked_ref(
        *map(torch.from_numpy, args), chunk=chunk)
    for (want_o, want_h), name in zip(_both(args, chunk),
                                      ("pallas", "plain")):
        _close(got_o, want_o, f"o vs {name}")
        _close(got_h, want_h, f"h_last vs {name}")


@pytest.mark.parametrize("hs", [16, 64])
def test_operand_split_error_is_small(hs):
    """The bf16 hi/lo split moves the result by about 2^-16 of its size,
    far inside the card's one-ulp (o) and 1e-4 (h_last) checks."""
    rng = np.random.default_rng(11 + hs)
    args = tuple(map(torch.from_numpy, _inputs(rng, 2, 64, 2, hs)))
    so, sh = tref.rwkv6_wkv_chunked_ref(*args, chunk=32)
    fo, fh = tref.rwkv6_wkv_chunked_ref(*args, chunk=32, operand_split=False)
    assert float((so - fo).abs().max()) <= 2 ** -14 * float(fo.abs().max())
    assert float((sh - fh).abs().max()) <= 2 ** -14 * float(fh.abs().max())
    assert float((so - fo).abs().max()) > 0.0      # the split is exercised


@pytest.mark.parametrize("hs", [16, 64])
def test_model_layout_wrapper_strided_inputs(hs):
    """r, k, v as slices of one (B, S, 3, H, hs) buffer, lw a slice too,
    u (H, hs) as the model holds it: the wrapper's CPU path against the
    JAX model-layout wrapper; o comes back (B, S, H, hs) contiguous."""
    rng = np.random.default_rng(21 + hs)
    B, S, H = 2, 37, 3
    r, k, v, lw, u, h0 = _inputs(rng, B, S, H, hs)
    buf = np.stack([r, k, v], axis=2)                 # (B, S, 3, H, hs)
    tb = torch.from_numpy(buf)
    lwb = torch.from_numpy(np.stack([lw, lw], axis=2))[:, :, 1]
    tr, tk, tv = tb[:, :, 0], tb[:, :, 1], tb[:, :, 2]
    assert not tr.is_contiguous() and not lwb.is_contiguous()
    got_o, got_h = kops.rwkv6_wkv(tr, tk, tv, lwb, torch.from_numpy(u),
                                  torch.from_numpy(h0), chunk=16)
    want_o, want_h = jx_wkv(*map(jnp.asarray, (r, k, v, lw, u, h0)),
                            chunk=16, interpret=True)
    assert got_o.shape == (B, S, H, hs) and got_o.is_contiguous()
    assert got_o.reshape(B, S, H * hs).data_ptr() == got_o.data_ptr()
    _close(got_o.numpy(), want_o, "o")
    _close(got_h.numpy(), want_h, "h_last")


def test_bh_layout_wrapper_matches_pallas():
    """The reference's (BH, S, hs) API, a view of the model-layout entry
    with BH heads of one batch: u (BH, hs) per row."""
    rng = np.random.default_rng(5)
    BH, S, hs = 4, 21, 16
    r, k, v = (rng.normal(size=(BH, S, hs)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.normal(size=(BH, S, hs)) * 0.5 - 2.0).astype(np.float32)
    u = rng.normal(size=(BH, hs)).astype(np.float32) * 0.5
    h0 = rng.normal(size=(BH, hs, hs)).astype(np.float32)
    args = (r, k, v, lw, u, h0)
    got_o, got_h = twkv.rwkv6_wkv_bh(*map(torch.from_numpy, args), chunk=16)
    want_o, want_h = jx_wkv_bh(*map(jnp.asarray, args), chunk=16,
                               interpret=True)
    assert got_o.shape == (BH, S, hs)
    _close(got_o.numpy(), want_o, "o")
    _close(got_h.numpy(), want_h, "h_last")


def _small(hs=16, S=4, dtype=torch.bfloat16):
    B, H = 1, 2
    r, k, v = (torch.zeros((B, S, H, hs), dtype=dtype) for _ in range(3))
    return (r, k, v, torch.zeros((B, S, H, hs)), torch.zeros((H, hs)),
            torch.zeros((B, H, hs, hs)))


@pytest.mark.parametrize("hs,chunk", [
    (8, 16), (32, 32), (256, 32), (48, 16),    # head sizes not built
    (64, 8), (64, 48), (16, 48), (16, 0),      # chunks not built
])
def test_kernel_refuses_sizes_it_was_not_built_for(hs, chunk):
    """The kernel's wrapper refuses, before it looks at the device, what
    the C entry refuses (``chip_smoke.py`` checks the C entry on the
    card); the plain version takes any size. The dispatching wrapper
    ``rwkv6_wkv`` maps an unbuilt positive chunk to a built one first
    (``test_unbuilt_chunks_run_at_a_built_chunk``)."""
    args = _small(hs)
    with pytest.raises(ValueError, match="head size|chunk"):
        twkv.check_args(*args, chunk)
    with pytest.raises(ValueError, match="head size|chunk"):
        twkv.rwkv6_wkv_cuda(*args, chunk=chunk)
    o, h = twkv.rwkv6_wkv_plain(*args, chunk=chunk)
    assert o.shape == args[0].shape and h.shape == args[5].shape


def test_kernel_refuses_a_cpu_tensor():
    """A size the kernel takes, on the CPU: the kernel's wrapper raises
    rather than run anything."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        twkv.rwkv6_wkv_cuda(*_small(64), chunk=32)


@pytest.mark.parametrize("smoke", [False, True])
def test_every_configured_size_is_built(smoke):
    c = get_config("rwkv6-1.6b", smoke=smoke).rwkv
    assert c.head_size in twkv.HEAD_SIZES and c.chunk in twkv.CHUNKS
    twkv.check_args(*_small(c.head_size), c.chunk)


def test_decomposition_refuses_other_chunks():
    with pytest.raises(ValueError, match="chunk"):
        tref.rwkv6_wkv_chunked_ref(*_small(16, dtype=torch.float32), chunk=8)


# ---------------------------------------------------------------------------
# an unbuilt chunk (RWKVConfig's default 64) runs at a built one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,built", [
    (16, 16), (32, 32), (64, 32), (128, 32), (48, 16), (96, 32),
    (8, 32), (40, 32), (1, 32)])
def test_unbuilt_chunks_run_at_a_built_chunk(chunk, built):
    """The largest built chunk that divides the chunk, else the largest
    built chunk; what it maps to is one the kernel takes."""
    assert twkv.kernel_chunk(chunk) == built
    twkv.check_args(*_small(64), twkv.kernel_chunk(chunk))


@pytest.mark.parametrize("chunk", [0, -32])
def test_dispatch_refuses_a_chunk_below_one(chunk):
    args = _small(16, dtype=torch.float32)
    with pytest.raises(ValueError, match="not positive"):
        kops.rwkv6_wkv(*args, chunk=chunk)
    with pytest.raises(ValueError, match="not positive"):
        twkv.rwkv6_wkv_bh(*(t[0].transpose(0, 1) for t in args[:4]),
                          args[4], args[5][0], chunk=chunk)


def test_default_config_chunk_runs_on_a_built_kernel():
    c = RWKVConfig()
    assert c.chunk == 64 and c.chunk not in twkv.CHUNKS
    assert twkv.kernel_chunk(c.chunk) in twkv.CHUNKS
    twkv.check_args(*_small(c.head_size), twkv.kernel_chunk(c.chunk))


@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("S", ["decode", "multiple", "ragged"])
def test_built_chunk_twin_matches_pallas_at_chunk_64(hs, S):
    """What the card computes for a chunk-64 call, the chunk-32 kernel
    (its twin ``rwkv6_wkv_chunked_ref``), against the Pallas kernel run
    at chunk 64 (interpret mode) and the per-step recurrence."""
    S = {"decode": 1, "multiple": 128, "ragged": 133}[S]
    rng = np.random.default_rng(640 + hs + S)
    args = _inputs(rng, 2, S, 2, hs)
    got_o, got_h = tref.rwkv6_wkv_chunked_ref(
        *map(torch.from_numpy, args), chunk=twkv.kernel_chunk(64))
    for (want_o, want_h), name in zip(_both(args, 64), ("pallas", "plain")):
        _close(got_o, want_o, f"o vs {name}")
        _close(got_h, want_h, f"h_last vs {name}")


def test_rwkv_model_on_the_default_chunk_matches_pallas(monkeypatch):
    """rwkv6-1.6b's smoke configuration with ``RWKVConfig``'s default
    chunk (64) through the port's ``impl="kernel"`` dispatch, against the
    reference's ``impl="pallas"`` in interpret mode on the same weights:
    logits within the model tests' fp32 tolerance, and the WKV states
    of the prefill within this file's."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    chunk = RWKVConfig().chunk
    jc = jget("rwkv6-1.6b", smoke=True)
    tc = get_config("rwkv6-1.6b", smoke=True)
    jc = dataclasses.replace(jc, rwkv=dataclasses.replace(jc.rwkv,
                                                          chunk=chunk))
    tc = dataclasses.replace(tc, rwkv=dataclasses.replace(tc.rwkv,
                                                          chunk=chunk))
    jp = jzoo.init_params(jc, 0)
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = np.random.default_rng(64).integers(
        0, jc.vocab_size, size=(2, chunk + 13)).astype(np.int32)
    want, _ = jzoo.forward_lm(jp, jc, {"tokens": jnp.asarray(toks)},
                              impl="pallas")
    got, _ = tzoo.forward_lm(tp, tc, {"tokens": torch.from_numpy(toks)},
                             impl="kernel")
    real = slice(0, jc.vocab_size)
    np.testing.assert_allclose(got.numpy()[..., real],
                               np.asarray(want)[..., real],
                               rtol=1e-4, atol=1e-4)
    _, jcache = jzoo.prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                             max_len=chunk + 16, impl="pallas")
    _, tcache = tzoo.prefill(tp, tc, {"tokens": torch.from_numpy(toks)},
                             max_len=chunk + 16, impl="kernel")
    jw = [np.asarray(x) for x in jax.tree.leaves(jcache)]
    tw = [t.numpy() for t in tree_leaves(tcache)]
    assert [a.shape for a in jw] == [b.shape for b in tw]
    for a, b in zip(tw, jw):
        _close(a, b, "prefill cache")
