"""The port's uplink codecs (``repro_torch.core.codecs``) against the JAX
package's: every registered codec over a 50-step stream, their error
bounds, and the registry with its parameterised names."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import codecs as jcd
from repro_torch.core import codecs as tcd


def _t(a):
    return torch.from_numpy(np.array(a))


GRADIENT = ["identity", "int8_ef", "topk_ef", "topk_int8_ef",
            "topk_ef_k0.25", "topk_int8_ef_k0.05"]
KV = ["kv_int8", "kv_latent", "kv_latent_r0.25"]


@pytest.mark.parametrize("name", GRADIENT + KV)
def test_codec_stream_matches_jax(name):
    """50 round-trips with the residual carried: the decoded stream and
    the carried residual agree with the JAX package's at every step
    (tie-free Gaussian payloads, so top-k selection is the same set)."""
    jc, tc = jcd.get_codec(name), tcd.get_codec(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = (24, 16)
    jr = jc.init_residual(jnp.zeros(shape))
    tr = tc.init_residual(torch.zeros(shape))
    for _ in range(50):
        x = (rng.normal(size=shape) * 1e-2).astype(np.float32)
        jd, jr = jc.roundtrip(jr, jnp.asarray(x))
        td, tr = tc.roundtrip(tr, _t(x))
        assert td.shape == shape and td.dtype == torch.float32
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["int8_ef", "topk_ef", "topk_int8_ef"])
@pytest.mark.parametrize("constant", [True, False])
def test_gradient_codec_error_within_admitted_bound(name, constant):
    """The accumulated error of the port's round-trip IS the residual
    (telescoping EF identity) and stays within the admitted bound."""
    codec = tcd.get_codec(name)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        d, steps = 256, 50
        g = _t(rng.normal(scale=1e-2, size=d).astype(np.float32))
        residual = codec.init_residual(g)
        cum_true = np.zeros(d, np.float64)
        cum_dec = np.zeros(d, np.float64)
        amax = 0.0
        for _ in range(steps):
            x = g if constant else _t(
                rng.normal(scale=1e-2, size=d).astype(np.float32))
            amax = max(amax, float(x.abs().max()))
            dec, residual = codec.roundtrip(residual, x)
            cum_true += x.double().numpy()
            cum_dec += dec.double().numpy()
        np.testing.assert_allclose(cum_dec + residual.double().numpy(),
                                   cum_true, rtol=1e-4, atol=1e-5)
        err = float(np.max(np.abs(cum_dec - cum_true)))
        assert err <= codec.error_bound * amax + 1e-6, (name, seed, err)


def test_kv_codecs_within_their_bounds():
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(64, 32)).astype(np.float32))
    c = tcd.get_codec("kv_int8")
    dec, r = c.roundtrip(c.init_residual(x), x)
    assert float((dec - x).abs().max()) / float(x.abs().max()) \
        <= c.error_bound * 1.001
    assert torch.equal(r, torch.zeros_like(x))     # no error feedback
    for r_frac in (0.5, 0.25):
        c = tcd.kv_latent_codec(r_frac)
        x = _t(rng.normal(size=(128, 64)).astype(np.float32))
        dec, _ = c.roundtrip(c.init_residual(x), x)
        rel = float(torch.linalg.norm(dec - x) / torch.linalg.norm(x))
        assert rel <= c.error_bound * 1.05, (r_frac, rel)


@pytest.mark.parametrize("name", GRADIENT + KV + ["topk_ef_k1"])
def test_registry_resolves_identically(name):
    jc, tc = jcd.get_codec(name), tcd.get_codec(name)
    assert (tc.name, tc.ratio, tc.error_bound, tc.lossless) == \
        (jc.name, jc.ratio, jc.error_bound, jc.lossless)


def test_ladders_and_bad_names_match():
    assert [c.name for c in tcd.DEFAULT_CODECS] == \
        [c.name for c in jcd.DEFAULT_CODECS]
    assert [c.name for c in tcd.KV_CODECS] == [c.name for c in jcd.KV_CODECS]
    for bad in ("nope", "topk_ef_k0", "topk_int8_ef_k2", "kv_latent_r0"):
        with pytest.raises(KeyError):
            jcd.get_codec(bad)
        with pytest.raises(KeyError):
            tcd.get_codec(bad)
