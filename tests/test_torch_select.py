"""The top-k EF codec's radix select and round-trip, and count-min's
add-then-query on skewed ids, against the JAX package.

``ref.topk_threshold_radix`` runs the digit passes of the CUDA select
(``csrc/ef_codec.cu``) in torch ops; it must give the k-th largest
``|x + r|`` bitwise as ``jax.lax.top_k`` and ``torch.topk`` give it, on
inputs built to stress the digits: equal magnitudes, signed zeros and
subnormals, k at both ends, sizes off every block size, magnitudes that
share their top one or two digits, NaN. The round-trip the port's
wrappers run on the CPU (``ef_topk_int8_roundtrip``, which takes that
select) is held to the Pallas kernel in interpret mode. Inputs come from
a seed through numpy; the card runs the same checks in
``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.countmin import countmin_update_query as jx_cms_uq
from repro.kernels.ef_codec import ef_topk_int8_roundtrip as jx_ef_topk

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref


def _bits(t) -> int:
    return int(torch.tensor(np.array(t), dtype=torch.float32)
               .view(torch.int32))


def _same(a, b) -> bool:
    """Bitwise equal, or both NaN (NaN payloads are not compared)."""
    fa, fb = float(a), float(b)
    if np.isnan(fa) or np.isnan(fb):
        return np.isnan(fa) and np.isnan(fb)
    return _bits(a) == _bits(b)


def _from_digits(d1, d2, d3):
    """Magnitudes with the given key digits (``SELECT_DIGITS``)."""
    keys = (np.asarray(d1, np.int64) << 19) | (np.asarray(d2, np.int64) << 9) \
        | np.asarray(d3, np.int64)
    return keys.astype(np.int32).view(np.float32)


def _case(name, rng):
    """``(x, r)`` float32 for each select case; the select takes
    ``|x + r|``."""
    if name == "equal":
        x = np.full(3001, -1.5, np.float32)
        x[::2] = 1.5
        return x, np.zeros_like(x)
    if name == "zeros_subnormals":
        sub = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                        1.1754944e-38, 2e-38], np.float32)
        x = rng.choice(sub, 2049).astype(np.float32)
        return x, np.zeros_like(x)
    if name == "odd_size":
        x = rng.normal(size=4099).astype(np.float32)
        return x, (rng.normal(size=4099) * 0.05).astype(np.float32)
    if name == "shared_digit1":       # every key in one top digit
        n = 5003
        x = _from_digits(np.full(n, 2030), rng.integers(0, 1024, n),
                         rng.integers(0, 512, n))
        return x * np.where(rng.random(n) < 0.5, -1, 1).astype(np.float32), \
            np.zeros(n, np.float32)
    if name == "shared_digit12":      # top two digits shared, ties in the last
        n = 4500
        x = _from_digits(np.full(n, 2030), np.full(n, 517),
                         rng.integers(0, 40, n))
        return x, np.zeros(n, np.float32)
    if name == "nan":
        x = rng.normal(size=1000).astype(np.float32)
        x[[3, 500]] = np.nan
        x[7] = np.inf
        return x, np.zeros_like(x)
    if name == "n_2_20":
        n = 1 << 20
        x = rng.normal(size=n).astype(np.float32)
        return x, (rng.normal(size=n) * 0.01).astype(np.float32)
    raise KeyError(name)


CASES = ("equal", "zeros_subnormals", "odd_size", "shared_digit1",
         "shared_digit12", "nan", "n_2_20")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("which_k", ["one", "tenth", "all"])
def test_radix_select_is_top_k_bitwise(name, which_k):
    rng = np.random.default_rng(CASES.index(name))
    x, r = _case(name, rng)
    mag = np.abs(x + r)
    n = mag.size
    k = {"one": 1, "tenth": max(1, round(0.1 * n)), "all": n}[which_k]
    got = tref.topk_threshold_radix(torch.from_numpy(mag), k)
    assert got.shape == () and got.dtype == torch.float32
    want_jax = jax.lax.top_k(jnp.asarray(mag), k)[0][-1]
    want_torch = torch.topk(torch.from_numpy(mag), k).values[-1]
    assert _same(got, want_jax), (float(got), float(want_jax))
    assert _same(got, want_torch), (float(got), float(want_torch))
    if not np.isnan(mag).any():
        assert _same(got, tref.topk_threshold(torch.from_numpy(mag), k))


def test_radix_select_orders_nan_above_inf():
    mag = np.array([1.0, np.inf, np.nan, 2.0, np.nan], np.float32)
    t = [float(tref.topk_threshold_radix(torch.from_numpy(mag), k))
         for k in range(1, 6)]
    assert np.isnan(t[0]) and np.isnan(t[1])
    assert t[2:] == [np.inf, 2.0, 1.0]


def test_radix_select_refuses_empty_and_clamps_k():
    with pytest.raises(ValueError):
        tref.topk_threshold_radix(torch.zeros(0), 1)
    a = torch.tensor([3.0, 1.0, 2.0])
    assert float(tref.topk_threshold_radix(a, 0)) == 3.0
    assert float(tref.topk_threshold_radix(a, 7)) == 1.0


@pytest.mark.parametrize("name", ["odd_size", "shared_digit1",
                                  "zeros_subnormals"])
def test_topk_roundtrip_matches_pallas_kernel(name):
    rng = np.random.default_rng(40 + CASES.index(name))
    x, r = _case(name, rng)
    k = max(1, round(0.1 * x.size))
    dec, rout = kops.ef_topk_int8_roundtrip(torch.from_numpy(r),
                                            torch.from_numpy(x), k)
    assert torch.equal(dec + rout, torch.from_numpy(x) + torch.from_numpy(r))
    pk = jx_ef_topk(jnp.asarray(r), jnp.asarray(x), k, block=512,
                    interpret=True)
    np.testing.assert_allclose(dec.numpy(), np.asarray(pk[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rout.numpy(), np.asarray(pk[1]), rtol=0,
                               atol=1e-6)
    mag = torch.from_numpy(np.abs(x + r))
    kept = mag >= tref.topk_threshold_radix(mag, k)
    assert int(kept.sum()) >= k and not bool((dec != 0)[~kept].any())


@pytest.mark.parametrize("name", ["equal", "shared_digit12"])
def test_topk_roundtrip_keeps_planted_ties_bitwise(name):
    rng = np.random.default_rng(60 + CASES.index(name))
    x, r = _case(name, rng)
    mag = np.abs(x + r)
    k = max(1, round(0.1 * x.size))
    t = np.sort(mag)[::-1][k - 1]
    ties = int((mag == t).sum())
    assert ties > 1
    dec, rout = kops.ef_topk_int8_roundtrip(torch.from_numpy(r),
                                            torch.from_numpy(x), k)
    pk = jx_ef_topk(jnp.asarray(r), jnp.asarray(x), k, block=512,
                    interpret=True)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(pk[0]))
    np.testing.assert_array_equal(rout.numpy(), np.asarray(pk[1]))
    kept = int((dec != 0).sum())
    assert kept == int((mag >= t).sum()) >= k      # every tie kept


def test_topk_roundtrip_with_nan_keeps_nothing():
    """A NaN makes the threshold NaN, as ``torch.topk(...).min()`` made it
    on the path before the radix select: every coordinate decodes to 0
    and the residual carries all of ``x + r``."""
    rng = np.random.default_rng(77)
    x, r = _case("nan", rng)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    k = 100
    dec, rout = kops.ef_topk_int8_roundtrip(rt, xt, k)
    assert not bool(dec.any())
    assert torch.equal(rout.view(torch.int32), (xt + rt).view(torch.int32))
    # the same as the round-trip through torch.topk's threshold
    xc = xt + rt
    t = tref.topk_threshold(torch.abs(xc), k)
    assert torch.isnan(t) and not bool((torch.abs(xc) >= t).any())


# ---------------------------------------------------------------------------
# count-min add-then-query on the summarization path's kind of stream
# ---------------------------------------------------------------------------

def _zipf_ids(rng, n, heavy_share=0.25):
    """Zipf-like ids over the whole int32 range, negatives included, with
    one id at about ``heavy_share`` of the stream."""
    tail = (rng.zipf(1.3, n) * 2_654_435_761) % (2 ** 32) - 2 ** 31
    ids = np.where(rng.random(n) < heavy_share, -123_456_789, tail)
    return ids.astype(np.int64).astype(np.int32)


@pytest.mark.parametrize("width", [1024, 1 << 16])
@pytest.mark.parametrize("seed", range(2))
def test_countmin_update_query_on_skewed_ids_bitwise(width, seed):
    rng = np.random.default_rng(500 + seed)
    n, depth = 1500, 4
    ids = _zipf_ids(rng, n)
    assert (ids < 0).any() and np.mean(ids == -123_456_789) > 0.2
    seeds = (rng.integers(1, 2 ** 14, (depth, 2)) * 2 + 1).astype(np.int32)
    table = rng.integers(0, 1000, (depth, width)).astype(np.int32)
    new, est = kops.countmin_update_query(torch.from_numpy(ids),
                                          torch.from_numpy(table),
                                          torch.from_numpy(seeds))
    want_t, want_e = jref.countmin_update_query_ref(
        jnp.asarray(ids), jnp.asarray(table), jnp.asarray(seeds))
    np.testing.assert_array_equal(new.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(est.numpy(), np.asarray(want_e))
    pk_t, pk_e = jx_cms_uq(jnp.asarray(ids), jnp.asarray(table),
                           jnp.asarray(seeds), block=256, interpret=True)
    np.testing.assert_array_equal(new.numpy(), np.asarray(pk_t))
    np.testing.assert_array_equal(est.numpy(), np.asarray(pk_e))
