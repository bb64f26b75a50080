"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU each wrapper of the port runs its kernel's plain version;
these tests hold those plain versions to the JAX package's Pallas
kernels (in interpret mode) and to its jnp oracles (``repro.kernels.ref``)
on the same inputs, made from a seed with numpy, over the shape sweeps of
``tests/test_kernel_oracles.py``. The CUDA kernels themselves are held
to the same plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.countmin import countmin_update as jx_cms
from repro.kernels.countmin import countmin_update_query as jx_cms_uq
from repro.kernels.ef_codec import (ef_int8_roundtrip as jx_ef_int8,
                                    ef_topk_int8_roundtrip as jx_ef_topk)
from repro.kernels.preprocess import fused_hash_features as jx_hash
from repro.kernels.mamba_scan import mamba_scan_bd as jx_mamba
from repro.kernels.preprocess import fused_normalize as jx_normalize
from repro.streams import drift as jdrift

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.detector_scan import detector_scan_plain
from repro_torch.streams import drift as tdrift


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# fused normalize: tolerance-equal (reduction order differs)
# ---------------------------------------------------------------------------

def _norm_case(seed, impute):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 200))
    d = int(rng.integers(1, 40))
    n0 = float(rng.integers(0, 500))
    mean0 = rng.normal(size=d).astype(np.float32)
    m20 = ((rng.random(d) + 0.1) * max(n0, 1.0)).astype(np.float32)
    x = (rng.normal(size=(n, d)) + rng.normal(size=d)).astype(np.float32)
    if impute:
        x[rng.random((n, d)) < 0.15] = np.nan
    return x, n0, mean0, m20


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("impute", [True, False])
def test_fused_normalize_plain_matches_jax(seed, impute):
    x, n0, mean0, m20 = _norm_case(seed, impute)
    got = kops.fused_normalize(_t(x), n0, _t(mean0), _t(m20), impute=impute)
    want = jref.fused_normalize_ref(x, n0, mean0, m20, impute=impute)
    # both centre first; only the summation order differs
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    # the Pallas kernel (raw moments): its own oracle-test tolerances
    pk = jx_normalize(jnp.asarray(x), n0, mean0, m20, impute=impute,
                      interpret=True)
    np.testing.assert_allclose(float(got[1]), float(pk[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(pk[2]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(pk[3]),
                               rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pk[0]),
                               rtol=1e-3, atol=1e-3)
    assert not torch.isnan(got[0]).any()


def test_fused_normalize_plain_is_impute_then_norm_update():
    """The CPU path of norm_impute_fused is exactly the composition of
    impute_with_mean and norm_update_apply, as in the JAX package."""
    from repro_torch.streams import preprocess as prep
    x, n0, mean0, m20 = _norm_case(11, True)
    st = prep.NormState(torch.tensor(n0), _t(mean0), _t(m20))
    st2, y2 = prep.norm_update_apply(st, prep.impute_with_mean(st, _t(x)))
    st3, y3 = prep.norm_impute_fused(st, _t(x))
    assert torch.equal(y2, y3)
    for a, b in zip(st2, st3):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# feature hashing: bitwise, including wrapping and negative ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("id_range", ["small", "full_int32"])
def test_hash_features_plain_bitwise(seed, id_range):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 150))
    f = int(rng.integers(1, 9))
    dim = int(rng.choice([16, 64, 256]))
    lo, hi = (0, 1 << 20) if id_range == "small" else (-2 ** 31, 2 ** 31)
    ids = rng.integers(lo, hi, (n, f), dtype=np.int64).astype(np.int32)
    vals = rng.normal(size=(n, f)).astype(np.float32)
    got = kops.hash_features(_t(ids), _t(vals), dim, seed=seed + 1).numpy()
    want = jref.hash_features_ref(jnp.asarray(ids), jnp.asarray(vals), dim,
                                  seed=seed + 1)
    np.testing.assert_array_equal(got, np.asarray(want))
    pk = jx_hash(jnp.asarray(ids), jnp.asarray(vals), dim, seed=seed + 1,
                 block=64, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pk))


def test_hash_wraps_in_int32_and_floors():
    """Ids whose hash wraps negative in int32: floor semantics keep every
    slot in range and match jnp's % and //."""
    ids = np.array([[2 ** 31 - 1, -2 ** 31, -1, 61356675, -61356676]],
                   np.int32)
    vals = np.arange(1, 6, dtype=np.float32)[None]
    slot, odd = tref.hash_slots(_t(ids), 96, seed=17)
    h = (jnp.asarray(ids) * 35 + 0x9E37) % 2_147_483_647
    np.testing.assert_array_equal(slot.numpy(), np.asarray(h % 96))
    np.testing.assert_array_equal(odd.numpy(), np.asarray((h // 96) % 2 == 1))
    got = kops.hash_features(_t(ids), _t(vals), 96).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.hash_features_ref(ids, vals, 96)))


# ---------------------------------------------------------------------------
# EF codecs: <= 1 ulp against JAX, the EF identity exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_ef_int8_plain_matches_jax(seed):
    rng = np.random.default_rng(300 + seed)
    shape = tuple(int(s) for s in rng.integers(1, 60,
                                                size=int(rng.integers(1, 3))))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    res = (rng.normal(size=shape) * 0.01).astype(np.float32)
    dec, rout = kops.ef_int8_roundtrip(_t(res), _t(x))
    # exact EF identity: decoded + residual' == x + residual
    assert torch.equal(dec + rout, _t(x) + _t(res))
    for want in (jref.ef_int8_roundtrip_ref(jnp.asarray(res), jnp.asarray(x)),
                 jx_ef_int8(jnp.asarray(res), jnp.asarray(x), block=512,
                            interpret=True)):
        np.testing.assert_allclose(dec.numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rout.numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-6)
    assert len(np.unique(dec.numpy())) <= 255


@pytest.mark.parametrize("seed", range(5))
def test_ef_topk_int8_plain_matches_jax_tie_free(seed):
    rng = np.random.default_rng(400 + seed)
    size = int(rng.integers(4, 3000))
    k = int(rng.integers(1, size + 1))
    x = rng.normal(size=size).astype(np.float32)
    res = (rng.normal(size=size) * 0.05).astype(np.float32)
    dec, rout = kops.ef_topk_int8_roundtrip(_t(res), _t(x), k)
    assert torch.equal(dec + rout, _t(x) + _t(res))
    for want in (jref.ef_topk_int8_roundtrip_ref(jnp.asarray(res),
                                                 jnp.asarray(x), k),
                 jx_ef_topk(jnp.asarray(res), jnp.asarray(x), k, block=512,
                            interpret=True)):
        np.testing.assert_allclose(dec.numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rout.numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-6)
    assert int((dec != 0).sum()) == k      # tie-free: exactly k survive


def test_ef_topk_int8_keeps_every_tie():
    """Selection by threshold: every coordinate tied with the k-th
    largest magnitude survives, as in the Pallas kernel (an exact top-k
    index mask would keep only k)."""
    x = np.array([3.0, -2.0, 2.0, 2.0, -2.0, 1.0, 0.5, -0.25], np.float32)
    res = np.zeros_like(x)
    dec, rout = kops.ef_topk_int8_roundtrip(_t(res), _t(x), 2)
    assert int((dec != 0).sum()) == 5          # 3.0 and all four |2.0|
    pk = jx_ef_topk(jnp.asarray(res), jnp.asarray(x), 2, block=16,
                    interpret=True)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(pk[0]))
    np.testing.assert_array_equal(rout.numpy(), np.asarray(pk[1]))
    assert torch.equal(dec + rout, _t(x))


def test_ef_residual_stays_bounded_over_stream():
    rng = np.random.default_rng(9)
    res = torch.zeros(257)
    for _ in range(50):
        x = _t(rng.normal(size=257).astype(np.float32))
        dec, res = kops.ef_int8_roundtrip(res, x)
    assert float(res.abs().max()) < 2.5 * float(x.abs().max()) / 127


# ---------------------------------------------------------------------------
# detector scan: the plain loop level for level against lax.scan
# ---------------------------------------------------------------------------

def _err_stream(seed, n=900):
    rng = np.random.default_rng(seed)
    p = np.where(np.arange(n) < n // 2, 0.1, 0.55)
    return (rng.random(n) < p).astype(np.float32)


_DETECTORS = {
    "ddm": (jdrift.ddm_init, jdrift.ddm_step, tdrift.ddm_init,
            tdrift.ddm_step),
    "eddm": (jdrift.eddm_init, jdrift.eddm_step, tdrift.eddm_init,
             tdrift.eddm_step),
    "ph": (jdrift.ph_init, jdrift.ph_step, tdrift.ph_init, tdrift.ph_step),
}


@pytest.mark.parametrize("detector", sorted(_DETECTORS))
@pytest.mark.parametrize("seed", range(2))
def test_detector_scan_plain_matches_lax_scan(detector, seed):
    jinit, jstep, tinit, tstep = _DETECTORS[detector]
    err = _err_stream(seed)
    jstate, jlevels = jax.lax.scan(jstep, jinit(), jnp.asarray(err))
    tstate, tlevels = tdrift.run_detector(tstep, tinit(), _t(err))
    np.testing.assert_array_equal(tlevels.numpy(), np.asarray(jlevels))
    # levels are equal event for event; the state floats agree to an ulp
    # (XLA on the CPU contracts a*b+c into one FMA, the port never does)
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    # the wrapper's CPU path is this loop, with the any-drift flag
    st, flag = kops.detector_scan(detector, tinit(), _t(err))
    assert bool(flag) == bool((np.asarray(jlevels) == 2).any())
    for a, b in zip(st, tstate):
        assert torch.equal(a, b)


def test_detector_scan_plain_continues_from_carried_state():
    """Scanning two halves with the state carried equals one scan."""
    err = _t(_err_stream(5))
    s1, f1 = detector_scan_plain("ddm", tdrift.ddm_init(), err[:450])
    s2, f2 = detector_scan_plain("ddm", s1, err[450:])
    s, f = detector_scan_plain("ddm", tdrift.ddm_init(), err)
    for a, b in zip(s2, s):
        assert torch.equal(a, b)
    assert bool(f) == (bool(f1) or bool(f2))


# ---------------------------------------------------------------------------
# count-min: bitwise, ids over the whole int32 range
# ---------------------------------------------------------------------------

def _cms_case(seed, id_range):
    """``test_kernel_oracles.py``'s sweep of n, depth, width and block."""
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(5, 2000))
    depth = int(rng.integers(1, 5))
    width = int(rng.choice([32, 128, 512]))
    block = int(rng.choice([64, 1024]))
    lo, hi = (0, 50_000) if id_range == "small" else (-2 ** 31, 2 ** 31)
    ids = rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)
    seeds = (rng.integers(1, 2**14, (depth, 2)) * 2 + 1).astype(np.int32)
    table = rng.integers(0, 100, (depth, width)).astype(np.int32)
    return ids, seeds, table, block


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("id_range", ["small", "full_int32"])
def test_countmin_plain_bitwise_with_jax_kernels(seed, id_range):
    ids, seeds, table, block = _cms_case(seed, id_range)
    depth, width = table.shape
    inc = kops.countmin_update(_t(ids), depth, width, _t(seeds)).numpy()
    np.testing.assert_array_equal(
        inc, np.asarray(jref.countmin_ref(jnp.asarray(ids), depth, width,
                                          seeds)))
    np.testing.assert_array_equal(
        inc, np.asarray(jx_cms(jnp.asarray(ids), depth, width,
                               jnp.asarray(seeds), block=block,
                               interpret=True)))
    new, est = kops.countmin_update_query(_t(ids), _t(table), _t(seeds))
    want_t, want_e = jref.countmin_update_query_ref(
        jnp.asarray(ids), jnp.asarray(table), jnp.asarray(seeds))
    np.testing.assert_array_equal(new.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(est.numpy(), np.asarray(want_e))
    pk_t, pk_e = jx_cms_uq(jnp.asarray(ids), jnp.asarray(table),
                           jnp.asarray(seeds), block=block, interpret=True)
    np.testing.assert_array_equal(new.numpy(), np.asarray(pk_t))
    np.testing.assert_array_equal(est.numpy(), np.asarray(pk_e))


def test_countmin_hash_wraps_in_int32_and_floors():
    """Ids whose ``id * a + b`` wraps negative in int32 land in range, on
    the slot jnp's floor-mod gives."""
    from repro.kernels.countmin import hash_ids
    ids = np.array([2 ** 31 - 1, -2 ** 31, -1, 16_777_215, -16_777_216,
                    123_456_789], np.int32)
    a, b = 32_767, 30_001
    assert ((ids.astype(np.int64) * a + b) > 2 ** 31 - 1).any()
    got = tref.cms_hash(_t(ids), a, b, 1000)
    want = hash_ids(jnp.asarray(ids), jnp.int32(a), jnp.int32(b), 1000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 0 and int(got.max()) < 1000


def test_countmin_update_query_exact_above_2_24():
    """With every cell at 2^24 + 1 the port equals the int32 oracle; the
    JAX package's fused kernel, which counts in fp32, does not (ROADMAP
    fault 9)."""
    rng = np.random.default_rng(9)
    depth, width = 3, 64
    ids = rng.integers(0, 5000, 777).astype(np.int32)
    seeds = (rng.integers(1, 2**14, (depth, 2)) * 2 + 1).astype(np.int32)
    table = np.full((depth, width), 2 ** 24 + 1, np.int32)
    new, est = kops.countmin_update_query(_t(ids), _t(table), _t(seeds))
    want_t, want_e = jref.countmin_update_query_ref(
        jnp.asarray(ids), jnp.asarray(table), jnp.asarray(seeds))
    np.testing.assert_array_equal(new.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(est.numpy(), np.asarray(want_e))
    assert int(new.min()) > 2 ** 24
    pk_t, pk_e = jx_cms_uq(jnp.asarray(ids), jnp.asarray(table),
                           jnp.asarray(seeds), interpret=True)
    assert not np.array_equal(np.asarray(pk_t), np.asarray(want_t))
    assert int(np.abs(np.asarray(pk_e) - np.asarray(want_e)).max()) <= 2


def test_countmin_update_query_leaves_the_table_alone():
    ids, seeds, table, _ = _cms_case(0, "small")
    t = _t(table)
    kops.countmin_update_query(_t(ids), t, _t(seeds))
    np.testing.assert_array_equal(t.numpy(), table)


# ---------------------------------------------------------------------------
# Misra-Gries: the plain loop bitwise against the reference's lax.scan
# ---------------------------------------------------------------------------

def _mg_stream(kind, seed, n=1500):
    rng = np.random.default_rng(300 + seed)
    if kind == "heavy":      # two heavy hitters over a long tail
        u = rng.random(n)
        ids = np.where(u < 0.3, 7, np.where(u < 0.45, 11,
                                            rng.integers(100, 10_000, n)))
    elif kind == "churn":    # few distinct ids: decrements leave stale keys
        ids = rng.integers(0, 200, n)
    else:                    # -1 ids, which match an empty slot's key
        ids = np.where(rng.random(n) < 0.2, -1, rng.integers(-5, 60, n))
    return ids.astype(np.int32)


def _mg_jax(keys, counts, ids):
    from repro.streams import sketches as jsk
    mg = jax.jit(jsk.mg_update)(jsk.MisraGries(jnp.asarray(keys),
                                               jnp.asarray(counts)),
                                jnp.asarray(ids))
    return np.array(mg.keys), np.array(mg.counts)


@pytest.mark.parametrize("k", [1, 16, 64])
@pytest.mark.parametrize("kind", ["heavy", "churn", "negative"])
def test_mg_plain_bitwise_with_lax_scan(k, kind):
    ids = _mg_stream(kind, k)
    keys0 = np.full(k, -1, np.int32)
    counts0 = np.zeros(k, np.int32)
    wk, wc = _mg_jax(keys0, counts0, ids)
    gk, gc = kops.mg_scan(_t(keys0), _t(counts0), _t(ids))
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gc.numpy(), wc)
    # and on from a carried state holding stale keys (count 0) that the
    # stream hits
    wk[::3] = np.arange(0, k, 3)
    wc[::3] = 0
    more = _mg_stream(kind, k + 100, n=400)
    wk2, wc2 = _mg_jax(wk, wc, more)
    gk2, gc2 = tref.mg_update_ref(_t(wk), _t(wc), _t(more))
    np.testing.assert_array_equal(gk2.numpy(), wk2)
    np.testing.assert_array_equal(gc2.numpy(), wc2)


# ---------------------------------------------------------------------------
# Mamba selective scan: fp32 within 1e-5
# ---------------------------------------------------------------------------

def _mamba_case(seed, B, S, dI, N):
    rng = np.random.default_rng(700 + seed)
    z = rng.normal(size=(B, S, dI)).astype(np.float32)
    dt = np.log1p(np.exp(z - 2.0)).astype(np.float32)         # softplus
    x = rng.normal(size=(B, S, dI)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    A = -np.exp(rng.normal(size=(dI, N)) * 0.5).astype(np.float32)
    h0 = rng.normal(size=(B, dI, N)).astype(np.float32)
    return dt, x, Bm, Cm, A, h0


@pytest.mark.parametrize("B,S,dI,N,chunk,bd", [
    (1, 21, 64, 4, 8, 32),       # ragged: S % chunk != 0
    (2, 32, 64, 16, 16, 32),
    (2, 1, 32, 16, 8, 32),       # a decode step
])
def test_mamba_plain_matches_jax_kernel_and_oracle(B, S, dI, N, chunk, bd):
    ins = _mamba_case(S, B, S, dI, N)
    y, h = kops.mamba_scan(*[_t(a) for a in ins], chunk=chunk, bd=bd)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, dI) and h.shape == (B, dI, N)
    jin = [jnp.asarray(a) for a in ins]
    for wy, wh in (jref.mamba_scan_ref(*jin),
                   jx_mamba(*jin, chunk=chunk, bd=bd, interpret=True)):
        # fp32 per-step recurrences on both sides; only the order of the
        # sum over N and XLA's contractions differ
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=1e-5,
                                   atol=1e-5)


def test_mamba_scan_continues_from_carried_state():
    """Two halves with h carried equal one scan (the decode contract)."""
    dt, x, Bm, Cm, A, h0 = (_t(a) for a in _mamba_case(3, 1, 12, 32, 8))
    y, h = kops.mamba_scan(dt, x, Bm, Cm, A, h0)
    y1, h1 = kops.mamba_scan(dt[:, :5], x[:, :5], Bm[:, :5], Cm[:, :5], A, h0)
    y2, h2 = kops.mamba_scan(dt[:, 5:], x[:, 5:], Bm[:, 5:], Cm[:, 5:], A, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_sketch_and_scan_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    kops.reset_launch_counts()
    ids = torch.arange(10, dtype=torch.int32)
    seeds = torch.tensor([[3, 5], [7, 9]], dtype=torch.int32)
    kops.countmin_update(ids, 2, 16, seeds)
    kops.countmin_update_query(ids, torch.zeros(2, 16, dtype=torch.int32),
                               seeds)
    kops.mg_scan(torch.full((4,), -1, dtype=torch.int32),
                 torch.zeros(4, dtype=torch.int32), ids)
    dt, x, Bm, Cm, A, h0 = (_t(a) for a in _mamba_case(0, 1, 3, 32, 4))
    kops.mamba_scan(dt, x, Bm, Cm, A, h0)
    counts = kops.launch_counts()
    for name in ("countmin_update", "countmin_update_query", "mg_scan",
                 "mamba_scan"):
        assert counts[name] == 0
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kops.countmin_update(meta, 2, 16, seeds)
    with pytest.raises(ValueError):
        kops.countmin_update_query(meta, meta[:4].reshape(2, 2), seeds)
    with pytest.raises(ValueError):
        kops.mg_scan(meta[:4], meta[:4], meta)
    with pytest.raises(ValueError):
        kops.mamba_scan(*(t.to("meta") for t in (dt, x, Bm, Cm, A, h0)))


# ---------------------------------------------------------------------------
# dispatch: CPU runs the plain version uncounted; other devices raise
# ---------------------------------------------------------------------------

def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    kops.reset_launch_counts()
    x = torch.randn(8, 4)
    kops.ef_int8_roundtrip(torch.zeros(8, 4), x)
    kops.ef_topk_int8_roundtrip(torch.zeros(8, 4), x, 3)
    kops.fused_normalize(x, 0.0, torch.zeros(4), torch.zeros(4))
    kops.hash_features(torch.zeros(8, 2, dtype=torch.int32), x[:, :2], 16)
    kops.detector_scan("ddm", tdrift.ddm_init(), torch.zeros(5))
    assert set(kops.launch_counts().values()) == {0}
    meta = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError):
        kops.ef_int8_roundtrip(meta, meta)
    with pytest.raises(ValueError):
        kops.ef_topk_int8_roundtrip(meta, meta, 3)
    with pytest.raises(ValueError):
        kops.fused_normalize(meta, 0.0, meta[0], meta[0])
    with pytest.raises(ValueError):
        kops.hash_features(meta.to(torch.int32), meta, 16)
    with pytest.raises(ValueError):
        kops.detector_scan("ddm", tdrift.ddm_init("meta"), meta[:, 0])
    # ADWIN scans through the same entry: on the CPU its plain loop, no
    # kernel launched; an unknown detector is refused
    st, drifted = kops.detector_scan("adwin", tdrift.adwin_init(),
                                     torch.zeros(3))
    assert int(st.n_buckets[0]) == 3 and not bool(drifted)
    assert set(kops.launch_counts().values()) == {0}
    with pytest.raises(KeyError):
        kops.detector_scan("cusum", tdrift.adwin_init(), torch.zeros(3))


# ---------------------------------------------------------------------------
# the build: from the checkout's sources, named by content
# ---------------------------------------------------------------------------

def test_build_names_libraries_by_content_and_needs_nvcc(monkeypatch,
                                                         tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for n, p in paths.items():
        assert p.parent == tmp_path and p.name.startswith(f"lib{n}_")
        assert (_build.CSRC / f"{n}.cu").is_file()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("ef_codec") != paths["ef_codec"]
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["ef_codec"])
    assert not list(tmp_path.glob("*.so"))
