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
from repro.kernels.ef_codec import (ef_int8_roundtrip as jx_ef_int8,
                                    ef_topk_int8_roundtrip as jx_ef_topk)
from repro.kernels.preprocess import fused_hash_features as jx_hash
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
    with pytest.raises(KeyError):
        kops.detector_scan("adwin", tdrift.adwin_init(), torch.zeros(3))


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
