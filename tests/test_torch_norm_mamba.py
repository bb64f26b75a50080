"""The persistent normalize kernel's and the lane-split Mamba kernel's
arithmetic against the JAX package.

``ref.fused_normalize_slices_ref`` spells out the persistent CUDA
normalize (``csrc/preprocess.cu``, ``normalize_persistent``): each CTA's
slice of rows, its row lanes summed in row order and added in lane order,
the CTAs' partials added in CTA order, the merge from raw moments.
``ref.mamba_scan_lanes_ref`` spells out the lane-split scan
(``csrc/mamba_scan.cu``, ``mamba_scan_lanes``): A scaled by log2(e),
``exp2``, four lanes' partial sums combined in the shuffles' order. Each
is held to the Pallas kernel (interpret mode), to the JAX oracle and to
the port's plain version on inputs drawn with numpy from a seed. The
card runs the kernels themselves against the plain versions in
``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_bd as jx_mamba
from repro.kernels.preprocess import fused_normalize as jx_normalize

from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import preprocess as tpp
from repro_torch.kernels import ref as tref

NORM_TOL = 1e-4     # rtol and atol: raw moments summed in another order
MAMBA_TOL = 1e-5    # rtol and atol: exp2 of a pre-scaled A, lane sums


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# fused normalize: the persistent kernel's order of sums
# ---------------------------------------------------------------------------

# name: (n, d, impute, an all-NaN column, CTAs)
NORM_CASES = {
    "n_below_ctas": (50, 16, True, False, 132),
    "n_off_ctas": (1001, 24, True, False, 132),
    "n_off_few_ctas": (203, 12, True, False, 7),
    "n1": (1, 20, True, False, 132),
    "d8": (300, 8, True, False, 5),
    "d255": (300, 255, True, False, 5),        # 4-byte loads, 2 row lanes
    "nan_column": (257, 16, True, True, 9),
    "no_impute": (257, 16, False, False, 9),
}


def _norm_inputs(name):
    n, d, impute, nan_col, ctas = NORM_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n0 = float(rng.integers(0, 500))
    mean0 = rng.normal(size=d).astype(np.float32)
    m20 = ((rng.random(d) + 0.1) * max(n0, 1.0)).astype(np.float32)
    x = (rng.normal(size=(n, d)) * 2.0 + rng.normal(size=d)).astype(np.float32)
    if impute:
        x[rng.random((n, d)) < 0.15] = np.nan
    if nan_col:
        x[:, 3] = np.nan
    return x, n0, mean0, m20, impute, ctas


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(NORM_CASES))
def test_normalize_slices_twin_matches_jax_and_plain(name):
    x, n0, mean0, m20, impute, ctas = _norm_inputs(name)
    got = tref.fused_normalize_slices_ref(_t(x), n0, _t(mean0), _t(m20),
                                          impute=impute, ctas=ctas)
    assert got[0].shape == x.shape and torch.isfinite(got[0]).all()
    plain = tref.fused_normalize_ref(_t(x), n0, _t(mean0), _t(m20),
                                     impute=impute)
    _close([t.numpy() for t in got], [t.numpy() for t in plain], NORM_TOL)
    oracle = jref.fused_normalize_ref(x, n0, mean0, m20, impute=impute)
    _close([t.numpy() for t in got], oracle, NORM_TOL)
    pk = jx_normalize(jnp.asarray(x), n0, mean0, m20, impute=impute,
                      interpret=True)
    _close([t.numpy() for t in got],
           [np.asarray(pk[0]), np.asarray(pk[1]).reshape(()),
            np.asarray(pk[2]).reshape(-1), np.asarray(pk[3]).reshape(-1)],
           NORM_TOL)


@pytest.mark.parametrize("ctas", [1, 3, 132])
def test_normalize_slices_twin_is_deterministic_in_its_cta_count(ctas):
    """At a given CTA count the order is fixed: the same inputs give the
    same bits; across counts only the order of the partial sums moves."""
    x, n0, mean0, m20, impute, _ = _norm_inputs("n_off_ctas")
    args = (_t(x), n0, _t(mean0), _t(m20))
    a = tref.fused_normalize_slices_ref(*args, impute=impute, ctas=ctas)
    b = tref.fused_normalize_slices_ref(*args, impute=impute, ctas=ctas)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    other = tref.fused_normalize_slices_ref(*args, impute=impute, ctas=5)
    _close([t.numpy() for t in a], [t.numpy() for t in other], NORM_TOL)


def test_normalize_slices_twin_of_one_row_is_exact():
    """n = 1 leaves no order to choose: the twin is the plain version."""
    x, n0, mean0, m20, impute, ctas = _norm_inputs("n1")
    got = tref.fused_normalize_slices_ref(_t(x), n0, _t(mean0), _t(m20),
                                          impute=impute, ctas=ctas)
    want = tref.fused_normalize_ref(_t(x), n0, _t(mean0), _t(m20),
                                    impute=impute)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# Mamba: the lane-split scan's arithmetic
# ---------------------------------------------------------------------------

def _mamba_case(seed, B, S, dI, N):
    rng = np.random.default_rng(900 + seed)
    z = rng.normal(size=(B, S, dI)).astype(np.float32)
    dt = np.log1p(np.exp(z - 2.0)).astype(np.float32)         # softplus
    x = rng.normal(size=(B, S, dI)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    A = -np.exp(rng.normal(size=(dI, N)) * 0.5).astype(np.float32)
    h0 = rng.normal(size=(B, dI, N)).astype(np.float32)
    return dt, x, Bm, Cm, A, h0


# name: (B, S, dI, N, chunk and bd of the Pallas kernel)
MAMBA_CASES = {
    "ragged_s": (1, 21, 64, 16, 8, 32),        # S % chunk != 0
    "decode_h0": (2, 1, 32, 16, 8, 32),        # S = 1 from a nonzero h0
    "n4": (2, 19, 64, 4, 8, 64),
    "n16": (2, 32, 64, 16, 16, 32),
    "di_off_block": (2, 13, 72, 16, 8, 24),    # dI off the kernel's 64
    "n4_di_off_block": (1, 9, 100, 4, 4, 20),
}


@pytest.mark.parametrize("name", sorted(MAMBA_CASES))
def test_mamba_lanes_twin_matches_jax_and_plain(name):
    B, S, dI, N, chunk, bd = MAMBA_CASES[name]
    ins = _mamba_case(sum(map(ord, name)), B, S, dI, N)
    y, h = tref.mamba_scan_lanes_ref(*[_t(a) for a in ins])
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, dI) and h.shape == (B, dI, N)
    py, ph = tref.mamba_scan_ref(*[_t(a) for a in ins])
    np.testing.assert_allclose(y.numpy(), py.numpy(), rtol=MAMBA_TOL,
                               atol=MAMBA_TOL)
    np.testing.assert_allclose(h.numpy(), ph.numpy(), rtol=MAMBA_TOL,
                               atol=MAMBA_TOL)
    jin = [jnp.asarray(a) for a in ins]
    for wy, wh in (jref.mamba_scan_ref(*jin),
                   jx_mamba(*jin, chunk=chunk, bd=bd, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                   rtol=MAMBA_TOL, atol=MAMBA_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh),
                                   rtol=MAMBA_TOL, atol=MAMBA_TOL)


@pytest.mark.parametrize("N", [4, 16])
def test_mamba_lanes_twin_carries_its_state_across_calls(N):
    """Two calls with h carried equal one call bitwise, and the pair
    matches the Pallas kernel run over the whole sequence."""
    dt, x, Bm, Cm, A, h0 = (_t(a) for a in _mamba_case(N, 2, 14, 40, N))
    y, h = tref.mamba_scan_lanes_ref(dt, x, Bm, Cm, A, h0)
    y1, h1 = tref.mamba_scan_lanes_ref(dt[:, :6], x[:, :6], Bm[:, :6],
                                       Cm[:, :6], A, h0)
    y2, h2 = tref.mamba_scan_lanes_ref(dt[:, 6:], x[:, 6:], Bm[:, 6:],
                                       Cm[:, 6:], A, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    wy, wh = jx_mamba(*(jnp.asarray(t.numpy()) for t in
                        (dt, x, Bm, Cm, A, h0)), chunk=4, bd=40,
                      interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=MAMBA_TOL,
                               atol=MAMBA_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=MAMBA_TOL,
                               atol=MAMBA_TOL)


def test_mamba_lanes_twin_combines_lanes_in_shuffle_order():
    """y_t is (p0 + p1) + (p2 + p3) of the lanes' partial sums, each a
    lane's N / 4 terms in state order: checked on one step where the
    order shows (terms 1, 1e8 and -1e8 of states 0, 8 and 12)."""
    N = 16
    dt = torch.full((1, 1, 1), 1e-30)            # exp2(~0) = 1, dx ~ 0
    x = torch.zeros((1, 1, 1))
    Bm = torch.zeros((1, 1, N))
    A = -torch.ones((1, N))
    h0 = torch.ones((1, 1, N))
    Cm = torch.zeros((1, 1, N))
    Cm[0, 0, 0], Cm[0, 0, 8], Cm[0, 0, 12] = 1.0, 1e8, -1e8
    y, _ = tref.mamba_scan_lanes_ref(dt, x, Bm, Cm, A, h0)
    # lanes: (1 + 0) + (1e8 + -1e8) = 1; in state order 1 + 1e8 rounds
    # to 1e8 and the sum is 0
    assert float(y) == 1.0
    serial = torch.zeros(())
    for term in (h0 * Cm)[0, 0]:
        serial = serial + term
    assert float(serial) == 0.0


# ---------------------------------------------------------------------------
# the wrappers refuse what the kernels do not build, before any build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [tms.mamba_scan_cuda,
                                tms.mamba_scan_witness_cuda])
def test_mamba_wrappers_refuse_other_state_sizes(fn):
    dt, x, Bm, Cm, A, h0 = (_t(a) for a in _mamba_case(0, 1, 3, 8, 8))
    with pytest.raises(ValueError, match="state size 8"):
        fn(dt, x, Bm, Cm, A, h0)


@pytest.mark.parametrize("fn", [tpp.fused_normalize_cuda,
                                tpp.fused_normalize_witness_cuda])
def test_normalize_wrappers_refuse_other_ranks(fn):
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        fn(torch.zeros(4), 0.0, torch.zeros(4), torch.zeros(4))
