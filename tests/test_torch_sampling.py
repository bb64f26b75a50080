"""The port's counter-based draws and its stratified reservoir
(``repro_torch.streams.sampling``): the draws against the host's
splitmix64 and for uniformity, the sample op without a host read, and
``stratified_update`` against the JAX package's per-class scans on the
reference's own draws (bitwise) and against per-class
``reservoir_update`` on its own draws (bitwise)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.streams import sampling as jsamp

from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import pipeline as tpl
from repro_torch.streams import sampling as tsamp

_aten = torch.ops.aten


class NoHostRead(TorchDispatchMode):
    """Fails on every op that reads a tensor's value on the host or
    builds a tensor from Python data: the calls a CUDA-graph capture
    cannot hold."""
    BANNED = (_aten._local_scalar_dense.default, _aten.nonzero.default,
              _aten.lift_fresh.default, _aten.lift_fresh_copy.default)

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"host read or host-built tensor: {func}")
        if func.overloadpacket in (_aten.index, _aten.index_put,
                                   _aten.index_put_):
            idx = args[1]
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx):
                raise AssertionError(f"boolean index (a host count): {func}")
        self.ops.add(func)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# the counter-based draws
# ---------------------------------------------------------------------------

def test_int64_products_wrap_in_twos_complement_on_the_cpu():
    a = torch.tensor([2 ** 62, 3, -(2 ** 63), 0x7FFFFFFFFFFFFFFF])
    for m in (4, tsamp._GOLDEN, tsamp._MIX1, tsamp._MIX2):
        want = [((int(v) * m + 2 ** 63) % 2 ** 64) - 2 ** 63 for v in a]
        assert (a * m).tolist() == want
    # the logical shift masks what the arithmetic shift sign-extends
    z = torch.tensor([-1, -(2 ** 63), 12345])
    assert tsamp._shr(z, 30).tolist() == [(int(v) % 2 ** 64) >> 30
                                          for v in z]


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 62 + 7, 2 ** 63 - 1])
def test_mix64_is_the_hosts_step_seed(seed):
    steps = torch.tensor([0, 1, 2, 99, 2 ** 40])
    got = tsamp.draws(torch.tensor(seed), steps).tolist()
    assert got == [torch_orch.step_seed(seed, int(s)) for s in steps]


def test_draws_equal_across_calls_and_advance_per_batch():
    x = torch.zeros(4096, 2)
    seed = torch.tensor(123)
    m1, s1 = tsamp.bernoulli_thin(seed, x, 0.5)
    m2, s2 = tsamp.bernoulli_thin(seed, x, 0.5)
    assert torch.equal(m1, m2) and torch.equal(s1, s2)
    assert int(s1) != 123 and s1.dtype == torch.int64 and s1.dim() == 0
    m3, _ = tsamp.bernoulli_thin(s1, x, 0.5)
    assert not torch.equal(m1, m3)              # the next batch's draws
    # the seed chain never sticks, from 0 either
    chain, s = [], torch.tensor(0)
    for _ in range(200):
        s = tsamp.advance(s)
        chain.append(int(s))
    assert len(set(chain)) == 200 and 0 not in chain
    assert all(0 <= c <= tsamp.SEED_MASK for c in chain)
    # the reservoir's own seed advances per batch, its draws repeat
    st = tsamp.reservoir_init(8, 2, seed=5)
    a = tsamp.reservoir_update(st, torch.randn(40, 2), torch.zeros(40))
    b = tsamp.reservoir_update(st, torch.randn(40, 2), torch.ones(40))
    assert torch.equal(a.rng, b.rng) and int(a.rng) != 5


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.5, 0.9])
def test_thinning_keep_rate_within_binomial_bounds(rate):
    n = 40000
    for seed in range(3):
        mask, _ = tsamp.bernoulli_thin(torch.tensor(seed), torch.zeros(n, 1),
                                       rate)
        sd = np.sqrt(rate * (1 - rate) / n)
        assert abs(float(mask.float().mean()) - rate) < 5 * sd
    none, _ = tsamp.bernoulli_thin(torch.tensor(1), torch.zeros(n, 1), 0.0)
    assert not bool(none.any())


def test_draws_are_uniform_within_binomial_bounds():
    """Every residue of the 63-bit draws, and every one of their top 4
    bits, within 5 standard deviations of its binomial mean."""
    n = 60000
    d = tsamp.draws(torch.tensor(77), torch.arange(n))
    for vals, k in ((d % 7, 7), (d >> 59, 16)):
        counts = torch.bincount(vals, minlength=k).double().numpy()
        p = 1.0 / k
        assert np.abs(counts - n * p).max() < 5 * np.sqrt(n * p * (1 - p))
    # consecutive items are not correlated bit for bit
    bits = ((d >> 62) & 1).double()
    agree = float((bits[1:] == bits[:-1]).double().mean())
    assert abs(agree - 0.5) < 5 * np.sqrt(0.25 / n)


def test_sample_op_reads_no_value_on_the_host():
    """The sample op, and the whole standard-pipeline segment it sits in,
    under a dispatch mode that fails on ``aten._local_scalar_dense`` (the
    op behind ``int()``, ``bool()`` and ``.item()``), ``nonzero``,
    boolean indexing and tensors built from Python data."""
    g = tpl.standard_stream_pipeline(8, sample_rate=0.5)
    states = g.init_states("cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    batch = {"x": torch.from_numpy(x),
             "y": torch.from_numpy((rng.random(64) < 0.5).astype(np.int32)),
             "rng": torch.tensor(7)}
    op = g.op("sample")
    mode = NoHostRead()
    with mode:
        st, out = op.fn(states["sample"], batch)
    assert _aten._local_scalar_dense.default not in mode.ops
    assert out["rng"].dtype == torch.int64 and out["mask"].dtype == torch.bool
    # the same call outside the mode gives the same draws
    st2, out2 = op.fn(states["sample"], batch)
    assert torch.equal(out["mask"], out2["mask"])
    assert torch.equal(st.buf, st2.buf) and torch.equal(st.rng, st2.rng)
    seg = g._fuse_ops(tuple(range(len(g.ops))))
    with NoHostRead():
        seg(states, batch)


# ---------------------------------------------------------------------------
# the stratified reservoir
# ---------------------------------------------------------------------------

def _jax_reservoir_draws(rng, seen, n):
    """The j draws the JAX package's reservoir_update makes for n items
    from a reservoir at ``(rng, seen)`` (its split/randint sequence,
    replayed)."""
    def step(carry, _):
        rng, seen = carry
        rng, r1 = jax.random.split(rng)
        seen = seen + 1
        return (rng, seen), jax.random.randint(r1, (), 0, seen)

    _, js = jax.lax.scan(step, (rng, seen), None, length=n)
    return np.asarray(js)


def _jax_stratified_draws(sr, y, n_classes):
    """Item i's draw in its class's sequence, as the reference's
    per-class scans make them."""
    j = np.zeros(len(y), np.int64)
    for c in range(n_classes):
        pos = np.nonzero(y == c)[0]
        if len(pos):
            j[pos] = _jax_reservoir_draws(sr.states.rng[c],
                                          sr.states.seen[c], len(pos))
    return j


def test_stratified_update_bitwise_with_the_references_draws():
    C, k, d = 3, 8, 4
    jsr = jsamp.stratified_init(C, k, d, seed=2)
    tsr = tsamp.stratified_init(C, k, d, seed=2)
    rng = np.random.default_rng(4)
    for b in range(5):              # fills, then replaces
        n = 30 + 7 * b
        x = rng.normal(size=(n, d)).astype(np.float32)
        # skewed classes, and a label (3) no class takes
        y = rng.choice(4, size=n, p=[0.6, 0.25, 0.1, 0.05]).astype(np.int32)
        j = _jax_stratified_draws(jsr, y, C)
        jsr = jsamp.stratified_update(jsr, jnp.asarray(x), jnp.asarray(y), C)
        tsr = tsamp.stratified_update(tsr, torch.from_numpy(x),
                                      torch.from_numpy(y), C,
                                      j=torch.from_numpy(j))
        np.testing.assert_array_equal(tsr.states.buf.numpy(),
                                      np.asarray(jsr.states.buf))
        np.testing.assert_array_equal(tsr.states.extra.numpy(),
                                      np.asarray(jsr.states.extra))
        np.testing.assert_array_equal(tsr.states.seen.numpy(),
                                      np.asarray(jsr.states.seen))
    assert tsr.states.buf.shape == (C, k, d)
    assert (np.asarray(jsr.states.seen) > k).all()   # every class replaced


def test_stratified_update_is_reservoir_update_per_class():
    """With its own draws, one pass over all classes equals
    ``reservoir_update`` over each class's items with the same draws,
    and a class's seed advances only when the batch holds its items."""
    C, k, d = 3, 6, 2
    sr = tsamp.stratified_init(C, k, d, seed=9)
    per = [tsamp.reservoir_init(k, d, seed=9 + c) for c in range(C)]
    rng = np.random.default_rng(5)
    for b in range(6):
        n = 25
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        classes = [0, 1] if b == 2 else [0, 1, 2]       # class 2 absent
        y = torch.from_numpy(rng.choice(classes, size=n).astype(np.int32))
        new = tsamp.stratified_update(sr, x, y, C)
        for c in range(C):
            sel = y == c
            nc = int(sel.sum())
            if nc == 0:
                assert torch.equal(new.states.rng[c], sr.states.rng[c])
                continue
            j = (tsamp.draws(sr.states.rng[c], torch.arange(nc))
                 % (per[c].seen.long() + torch.arange(1, nc + 1)))
            per[c] = tsamp.reservoir_update(per[c], x[sel], y[sel], j=j)
            per[c] = per[c]._replace(rng=tsamp.advance(sr.states.rng[c]))
            assert torch.equal(new.states.buf[c], per[c].buf)
            assert torch.equal(new.states.extra[c], per[c].extra)
            assert int(new.states.seen[c]) == int(per[c].seen)
            assert torch.equal(new.states.rng[c], per[c].rng)
        sr = new


def test_stratified_update_own_draws_are_uniform_per_class():
    """Every item of a class's history is equally likely to sit in its
    class's reservoir: binomial(trials, k / n_c) per item."""
    C, k, trials = 2, 4, 300
    y_all = np.tile([0, 0, 1], 16)                 # 32 of class 0, 16 of 1
    counts = {0: np.zeros(48), 1: np.zeros(48)}
    for t in range(trials):
        sr = tsamp.stratified_init(C, k, 1, seed=1000 * t)
        for b in range(4):
            sl = slice(12 * b, 12 * (b + 1))
            x = torch.arange(48, dtype=torch.float32)[sl, None]
            sr = tsamp.stratified_update(sr, x, torch.from_numpy(y_all[sl]),
                                         C)
        for c in range(C):
            counts[c][sr.states.buf[c, :, 0].long().numpy()] += 1
    for c in range(C):
        items = np.nonzero(y_all == c)[0]
        p = k / len(items)
        sd = np.sqrt(trials * p * (1 - p))
        assert np.abs(counts[c][items] - trials * p).max() < 5 * sd
        assert counts[c][np.nonzero(y_all != c)[0]].sum() == 0
