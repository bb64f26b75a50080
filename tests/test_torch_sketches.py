"""The port's edge-summarization path against the JAX package's.

``repro_torch.streams.sketches`` (Count-Min, Misra-Gries) and
``repro_torch.streams.feeder`` against ``repro.streams.sketches`` and
``repro.streams.feeder`` on the same ids, made from a seed with numpy.
On the CPU the port runs the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode where it takes them. Integer
sketches must agree bitwise.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.streams import feeder as jfeeder
from repro.streams import generators as jgen
from repro.streams import sketches as jsk

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as tzoo
from repro_torch.streams import feeder as tfeeder
from repro_torch.streams import generators as tgen
from repro_torch.streams import sketches as tsk

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _zipf_ids(seed, n, vocab=5000):
    """Token ids as the summarization path sees them: a Zipf stream."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, n) % vocab).astype(np.int32)


def _np(t):
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Count-Min: the API, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,width,seed", [(4, 1024, 0), (3, 257, 5),
                                              (1, 64, 11)])
def test_countmin_init_seeds_are_the_references(depth, width, seed):
    j = jsk.countmin_init(depth, width, seed=seed)
    t = tsk.countmin_init(depth, width, seed=seed, device="cpu")
    assert t.seeds.dtype == t.table.dtype == torch.int32
    np.testing.assert_array_equal(t.seeds.numpy(), _np(j.seeds))
    np.testing.assert_array_equal(t.table.numpy(), _np(j.table))


@pytest.mark.parametrize("use_kernel", [None, False])
def test_countmin_api_bitwise_with_reference(monkeypatch, use_kernel):
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    j = jsk.countmin_init(3, 257, seed=5)
    t = tsk.countmin_init(3, 257, seed=5, device="cpu")
    for step in range(3):
        ids = _zipf_ids(step, 600)
        j = jsk.countmin_add(j, jnp.asarray(ids))
        t = tsk.countmin_add(t, torch.from_numpy(ids), use_kernel=use_kernel)
        np.testing.assert_array_equal(t.table.numpy(), _np(j.table))
        ids = _zipf_ids(10 + step, 500)
        j, jest = jsk.countmin_add_query(j, jnp.asarray(ids))
        t, test_ = tsk.countmin_add_query(t, ids, use_kernel=use_kernel)
        np.testing.assert_array_equal(t.table.numpy(), _np(j.table))
        np.testing.assert_array_equal(test_.numpy(), _np(jest))
    q = np.arange(-50, 6000, dtype=np.int32)
    np.testing.assert_array_equal(
        tsk.countmin_query(t, torch.from_numpy(q)).numpy(),
        _np(jsk.countmin_query(j, jnp.asarray(q))))


def test_countmin_estimates_never_fall_below_true_counts():
    ids = _zipf_ids(3, 20_000)
    t = tsk.countmin_add(tsk.countmin_init(4, 512, device="cpu"), ids)
    true = np.bincount(ids)
    keys = np.nonzero(true)[0].astype(np.int32)
    est = tsk.countmin_query(t, torch.from_numpy(keys)).numpy()
    assert (est >= true[keys]).all()


def test_dispatch_counts_and_no_fallback():
    """None and False take the plain version for a sketch on the CPU and
    are counted; True raises where the JAX package warns and falls back
    (ROADMAP fault 10), and is not counted."""
    cm = tsk.countmin_init(2, 64, device="cpu")
    ids = torch.from_numpy(_zipf_ids(6, 123))
    tsk.reset_dispatch_counts()
    a = tsk.countmin_add(cm, ids)
    b = tsk.countmin_add(cm, ids, use_kernel=False)
    tsk.countmin_add_query(cm, ids)
    assert torch.equal(a.table, b.table)
    assert tsk.dispatch_counts() == {"kernel": 0, "plain": 3}
    with pytest.raises(ValueError, match="use_kernel=True"):
        tsk.countmin_add(cm, ids, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tsk.countmin_add_query(cm, ids, use_kernel=True)
    assert tsk.dispatch_counts() == {"kernel": 0, "plain": 3}
    tsk.reset_dispatch_counts()
    assert tsk.dispatch_counts() == {"kernel": 0, "plain": 0}


# ---------------------------------------------------------------------------
# Misra-Gries: the API, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16, 64])
def test_mg_update_bitwise_with_reference(k):
    j = jsk.mg_init(k)
    t = tsk.mg_init(k, device="cpu")
    for step in range(2):
        ids = _zipf_ids(20 + step, 700, vocab=300)
        ids[::50] = -1
        j = jax.jit(jsk.mg_update)(j, jnp.asarray(ids))
        t = tsk.mg_update(t, ids)
        np.testing.assert_array_equal(t.keys.numpy(), _np(j.keys))
        np.testing.assert_array_equal(t.counts.numpy(), _np(j.counts))
    assert t.keys.dtype == t.counts.dtype == torch.int32


def test_mg_finds_the_heavy_hitter():
    rng = np.random.default_rng(0)
    ids = np.where(rng.random(2000) < 0.3, 7,
                   rng.integers(100, 10_000, 2000)).astype(np.int32)
    mg = tsk.mg_update(tsk.mg_init(16, device="cpu"), ids)
    assert int(mg.keys[int(torch.argmax(mg.counts))]) == 7


# ---------------------------------------------------------------------------
# sketches carried over from the JAX package continue bitwise
# ---------------------------------------------------------------------------

def test_reference_sketches_carried_over_continue_bitwise():
    first, then = _zipf_ids(30, 900), _zipf_ids(31, 900)
    jcm = jsk.countmin_add(jsk.countmin_init(4, 300, seed=9),
                           jnp.asarray(first))
    jmg = jax.jit(jsk.mg_update)(jsk.mg_init(16), jnp.asarray(first))
    tcm = convert.state_from_numpy(
        tsk.countmin_init(4, 300, device="cpu"),
        jax.tree.map(np.asarray, jcm), device="cpu")
    tmg = convert.state_from_numpy(
        tsk.mg_init(16, device="cpu"), jax.tree.map(np.asarray, jmg),
        device="cpu")
    assert isinstance(tcm, tsk.CountMin) and isinstance(tmg, tsk.MisraGries)
    jcm, jest = jsk.countmin_add_query(jcm, jnp.asarray(then))
    tcm, test_ = tsk.countmin_add_query(tcm, then)
    np.testing.assert_array_equal(tcm.table.numpy(), _np(jcm.table))
    np.testing.assert_array_equal(test_.numpy(), _np(jest))
    jmg = jax.jit(jsk.mg_update)(jmg, jnp.asarray(then))
    tmg = tsk.mg_update(tmg, then)
    np.testing.assert_array_equal(tmg.keys.numpy(), _np(jmg.keys))
    np.testing.assert_array_equal(tmg.counts.numpy(), _np(jmg.counts))
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(tsk.countmin_init(4, 299, device="cpu"),
                                 jax.tree.map(np.asarray, jcm), device="cpu")


# ---------------------------------------------------------------------------
# the feeder: straggler rescue replays the same batches
# ---------------------------------------------------------------------------

def _feed(feeder_mod, gen_mod, n_batches=3):
    def make(shard, idx, n):
        return gen_mod.TokenStream(vocab_size=4096, seq_len=16,
                                   seed=shard).batch(idx, n)

    f = feeder_mod.StreamFeeder(
        make, n_shards=3, batch_per_shard=8, deadline_s=0.05,
        inject_straggle=lambda s, i: 0.3 if (s == 1 and i == 1) else 0.0)
    f.start()
    try:
        out = [f.next() for _ in range(n_batches)]
    finally:
        f.stop()
    return f, out


def test_feeder_straggler_rescue_matches_reference():
    tf, tb = _feed(tfeeder, tgen)
    jf, jb = _feed(jfeeder, jgen)
    assert tf.stats.straggler_rescues >= 1 and jf.stats.straggler_rescues >= 1
    assert tf.stats.batches >= 3 and tf.stats.wait_s >= 0.0
    for a, b in zip(tb, jb):
        assert a.data["tokens"].shape == (24, 16)
        np.testing.assert_array_equal(a.data["tokens"], b.data["tokens"])
        np.testing.assert_array_equal(a.ts, b.ts)
        assert (a.seq_no, a.watermark) == (b.seq_no, b.watermark)
    # the rescued shard is what the straggler would have produced
    want = tgen.TokenStream(vocab_size=4096, seq_len=16, seed=1).batch(1, 8)
    np.testing.assert_array_equal(tb[1].data["tokens"][8:16],
                                  want.data["tokens"])


@pytest.mark.parametrize("kind", ["none", "abrupt", "gradual"])
def test_token_stream_bitwise_with_reference(kind):
    """The port draws domain B's permutation once per stream; the
    batches are the reference's, drifted or not."""
    for seed in (0, 3):
        t = tgen.TokenStream(vocab_size=3000, seq_len=8, seed=seed,
                             drift=tgen.DriftSpec(kind=kind, at=0.3),
                             horizon=400.0)
        j = jgen.TokenStream(vocab_size=3000, seq_len=8, seed=seed,
                             drift=jgen.DriftSpec(kind=kind, at=0.3),
                             horizon=400.0)
        for idx in range(4):
            a, b = t.batch(idx, 12), j.batch(idx, 12)
            np.testing.assert_array_equal(a.data["tokens"], b.data["tokens"])
            np.testing.assert_array_equal(a.ts, b.ts)


def test_feeder_resumes_from_start_idx_and_reports_backlog():
    def make(shard, idx, n):
        return tgen.HyperplaneStream(dim=4, seed=shard).batch(idx, n)

    f = tfeeder.StreamFeeder(make, n_shards=2, batch_per_shard=16,
                             prefetch=2, start_idx=5).start()
    try:
        b = f.next()
        for _ in range(100):            # the producer fills the queue
            if f.backlog == 2:
                break
            time.sleep(0.02)
        assert f.backlog == 2
    finally:
        f.stop()
    want = tgen.HyperplaneStream(dim=4, seed=0).batch(5, 16)
    np.testing.assert_array_equal(b.data["x"][:16], want.data["x"])
    assert b.seq_no == 5


# ---------------------------------------------------------------------------
# devices and imports
# ---------------------------------------------------------------------------

def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    cfg = get_config("qwen2-1.5b", smoke=True)
    calls = (lambda d: tsk.countmin_init(2, 8, **d),
             lambda d: tsk.mg_init(4, **d),
             lambda d: tzoo.init_caches(cfg, 1, 8, **d))
    for call in calls:
        if torch.cuda.is_available():
            assert all(x.device.type == "cuda" for x in _leaves(call({})))
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call({})
        leaves = _leaves(call({"device": "cpu"}))
        assert leaves and all(x.device.type == "cpu" for x in leaves)


def _leaves(tree):
    from repro_torch._tree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    mods = ["repro_torch.streams.sketches", "repro_torch.streams.feeder",
            "repro_torch.kernels.countmin", "repro_torch.kernels.mg_scan",
            "repro_torch.kernels.mamba_scan", "repro_torch.kernels.ops",
            "repro_torch.convert"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for m in mods:
        src = (ROOT / "src" / (m.replace(".", "/") + ".py")).read_text()
        assert "import jax" not in src and "from repro." not in src
        assert "import repro\n" not in src
