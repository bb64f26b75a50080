"""Signed feature hashing in the staged kernel's order of adds, and
count-min's copy-and-add, against the JAX package.

``ref.hash_features_grouped_ref`` spells out the staged CUDA hash kernel
(``csrc/preprocess.cu``, ``hash_staged``): per row, passes of 32
features; in a pass the features whose slots are equal form a group, and
the group's first feature reads its cell, adds the group's values onto
it in feature order and stores the sum once. It must be bitwise the
port's plain version, the JAX oracle and the Pallas kernel (interpret
mode) on rows built to collide (dim 8, repeated ids), on f off and on
the pass of 32, on ragged n and on values holding -0.0, NaN and +-inf.
``streams.sketches.countmin_add`` (on the card one C call: a copy of the
table, then the add) is held to the reference's ``countmin_add`` and to
the Pallas increment on skewed ids. Inputs come from a seed through
numpy; the card runs the same checks in ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.countmin import countmin_update as jx_cms
from repro.kernels.preprocess import fused_hash_features as jx_hash
from repro.streams import sketches as jsk

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.streams import sketches as tsk


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same_bits(got, want) -> None:
    """Bit for bit, except that a NaN matches any NaN: on the CPU a sum
    with a NaN operand keeps that operand's sign and payload, and which
    operand comes first differs between torch's (vectorised) adds and
    XLA's; JAX also multiplies by -1.0 where the port negates. On the card
    every NaN sum is the canonical NaN, and ``chip_smoke.py`` compares
    the kernels bit for bit, NaNs included."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


def _hash_case(name, rng):
    """``(ids, vals, dim)`` for each hashing case."""
    if name == "dim8":                  # 32 features into 8 cells a row
        ids = rng.integers(-2 ** 31, 2 ** 31, (37, 32), dtype=np.int64)
        return ids.astype(np.int32), rng.normal(size=(37, 32)), 8
    if name == "repeated_ids":          # the same few ids many times a row
        ids = rng.choice(np.array([5, -7, 123_456, 2 ** 31 - 1], np.int64),
                         (41, 32))
        return ids.astype(np.int32), rng.normal(size=(41, 32)), 1024
    if name.startswith("f"):            # f off and on the pass of 32
        f = int(name[1:])
        ids = rng.integers(-2 ** 31, 2 ** 31, (29, f), dtype=np.int64)
        return ids.astype(np.int32), rng.normal(size=(29, f)), 64
    if name == "ragged_n":              # n off every block of rows
        ids = rng.integers(0, 300, (131, 33))
        return ids.astype(np.int32), rng.normal(size=(131, 33)), 48
    if name == "specials":              # -0.0, NaN, +-inf, and collisions
        ids = rng.integers(0, 40, (53, 40))
        vals = rng.choice(np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5,
                                    -2.25], np.float32), (53, 40))
        return ids.astype(np.int32), vals, 16
    raise KeyError(name)


HASH_CASES = ("dim8", "repeated_ids", "f1", "f7", "f32", "f33", "f64",
              "ragged_n", "specials")


@pytest.mark.parametrize("name", HASH_CASES)
def test_grouped_hash_is_bitwise_the_references(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    ids, vals, dim = _hash_case(name, rng)
    vals = vals.astype(np.float32)
    got = tref.hash_features_grouped_ref(torch.from_numpy(ids),
                                         torch.from_numpy(vals), dim).numpy()
    plain = tref.hash_features_ref(torch.from_numpy(ids),
                                   torch.from_numpy(vals), dim).numpy()
    want = np.asarray(jref.hash_features_ref(jnp.asarray(ids),
                                             jnp.asarray(vals), dim))
    pk = np.asarray(jx_hash(jnp.asarray(ids), jnp.asarray(vals), dim,
                            block=64, interpret=True))
    for other in (plain, want, pk):
        _same_bits(got, other)
    if name == "specials":
        assert np.isnan(got).any() and np.isinf(got).any()
        assert (_bits(got) == 0).any()


@pytest.mark.parametrize("name", ("specials", "dim8"))
def test_hash_wrapper_on_the_cpu_is_the_plain_version(name):
    rng = np.random.default_rng(7)
    ids, vals, dim = _hash_case(name, rng)
    ids = torch.from_numpy(ids)
    vals = torch.from_numpy(vals.astype(np.float32))
    kops.reset_launch_counts()
    got = kops.hash_features(ids, vals, dim)
    assert kops.launch_counts()["fused_hash_features"] == 0
    _same_bits(got.numpy(),
               tref.hash_features_grouped_ref(ids, vals, dim).numpy())


def test_lone_negative_zero_comes_out_positive():
    """A cell whose only contribution is -0.0 is +0.0 + (-0.0) = +0.0, in
    the twin as in the references; so is -0.0 on an odd sign bit, whose
    negation is +0.0."""
    ids = np.arange(-6, 6, dtype=np.int32)[None]
    vals = np.full((1, 12), -0.0, np.float32)
    got = tref.hash_features_grouped_ref(torch.from_numpy(ids),
                                         torch.from_numpy(vals), 64).numpy()
    assert (_bits(got) == 0).all()
    np.testing.assert_array_equal(
        _bits(got), _bits(jref.hash_features_ref(jnp.asarray(ids),
                                                 jnp.asarray(vals), 64)))


@pytest.mark.parametrize("n", [0, 1, 65])
def test_grouped_hash_empty_and_ragged_rows(n):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 50, (n, 5)).astype(np.int32)
    vals = rng.normal(size=(n, 5)).astype(np.float32)
    got = tref.hash_features_grouped_ref(torch.from_numpy(ids),
                                         torch.from_numpy(vals), 24)
    assert got.shape == (n, 24)
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        _bits(tref.hash_features_ref(torch.from_numpy(ids),
                                     torch.from_numpy(vals), 24).numpy()))


# ---------------------------------------------------------------------------
# count-min's copy-and-add on the summarization path's kind of stream
# ---------------------------------------------------------------------------

def _zipf_ids(rng, n, heavy_share=0.25):
    """Zipf-like ids over the whole int32 range, negatives included, with
    one id at about ``heavy_share`` of the stream."""
    tail = (rng.zipf(1.3, n) * 2_654_435_761) % (2 ** 32) - 2 ** 31
    ids = np.where(rng.random(n) < heavy_share, -123_456_789, tail)
    return ids.astype(np.int64).astype(np.int32)


@pytest.mark.parametrize("width", [1024, 1 << 16])
@pytest.mark.parametrize("seed", range(2))
def test_countmin_add_on_skewed_ids_bitwise(width, seed):
    rng = np.random.default_rng(700 + seed)
    n, depth = 1800, 4
    ids = _zipf_ids(rng, n)
    assert (ids < 0).any() and np.mean(ids == -123_456_789) > 0.2
    j = jsk.countmin_init(depth, width, seed=seed)
    t = tsk.countmin_init(depth, width, seed=seed, device="cpu")
    table = rng.integers(0, 1000, (depth, width)).astype(np.int32)
    j = j._replace(table=jnp.asarray(table))
    t = t._replace(table=torch.from_numpy(table.copy()))
    got = tsk.countmin_add(t, torch.from_numpy(ids))
    want = jsk.countmin_add(j, jnp.asarray(ids), use_kernel=False)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    inc = jx_cms(jnp.asarray(ids), depth, width, j.seeds, block=256,
                 interpret=True)
    np.testing.assert_array_equal(got.table.numpy(),
                                  table + np.asarray(inc))
    assert got.table.dtype == torch.int32
    np.testing.assert_array_equal(got.seeds.numpy(), np.asarray(j.seeds))


@pytest.mark.parametrize("use_kernel", [None, False])
def test_countmin_add_leaves_its_input_table_alone(use_kernel):
    rng = np.random.default_rng(11)
    t = tsk.countmin_init(3, 257, seed=2, device="cpu")
    table = rng.integers(0, 50, (3, 257)).astype(np.int32)
    t = t._replace(table=torch.from_numpy(table.copy()))
    out = tsk.countmin_add(t, torch.from_numpy(_zipf_ids(rng, 900)),
                           use_kernel=use_kernel)
    np.testing.assert_array_equal(t.table.numpy(), table)
    assert out.table.data_ptr() != t.table.data_ptr()
    assert int((out.table - t.table).sum()) == 3 * 900


def test_countmin_add_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(_zipf_ids(rng, 500))
    seeds = torch.from_numpy(
        (rng.integers(1, 2 ** 14, (4, 2)) * 2 + 1).astype(np.int32))
    table = torch.from_numpy(rng.integers(0, 9, (4, 128)).astype(np.int32))
    kops.reset_launch_counts()
    got = kops.countmin_add(ids, table, seeds)
    assert kops.launch_counts()["countmin_update"] == 0
    np.testing.assert_array_equal(
        got.numpy(), (table + tref.countmin_ref(ids, 4, 128, seeds)).numpy())
    with pytest.raises(ValueError):
        kops.countmin_add(ids.to("meta"), table.to("meta"), seeds)
