"""The rank-local draw (``params.materialize`` keeping
``fsdp.Layout.local_leaf``, as ``chip_smoke.draw_local`` calls it): each
leaf drawn whole from its per-path seed, only the rank's shard kept and
the whole value freed before the next leaf. A rank then never holds the
whole model, which two ranks of a full-width model on one card cannot
afford.

On the CPU, on a stand-in (1, 2) mesh (its axis sizes and the rank's
coordinate: the draw needs no collective), for jamba's and deepseek's
smoke configs under ``ep_tp_fsdp``: bitwise ``Layout.local`` of the whole
draw at both coordinates, in the configs' fp32 and in bf16 (the full
configs' dtype: the draw casts before it slices), and each shard's shape
the reference's split of the leaf on the same stand-in
(``repro.dist.api.logical_to_spec``).
"""

import pytest
import torch

from repro.dist import api as japi
from repro.dist import sharding as jsharding
from repro.configs import get_config as jget

from repro_torch._tree import tree_flatten, tree_flatten_with_path
from repro_torch.configs import get_config
from repro_torch.dist import fsdp
from repro_torch.dist.api import is_axes
from repro_torch.dist.sharding import build_rules
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as pmod

ARCHS = ("jamba-1.5-large-398b", "deepseek-v2-lite-16b")
MESH = {"data": 1, "model": 2}


class _Rank:
    """A stand-in (1, 2) mesh seen from one rank: axis sizes and the
    rank's coordinate along each axis."""

    mesh_dim_names = tuple(MESH)
    shape = tuple(MESH.values())

    def __init__(self, coordinate):
        self.coordinate = dict(zip(self.mesh_dim_names, coordinate))

    def get_local_rank(self, axis):
        return self.coordinate[axis]


class _Sizes:
    """The reference's stand-in: axis sizes only."""

    def __init__(self, shape):
        self.shape = shape


def _local_draw(cfg, layout):
    return pmod.materialize(zoo.model_specs(cfg), 0,
                            zoo.dtype_of(cfg.param_dtype), "cpu",
                            layout.local_leaf)


def _config(arch, dtype):
    return get_config(arch, smoke=True).with_overrides(
        recipe="ep_tp_fsdp", param_dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_rank", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_local_draw_is_the_whole_draw_sliced(arch, model_rank, dtype):
    cfg = _config(arch, dtype)
    layout = fsdp.Layout(zoo.param_shapes(cfg), zoo.param_axes(cfg),
                         build_rules(cfg), _Rank((0, model_rank)))
    got = _local_draw(cfg, layout)
    want = layout.local(zoo.init_params(cfg, seed=0, device="cpu"))
    got_flat, got_def = tree_flatten(got)
    want_flat, want_def = tree_flatten(want)
    assert got_def == want_def
    split = 0
    for (path, a), b, full in zip(tree_flatten_with_path(got)[0], want_flat,
                                  tree_flatten(zoo.param_shapes(cfg))[0]):
        assert a.dtype == b.dtype == getattr(torch, dtype), path
        assert a.is_contiguous(), path
        assert torch.equal(a, b), path
        split += a.shape != full.shape
    assert split > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_local_shards_are_the_reference_split(arch):
    """Each kept shard's shape is the leaf's full shape divided as the
    reference's rules split it over the stand-in (1, 2) mesh: heads,
    ``kv_heads``, ``ff``, vocab, ``dinner`` and experts in two, the rest
    whole (MLA's latent projections and norm among them)."""
    cfg = _config(arch, "float32")
    jcfg = jget(arch, smoke=True).with_overrides(recipe="ep_tp_fsdp")
    jrules = jsharding.build_rules(jcfg)["param"]
    layout = fsdp.Layout(zoo.param_shapes(cfg), zoo.param_axes(cfg),
                         build_rules(cfg), _Rank((0, 1)))
    got = _local_draw(cfg, layout)
    axes = tree_flatten(zoo.param_axes(cfg), is_leaf=is_axes)[0]
    whole = []
    for (path, a), ax, full in zip(tree_flatten_with_path(got)[0], axes,
                                   tree_flatten(zoo.param_shapes(cfg))[0]):
        spec = japi.logical_to_spec(ax, jrules, _Sizes(MESH), full.shape)
        want = list(full.shape)
        for i, part in enumerate(spec):
            for name in ((part,) if isinstance(part, str) else part or ()):
                want[i] //= MESH[name]
        assert tuple(a.shape) == tuple(want), path
        if tuple(want) == tuple(full.shape):
            whole.append(path)
    if cfg.mla is not None:
        for name in ("w_dkv", "w_kr", "kv_norm"):
            assert any(p.endswith(f"['{name}']") for p in whole), name
