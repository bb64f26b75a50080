"""Recipe -> logical->mesh sharding rules.

A *recipe* (``cfg.recipe``) names a parallelism strategy; ``build_rules``
expands it into two rule tables consumed by :func:`repro_torch.dist.api
.logical_to_spec`, as the JAX package's ``dist/sharding.py`` does:

  * ``rules["param"]`` — how parameter Spec axes map onto the mesh
    (FSDP shards fan-in ``embed`` over ``data``; TP shards ``heads`` /
    ``ff`` / ``vocab`` over ``model``; EP shards ``experts`` over
    ``model``).
  * ``rules["act"]``  — how activation dims map (``batch`` over the
    data axes, TP-parallel dims over ``model``, MoE token groups over
    ``expert_groups`` -> data).

Rules reference the *union* mesh axes (``pod``, ``data``, ``model``);
axes absent from the actual mesh are dropped at spec time, so the same
rules drive a 2x2 test mesh and a production one.

Recipes: ``dp`` (replicated params), ``fsdp``, ``tp_fsdp``,
``ep_fsdp``, ``ep_tp_fsdp``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch._tree import tree_map
from repro_torch.dist.api import (is_axes, logical_to_spec,
                                  spec_to_placements)

# ordered data-parallel axes: multipod meshes put "pod" outermost
_DATA = ("pod", "data")
_MODEL = ("model",)

_RECIPES = ("dp", "fsdp", "tp_fsdp", "ep_fsdp", "ep_tp_fsdp")


def build_rules(cfg=None, *, shape=None, recipe: Optional[str] = None) -> dict:
    """Build ``{"param": {...}, "act": {...}}`` for an arch config.

    ``recipe`` overrides ``cfg.recipe``; ``shape`` (an InputShape) lets
    decode cells drop sequence-parallel pins on their length-1 query dim.
    """
    name = recipe or (getattr(cfg, "recipe", None) or "dp")
    if name not in _RECIPES:
        raise ValueError(f"unknown recipe {name!r}; expected one of {_RECIPES}")
    tp = name in ("tp_fsdp", "ep_tp_fsdp")
    ep = name.startswith("ep")
    fsdp = name != "dp"

    param = {}
    if fsdp:
        param["embed"] = ("data",)
    if ep:
        param["experts"] = _MODEL
    if tp:
        param.update({
            "heads": _MODEL, "kv_heads": _MODEL, "ff": _MODEL,
            "vocab": _MODEL, "dinner": _MODEL,
        })
        if not ep:
            param["experts"] = _MODEL

    act = {"batch": _DATA, "expert_groups": _DATA}
    if ep:
        act["experts"] = _MODEL
    if tp:
        act.update({
            "heads": _MODEL, "kv_heads": _MODEL, "ff": _MODEL,
            "vocab": _MODEL, "dinner": _MODEL,
        })
        seq_shard = getattr(cfg, "seq_shard", False)
        if seq_shard and not (shape is not None and
                              getattr(shape, "is_decode", False)):
            act["seq_sp"] = _MODEL
    return {"recipe": name, "param": dict(param), "act": dict(act)}


def param_sharding_tree(axes_or_cfg, mesh, rules, shapes=None):
    """``(mesh, placements)`` for every leaf of a parameter tree, the
    counterpart of the reference's ``NamedSharding`` tree.

    ``axes_or_cfg`` is either a logical-axes tree (as from
    ``models.params.axes_of``) or an ArchConfig (resolved through
    model_zoo). When ``shapes`` (a matching tree of tensors, ``meta``
    ones included) is given, divisibility is enforced per leaf;
    otherwise rules apply unconditionally.
    """
    axes = axes_or_cfg
    if hasattr(axes_or_cfg, "recipe"):  # an ArchConfig
        from repro_torch.models import model_zoo as zoo
        axes = zoo.param_axes(axes_or_cfg)
        if shapes is None:
            shapes = zoo.param_shapes(axes_or_cfg)

    def one(ax, shape=None):
        spec = logical_to_spec(ax, rules["param"], mesh, shape)
        return (mesh, spec_to_placements(spec, mesh))

    if shapes is None:
        return tree_map(one, axes, is_leaf=is_axes)
    return tree_map(lambda ax, s: one(ax, tuple(s.shape)), axes, shapes,
                    is_leaf=is_axes)


__all__ = ["build_rules", "param_sharding_tree"]
