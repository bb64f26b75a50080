"""Tensor- and expert-parallel compute along the ``model`` mesh axis.

Under ``tp_fsdp``, ``ep_fsdp`` and ``ep_tp_fsdp`` the JAX package pins
activations to ``model`` inside each layer (heads, ``ff``, ``vocab``,
``dinner``, experts) and XLA splits the layer's compute by them: each
``model`` rank holds and computes its own slice. Eager PyTorch has no
partitioner, so inside a step on shards (:func:`repro_torch.dist.fsdp.
sharded`) on a mesh whose ``model`` axis has more than one rank, a leaf
dim that the param rules and the act rules both map to ``model`` stays
the rank's slice (:func:`repro_torch.dist.fsdp.gather` does not gather
it over ``model``), and the layers call the collectives XLA would have
inserted (Megatron's conjugate pair, and an activation all-gather):

  * :func:`copy_in`   — identity forward, all-reduce SUM of the gradient
    backward: before a column-parallel product, so a replicated input
    gets its whole gradient;
  * :func:`reduce_out` — all-reduce SUM forward, identity backward: after
    a row-parallel product;
  * :func:`gather_out` — the ranks' slices of an activation concatenated
    along a dim; its backward is the rank's own slice of the gradient
    (what follows it is replicated, so every rank holds the same one);
  * :func:`take`      — a replicated tensor's slice for this rank
    (:func:`copy_in`, then the slice): where a replicated value enters
    the rank's own compute.

Where the active act rules map ``seq_sp`` to ``model`` (a config with
``seq_shard=True`` under a ``tp`` recipe, not at decode) and the
sequence divides by the ``model`` size (:func:`seq_parts`), the residual
stream between the layers is the rank's slice of the sequence, as the
reference's ``shard(x, "batch", "seq_sp", "embed")`` lays it out, and
each layer's output product reduce-scatters in place of the
all-reduce (in the forward, Megatron's sequence-parallel pair):

  * :func:`reduce_scatter_out` — reduce-scatter of the fp32 partial sums
    along the sequence, backward an all-gather: the layer's output
    product where the caller passes ``scatter=True``
    (``row_product(..., scatter=True)``, ``reduce_out(..., scatter=True)``;
    ``models/transformer.py::apply_slot`` decides, and each mixer and MLP
    hands the flag to its output product);
  * :func:`gather_in`  — all-gather along the sequence before the next
    column-parallel product (:func:`gather_out`): its backward is the
    rank's slice of the gradient, which the layer's :func:`copy_in` has
    already summed over ``model`` (a reduce-scatter there would sum it
    twice);
  * :func:`seq_slice`  — a whole, replicated tensor's slice of the
    sequence (the embedding's output entering the stream, an output a
    layer computed whole), backward an all-gather;
  * :func:`on_slice`   — a replicated parameter used on the slice (a
    norm's scale, a gate, an output bias): its gradient summed over
    ``model``, each rank having seen only its positions.

Sums run in fp32: a row-parallel product's partial sums are made in
fp32 (:func:`row_product`: bf16 operands, an fp32 result, as the one-rank
product accumulates before its one rounding), all-reduced in fp32 and
rounded once to the activation dtype. A bf16 partial product, or a bf16
sum of them, would round once or twice more than the one-rank product.

Outside a step on shards, or with one ``model`` rank, every function is
the identity and :func:`parts` is 1: the layers run their one-rank code.
A layer learns whether it is split from its weights' shapes against the
config's (:func:`parts`): a dim that does not divide by the ``model``
axis stays whole (``logical_to_spec``'s divisibility fallback).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Model", "group", "parts", "copy_in", "reduce_out", "gather_out",
           "take", "row_product", "local_size", "vocab_cross_entropy",
           "seq_parts", "reduce_scatter_out", "gather_in", "seq_slice",
           "on_slice", "seq_out"]


class Model(NamedTuple):
    """The ``model`` axis of the active step on shards."""
    group: object      # the ProcessGroup along ``model``
    size: int
    rank: int          # this rank's coordinate on ``model``


def group() -> Optional[Model]:
    """The ``model`` axis of the active :func:`~repro_torch.dist.fsdp.
    sharded` step where it has more than one rank; None otherwise."""
    from repro_torch.dist import fsdp
    from repro_torch.dist.api import mesh_sizes

    ctx = fsdp.current()
    if ctx is None:
        return None
    m = int(mesh_sizes(ctx.mesh).get("model", 1))
    if m <= 1:
        return None
    return Model(ctx.mesh.get_group("model"), m,
                 ctx.mesh.get_local_rank("model"))


def parts(local: int, full: int) -> int:
    """How many ``model`` ranks split a dim of ``full`` that this rank
    holds ``local`` of: 1 where it is whole, the axis's size where it is
    the rank's slice. Any other split raises: the layers have no path
    for it."""
    if local == full:
        return 1
    g = group()
    if g is None or local * g.size != full:
        raise ValueError(
            f"a dim of {local} where the model has {full}: not this "
            f"step's split over model ({'none' if g is None else g.size})")
    return g.size


def local_size(full: int, name: str) -> int:
    """The rank's share of a dim of ``full`` along logical axis ``name``
    (a cache's ``kv_heads``, ``heads`` or ``dinner``): ``full // m`` where
    the active rules map ``name`` to ``model`` and it divides, else
    ``full``."""
    from repro_torch.dist import fsdp
    from repro_torch.dist.api import _as_tuple

    g = group()
    if g is None:
        return full
    act = fsdp.current().rules.get("act", {})
    if "model" not in _as_tuple(act.get(name)) or full % g.size:
        return full
    return full // g.size


def seq_parts(S: int) -> int:
    """How many ``model`` ranks split a sequence of ``S`` positions in the
    residual stream: the ``model`` size where the active act rules map
    ``seq_sp`` to ``model`` and ``S`` divides by it, else 1 (the
    reference's ``shard`` drops a constraint that does not divide)."""
    from repro_torch.dist import fsdp
    from repro_torch.dist.api import _as_tuple

    g = group()
    if g is None:
        return 1
    act = fsdp.current().rules.get("act", {})
    if "model" not in _as_tuple(act.get("seq_sp")) or S % g.size:
        return 1
    return g.size


def _all_reduce_f32(x: torch.Tensor, grp) -> torch.Tensor:
    """The ranks' sum of ``x``, summed in fp32, in ``x``'s dtype (a new
    tensor)."""
    import torch.distributed as tdist
    y = x.to(torch.float32, copy=True).contiguous()
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM, group=grp)
    return y.to(x.dtype)


def _reduce_scatter_f32(x: torch.Tensor, dim: int, grp) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the ranks' sum of ``x``, summed
    in fp32, in ``x``'s dtype."""
    import torch.distributed as tdist
    n = tdist.get_world_size(grp)
    src = x.to(torch.float32).movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=torch.float32, device=src.device)
    tdist.reduce_scatter_tensor(out, src, op=tdist.ReduceOp.SUM, group=grp)
    return out.movedim(0, dim).contiguous().to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.grp), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce_f32(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        from repro_torch.dist.fsdp import _all_gather
        ctx.dim, ctx.size, ctx.rank = dim, g.size, g.rank
        return _all_gather(x, dim, g.group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.size
        return g.narrow(ctx.dim, ctx.rank * n, n).contiguous(), None, None


class _ReduceScatterOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.grp = dim, g.group
        return _reduce_scatter_f32(x, dim, g.group)

    @staticmethod
    def backward(ctx, gr):
        from repro_torch.dist.fsdp import _all_gather
        return _all_gather(gr.contiguous(), ctx.dim, ctx.grp), None, None


class _SeqSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.grp = dim, g.group
        n = x.shape[dim] // g.size
        return x.narrow(dim, g.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, gr):
        from repro_torch.dist.fsdp import _all_gather
        return _all_gather(gr.contiguous(), ctx.dim, ctx.grp), None, None


def reduce_scatter_out(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' partial results summed over ``model`` (in fp32), this
    rank's slice along ``dim`` kept; the backward all-gathers the
    slices' gradients."""
    g = group()
    return x if g is None else _ReduceScatterOut.apply(x, dim % x.dim(), g)


def gather_in(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`gather_out` of the residual stream's slices before a
    column-parallel product: the backward keeps the rank's slice of a
    gradient the layer's :func:`copy_in` has summed over ``model``."""
    return gather_out(x, dim)


def seq_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a whole, replicated ``x``; the
    backward all-gathers, so the whole tensor gets its whole gradient."""
    g = group()
    return x if g is None else _SeqSlice.apply(x, dim % x.dim(), g)


def on_slice(p):
    """A replicated parameter (or a dict of them) used on the rank's slice
    of the sequence: its gradient summed over ``model``."""
    if isinstance(p, dict):
        return {k: on_slice(v) for k, v in p.items()}
    return copy_in(p) if isinstance(p, torch.Tensor) else p


def seq_out(x: torch.Tensor, scatter: bool) -> torch.Tensor:
    """A layer's output computed whole on every rank, as its caller holds
    it: the rank's slice of the sequence (dim 1) with ``scatter``, else
    ``x``."""
    return seq_slice(x, 1) if scatter else x


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """Identity; the gradient is summed over ``model`` (the input of a
    column-parallel product)."""
    g = group()
    return x if g is None else _CopyIn.apply(x, g.group)


def reduce_out(x: torch.Tensor, scatter: bool = False) -> torch.Tensor:
    """The ranks' partial results summed over ``model`` (the output of a
    row-parallel product). With ``scatter``, reduce-scattered along the
    sequence (dim 1) instead: the residual stream's slice."""
    g = group()
    if g is None:
        return x
    if scatter:
        return reduce_scatter_out(x, 1)
    return _ReduceOut.apply(x, g.group)


def gather_out(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slices along ``dim`` concatenated in rank order, for a
    replicated use; the backward keeps the rank's slice."""
    g = group()
    return x if g is None else _GatherOut.apply(x, dim % x.dim(), g)


def take(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated ``x`` (its
    gradient summed over ``model``)."""
    g = group()
    if g is None:
        return x
    n = x.shape[dim] // g.size
    return copy_in(x).narrow(dim, g.rank * n, n)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` (2-D, one low-precision dtype) with an fp32 result: the
    product accumulates in fp32 and is not rounded to the operands'
    dtype (``torch.mm``'s ``out_dtype`` on the card; the operands cast
    on the CPU, which has no such kernel). The backward's products are
    in the operands' dtype, as autograd's would be for ``a @ b``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.t(), a.t() @ g


def row_product(h: torch.Tensor, w: torch.Tensor,
                scatter: bool = False) -> torch.Tensor:
    """``h @ w`` for a row-parallel ``w`` (its rows the rank's slice of
    the contracted dim; ``h`` (..., k), ``w`` (k, n)), summed over
    ``model``, in ``h``'s dtype: the partial products in fp32, their sum
    in fp32, one rounding. With ``scatter`` the sum is reduce-scattered
    along the sequence (dim 1): the rank's slice. Outside tensor
    parallelism, ``h @ w``."""
    if group() is None:
        return h @ w
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h.dtype == torch.float32:
        part = h2 @ w
    else:
        part = _MatmulF32.apply(h2, w.to(h.dtype))
    part = part.reshape(*lead, w.shape[-1])
    return reduce_out(part, scatter).to(h.dtype)


# ---------------------------------------------------------------------------
# Cross-entropy over vocab shards
# ---------------------------------------------------------------------------

class _VocabCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` from this rank's
    vocab slice, in fp32: the max all-reduced with MAX, the sum of
    exponents with SUM, the label's logit from the rank that holds it.
    The backward is the rank's own slice of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, labels, g):
        import torch.distributed as tdist
        lo = g.rank * logits.shape[-1]
        x = logits.float()
        m = x.amax(dim=-1)
        tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=g.group)
        e = torch.exp(x - m[..., None])
        s = e.sum(dim=-1)
        local = labels - lo
        mine = (local >= 0) & (local < x.shape[-1])
        idx = torch.where(mine, local, torch.zeros_like(local))
        tgt = torch.where(mine, torch.gather(x, -1, idx[..., None])[..., 0],
                          torch.zeros_like(m))
        st = torch.stack([s, tgt])
        tdist.all_reduce(st, op=tdist.ReduceOp.SUM, group=g.group)
        s, tgt = st[0], st[1]
        ctx.save_for_backward(e, s, idx, mine)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - tgt

    @staticmethod
    def backward(ctx, gy):
        e, s, idx, mine = ctx.saved_tensors
        grad = e / s[..., None] * gy[..., None]
        hit = torch.where(mine, -gy, torch.zeros_like(gy))
        grad = grad.scatter_add(-1, idx[..., None], hit[..., None])
        return grad.to(ctx.dtype), None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        full_vocab: int) -> torch.Tensor:
    """``-log_softmax(logits)[label]`` a token (fp32), ``logits`` this
    rank's slice of the vocab where :func:`parts` says it is split, the
    whole vocab otherwise."""
    if parts(logits.shape[-1], full_vocab) == 1:
        lp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(lp, -1, labels[..., None])[..., 0]
    return _VocabCE.apply(logits, labels, group())
