"""A count of the work one pipeline-op step does: operations and bytes,
the port's counterpart of XLA's cost analysis of a compiled step.

:class:`OpCount` is a ``TorchDispatchMode``: it sees every aten op the
step runs, on any device, and counts

* matrix products by ``torch.utils.flop_counter``'s registry (``mm``,
  ``addmm``, ``bmm``, convolutions, attention), plus ``mv`` and ``dot``
  (2 per multiply-add), which the registry leaves out;
* one operation per output element for a pointwise op and one per input
  element for a reduction, as XLA's HLO cost analysis counts them;
* bytes as each op's tensor inputs plus its outputs; a view moves none,
  nor does a metadata query (``prim.device``, which a fake tensor
  dispatches).

The matrix products' share is kept apart as well (``products``): the
JAX package's HLO analysis counts those alone.

Each aten op is counted on its own, as if nothing were fused, so the
bytes are an upper bound next to XLA's ``bytes accessed`` of a fused
program (normalize's few pointwise passes count a read and a write of x
each). ``torch.utils.flop_counter`` alone would count 0 for normalize,
a sketch or a drift scan.

The port's CUDA kernels are ``ctypes`` launches, invisible to a dispatch
mode, and on the CPU their plain versions run in their place. So while
a count is active each dispatcher in ``kernels/ops.py`` adds its
kernel's work by the formula of ``chip_smoke.py``'s bound column
(:func:`kernel`) and runs its body with counting suspended: the CPU and
the card count the same op alike.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_ACTIVE: list = []      # the counts in force, innermost last

_aten = torch.ops.aten


_VIEWS: dict = {}        # op -> whether it returns a view (its schema's)


def _is_view(func) -> bool:
    v = _VIEWS.get(func)
    if v is None:
        v = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return v


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_ops(func, args, kwargs, out) -> Optional[float]:
    """Operations of a matrix product, or None if ``func`` is not one."""
    packet = func.overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if packet is _aten.mv:
        m, n = args[0].shape
        return 2.0 * m * n
    if packet is _aten.dot:
        return 2.0 * args[0].numel()
    return None


class OpCount(TorchDispatchMode):
    """Operations and bytes of the aten ops run while it is entered, plus
    the kernels' work that the dispatchers add (:func:`kernel`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.products = 0.0     # the matrix products' share of flops
        self.bytes = 0.0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or _is_view(func):
            return out      # a fake tensor's metadata query, or a view
        outs = _tensors(out)
        ops = _product_ops(func, args, kwargs, out)
        if ops is not None:
            self.products += ops
        else:
            ops = 0.0
            if torch.Tag.pointwise in func.tags:
                ops = float(sum(t.numel() for t in outs))
            elif torch.Tag.reduction in func.tags:
                ins = _tensors((args, kwargs))
                ops = float(ins[0].numel()) if ins else 0.0
        self.flops += ops
        self.bytes += float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                            + sum(_nbytes(t) for t in outs))
        return out


def active() -> Optional[OpCount]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel(flops: float, nbytes: float):
    """A dispatcher's body: with a count active, add the kernel's work to
    it and run the body with counting suspended; else do nothing."""
    count = active()
    if count is None:
        yield
        return
    count.flops += float(flops)
    count.bytes += float(nbytes)
    _ACTIVE.append(None)        # a dispatcher inside the body adds nothing
    try:
        with _disable_current_modes():
            yield
    finally:
        _ACTIVE.pop()
