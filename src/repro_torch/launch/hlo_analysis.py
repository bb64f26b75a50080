"""The traced-step analysis: the port's counterpart of the JAX package's
scan-aware HLO cost analysis (``launch/hlo_analysis.py`` there).

The port has no HLO. Its input is a traced aten step: a step function
and its arguments as fake tensors (``FakeTensorMode``: shapes, dtypes
and devices, no storage), placed on a mesh of a fake world
(``launch/mesh.py::fake_world``) where the cell asks for one. The step
runs once; every aten op it dispatches is seen, on one rank:

  * ``flops``      — :class:`~repro_torch.launch.op_count.OpCount`'s
                     operations: matrix products by
                     ``torch.utils.flop_counter``'s registry, one an
                     output element of a pointwise op, one an input
                     element of a reduction;
  * ``dot_flops``  — the matrix products alone: the JAX package's
                     definition of its ``flops`` (dot FLOPs);
  * ``hbm_bytes``  — OpCount's bytes: each aten op's inputs and outputs,
                     as if nothing were fused. An upper bound, not XLA's
                     fusion-aware model, and not scaled to look like it;
  * ``collectives`` — link bytes by kind: each collective op's result
                     bytes (``collective_out_bytes``) times the JAX
                     package's ring factors (all-reduce 2x, the others
                     1x; :func:`repro_torch.launch.roofline.
                     collective_bytes`), and their sum
                     ``collective_bytes_total``. Both kinds of collective
                     op are seen: the functional ones
                     (``_c10d_functional.all_gather_into_tensor``, ...)
                     that DTensor emits, and the in-place ``c10d`` ones
                     (``tdist.all_reduce`` shows up as
                     ``c10d.allreduce_``);
  * ``peak_bytes`` — ``MemTracker``'s peak of the step's live tensors,
                     the arguments included (summed over the rank's
                     device and the host's few scalars).

Under tensor and expert parallelism (``dist/tp.py``) a rank's products
are its own slice's, and its links the activations' all-reduces and
all-gathers over ``model`` the layers make.

Eager PyTorch runs every layer and microbatch loop unrolled, each op
dispatched as often as it runs, so there is nothing to scale by trip
counts. The analysis launches no CUDA kernel: the port's kernels are
``ctypes`` launches that a fake tensor cannot feed, and the dry run
traces the chunked paths only.
"""

from __future__ import annotations

import itertools
from typing import Dict

import torch
from torch._subclasses.fake_tensor import (FakeTensor, FakeTensorMode,
                                           unset_fake_temporarily)
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._tree import tree_leaves
from repro_torch.launch import roofline
from repro_torch.launch.op_count import OpCount

# collective ops by the JAX package's kinds: the functional ops
# (``_c10d_functional``) and the in-place process-group ops (``c10d``)
_KINDS = {
    "all-reduce": ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_", "allreduce_",
                   "allreduce_coalesced_"),
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced", "allgather_",
                   "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                       "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
    "collective-broadcast": ("broadcast", "broadcast_"),
}
_KIND_OF = {name: kind for kind, names in _KINDS.items() for name in names}
_NAMESPACES = ("_c10d_functional", "c10d")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CollectiveCount(TorchDispatchMode):
    """Result bytes of every collective op run while it is entered, by
    kind (``out_bytes``), and the ops by name (``ops``)."""

    def __init__(self):
        super().__init__()
        self.out_bytes: Dict[str, float] = {}
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor run its local ops
        out = func(*args, **(kwargs or {}))
        if func.namespace not in _NAMESPACES:
            return out
        name = func.overloadpacket.__name__
        if name in _KIND_OF:
            kind = _KIND_OF[name]
            self.out_bytes[kind] = self.out_bytes.get(kind, 0.0) + float(
                _nbytes(out))
            key = f"{func.namespace}.{name}"
            self.ops[key] = self.ops.get(key, 0) + 1
        return out


def _arg_tensors(args, kwargs):
    """The tensors among an aten op's arguments (a list argument's
    included)."""
    for a in itertools.chain(args, kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


class HostScalars(TorchDispatchMode):
    """Entered above a ``FakeTensorMode``: an op that stays on the host
    and whose tensors are all real CPU tensors, or a factory of a 0-dim
    CPU tensor, runs for real. The port keeps some control on the host
    as CPU scalars (each cache's ``length``, which the attention reads
    with ``int``); a fake tensor has no value to read."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":
            return func(*args, **kwargs)
        dev = kwargs.get("device")
        ts = list(_arg_tensors(args, kwargs))
        if dev is not None and torch.device(dev).type != "cpu":
            real = False
        elif ts:
            real = all(not isinstance(t, FakeTensor) and t.device.type == "cpu"
                       for t in ts)
        else:
            size = args[0] if args else kwargs.get("size")
            real = isinstance(size, (list, tuple)) and len(size) == 0
        if not real:
            return func(*args, **kwargs)
        with unset_fake_temporarily():
            return func(*args, **kwargs)


def fake_tensor_mode():
    """A ``FakeTensorMode`` for a dry-run cell; real CPU scalars (see
    :class:`HostScalars`) may enter its ops."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def local_tensors(tree) -> list:
    """Every tensor leaf of ``tree`` as this rank holds it (a DTensor's
    local shard)."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def fake_mode_of(tree):
    """The ``FakeTensorMode`` of ``tree``'s fake tensors; ``ValueError``
    for a real tensor off the host's scalars, or no fake tensor."""
    modes = set()
    for t in local_tensors(tree):
        if isinstance(t, FakeTensor):
            modes.add(t.fake_mode)
        elif t.device.type != "cpu" or t.dim() > 1:
            raise ValueError("the traced-step analysis takes fake tensors "
                             f"and host scalars; got a real {t.device} "
                             f"tensor of shape {tuple(t.shape)}")
    if len(modes) != 1:
        raise ValueError(f"expected the tensors of one FakeTensorMode, "
                         f"found {len(modes)}")
    return modes.pop()


def analyze(fn, args) -> dict:
    """Run ``fn(*args)`` once on its fake arguments and count its work
    on this rank (the module docstring's keys)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    mode = fake_mode_of(args)
    mem = MemTracker()
    mem.track_external(*local_tensors(args))
    coll = CollectiveCount()
    with mode, HostScalars(), mem, OpCount() as count, coll:
        fn(*args)
    peak = mem.get_tracker_snapshot("peak")
    out = {"flops": count.flops, "dot_flops": count.products,
           "hbm_bytes": count.bytes,
           "collective_out_bytes": dict(coll.out_bytes),
           "collective_ops": dict(coll.ops),
           "peak_bytes": sum(int(snap["Total"]) for snap in peak.values())}
    link = roofline.collective_bytes(out)
    out["collective_bytes_total"] = link.pop("total")
    out["collectives"] = link
    return out


__all__ = ["CollectiveCount", "HostScalars", "analyze", "fake_mode_of",
           "fake_tensor_mode", "local_tensors"]
