"""Count-Min sketch kernels: the CUDA kernels of ``csrc/countmin.cu``
beside their plain versions in ``kernels/ref.py``.

* :func:`countmin_update` replaces the JAX package's
  ``kernels/countmin.py::countmin_update`` (``_cms_kernel``): the
  per-depth histogram of ``((id * a + b) mod (2^31 - 1)) mod width``,
  ids (n,) -> (depth, width) int32. One C call zeroes the increment
  (a memset) and adds every id once at all depths into it.
* :func:`countmin_add` is the same add into a copy of a running table,
  ``table + increment`` in one C call (a copy, then the add): what
  ``streams/sketches.py::countmin_add`` takes on the card. It counts
  its launches under ``countmin_update``.
* :func:`countmin_update_query` replaces ``::countmin_update_query``
  (``_cms_uq_kernel``): fold the batch into the table and estimate each
  id against the updated table (min over depths). ``table`` is not
  modified: one C call copies it, adds every id into the copy with the
  add above, then gathers in a second launch on the same stream, so
  every add lands before any read.

:func:`countmin_update_witness_cuda` runs the increment's first kernels
(a grid of blocks by depths, each id hashed once a depth), which the add
replaced; ``chip_smoke.py`` holds the add and the add-then-query to them
on the card. It is not counted in :data:`LAUNCHES`.

Both count with int32 atomics, so they are bitwise equal to their plain
versions at any count. The JAX package's fused kernel counts in fp32 and
is exact only below 2^24 (ROADMAP fault 9); the port is exact
everywhere. Each wrapper launches its kernel for a CUDA tensor, runs the
plain version for a CPU tensor, and raises for any other device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (countmin_add_ref, countmin_ref,
                                     countmin_update_query_ref)

LAUNCHES = {"countmin_update": 0, "countmin_update_query": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = _build.library("countmin")
    if not getattr(lib, "_typed", False):
        lib.countmin_add.argtypes = [_P, _L, _P, _I, _I, _P, _P, _P]
        lib.countmin_add.restype = _I
        lib.countmin_add_witness.argtypes = [_P, _L, _P, _I, _I, _P, _P]
        lib.countmin_add_witness.restype = _I
        lib.countmin_update_query.argtypes = [_P, _L, _P, _I, _I, _P, _P,
                                              _P, _P]
        lib.countmin_update_query.restype = _I
        lib._typed = True
    return lib


def _operands(ids, seeds, depth: int):
    dev = ids.device
    if ids.dim() != 1:
        raise ValueError(f"ids must be (n,), got {tuple(ids.shape)}")
    sd = torch.as_tensor(seeds).to(device=dev, dtype=torch.int32)
    if sd.shape != (depth, 2):
        raise ValueError(f"seeds must be ({depth}, 2), got {tuple(sd.shape)}")
    return ids.to(torch.int32).contiguous(), sd.contiguous()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _add(ids, sd, src, table) -> None:
    """table = src + the counts of ids (src None: the counts alone), in
    one C call on the current stream."""
    depth, width = table.shape
    with torch.cuda.device(ids.device):
        rc = _lib().countmin_add(
            ids.data_ptr(), ids.numel(), sd.data_ptr(), depth, width,
            None if src is None else src.data_ptr(), table.data_ptr(),
            _stream(ids.device))
    _build.check(rc, "countmin_add")
    if ids.numel():
        LAUNCHES["countmin_update"] += 1


def countmin_update_cuda(ids, depth: int, width: int, seeds):
    """The count-min kernel: the (depth, width) int32 increment."""
    _build.refuse_autograd("countmin_update", ids, seeds)
    idt, sd = _operands(ids, seeds, depth)
    out = torch.empty((depth, width), dtype=torch.int32, device=ids.device)
    _add(idt, sd, None, out)
    return out


def _table(ids, table):
    if table.device != ids.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    return table.to(torch.int32).contiguous()


def countmin_add_cuda(ids, table, seeds):
    """The count-min kernel into a copy of ``table``: ``table +`` the
    increment, as a new (depth, width) int32 table; ``table`` is not
    modified."""
    _build.refuse_autograd("countmin_add", ids, table, seeds)
    depth, _ = table.shape
    idt, sd = _operands(ids, seeds, depth)
    src = _table(ids, table)
    new_table = torch.empty_like(src)
    _add(idt, sd, src, new_table)
    return new_table


def countmin_update_witness_cuda(ids, depth: int, width: int, seeds):
    """The increment by the kernels the add replaced (uncounted)."""
    idt, sd = _operands(ids, seeds, depth)
    out = torch.zeros((depth, width), dtype=torch.int32, device=ids.device)
    with torch.cuda.device(ids.device):
        rc = _lib().countmin_add_witness(
            idt.data_ptr(), idt.numel(), sd.data_ptr(), depth, width,
            out.data_ptr(), _stream(ids.device))
    _build.check(rc, "countmin_add_witness")
    return out


def countmin_update_query_cuda(ids, table, seeds):
    """The add-then-query kernels: ``(new_table, est (n,) int32)``."""
    _build.refuse_autograd("countmin_update_query", ids, table, seeds)
    depth, width = table.shape
    idt, sd = _operands(ids, seeds, depth)
    src = _table(ids, table)
    new_table = torch.empty_like(src)
    est = torch.empty(idt.shape, dtype=torch.int32, device=ids.device)
    with torch.cuda.device(ids.device):
        rc = _lib().countmin_update_query(
            idt.data_ptr(), idt.numel(), sd.data_ptr(), depth, width,
            src.data_ptr(), new_table.data_ptr(), est.data_ptr(),
            _stream(ids.device))
    _build.check(rc, "countmin_update_query")
    if idt.numel():
        LAUNCHES["countmin_update_query"] += 1
    return new_table, est


def countmin_update(ids, depth: int, width: int, seeds):
    """The count-min increment on the ids' device: kernel on CUDA, plain
    version on the CPU."""
    if ids.device.type == "cuda":
        return countmin_update_cuda(ids, depth, width, seeds)
    if ids.device.type == "cpu":
        return countmin_ref(ids, depth, width, seeds)
    raise ValueError(f"countmin_update: no kernel for device {ids.device}")


def countmin_add(ids, table, seeds):
    """``table +`` the count-min increment of ``ids``, as a new table, on
    the ids' device: kernel on CUDA, plain version on the CPU."""
    if ids.device.type == "cuda":
        return countmin_add_cuda(ids, table, seeds)
    if ids.device.type == "cpu":
        return countmin_add_ref(ids, table, seeds)
    raise ValueError(f"countmin_add: no kernel for device {ids.device}")


def countmin_update_query(ids, table, seeds):
    """Add-then-query on the ids' device: kernel on CUDA, plain version
    on the CPU. Returns ``(new_table, est)``."""
    if ids.device.type == "cuda":
        return countmin_update_query_cuda(ids, table, seeds)
    if ids.device.type == "cpu":
        return countmin_update_query_ref(ids, table, seeds)
    raise ValueError(f"countmin_update_query: no kernel for device "
                     f"{ids.device}")
