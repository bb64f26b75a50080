"""Edge-uplink gradient compression (symmetric int8 + top-k).

Edge workers in the S2CE deployment sync gradients to the cloud over
constrained links; symmetric per-tensor int8 cuts uplink bytes 4x
versus fp32 with a per-element error bounded by ``scale/2``.
``ef_quantize``/``ef_roundtrip`` add error feedback (residual carry):
quantization error is folded into the next round's payload instead of
being lost, so the accumulated error over a stream of updates stays
bounded by one quantum. ``compressed_allreduce_mean`` is the collective
form: each participant quantizes its local tensor, the mean runs over
the *dequantized* values, and a scalar error estimate rides along for
monitoring.

``topk_sparsify`` is the orthogonal axis: ship only the ``k``
largest-magnitude coordinates (``8k`` wire bytes instead of ``4d``),
and ``ef_topk``/``ef_topk_roundtrip`` carry the dropped mass forward
as a residual so every coordinate is eventually transmitted. The two
schemes compose: sparsify first, then quantize the surviving values.

:func:`ef_roundtrip` and :func:`ef_topk_int8_roundtrip` are the uplink
codecs' hot path: on the card each is one of the port's EF kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops as kops

_QMAX = 127.0


def quantize_int8(x: torch.Tensor, amax=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale fp32) with
    ``x ~= q * scale`` and elementwise error <= scale/2. ``amax`` (a
    0-dim tensor) is the whole tensor's largest magnitude where ``x`` is
    one rank's shard of it (the max over the shards' own): one scale for
    the whole tensor, as the unsharded wire format has; by default
    ``x``'s own."""
    xf = x.float()
    if amax is None:
        amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-30) / _QMAX
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_roundtrip(x: torch.Tensor, amax=None) -> torch.Tensor:
    """Quantize-dequantize in one step (what the wire does to a tensor;
    ``amax`` as in :func:`quantize_int8`)."""
    return dequantize_int8(*quantize_int8(x, amax)).to(x.dtype)


# ---------------------------------------------------------------------------
# Error feedback (residual carry)
# ---------------------------------------------------------------------------

def ef_init(x: torch.Tensor) -> torch.Tensor:
    """Zero residual matching ``x`` on x's device (always fp32: the carry
    must not lose precision to the payload dtype)."""
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def ef_quantize(residual: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 compression step: the carried residual is
    folded in before quantizing and the fresh error is carried forward:
    ``(q, scale, new_residual)``."""
    xc = x.float() + residual
    q, scale = quantize_int8(xc)
    return q, scale, xc - dequantize_int8(q, scale)


def ef_roundtrip(residual: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wire round-trip with residual carry: ``(decoded, new_residual)``.
    The ``ef_int8_roundtrip`` kernel on the card, its plain version on
    the CPU; both satisfy ``decoded + new_residual == x + residual``."""
    return kops.ef_int8_roundtrip(residual, x)


# ---------------------------------------------------------------------------
# Top-k sparsification (+ error feedback)
# ---------------------------------------------------------------------------

def topk_sparsify(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``k`` largest-|.| coordinates of the flattened tensor:
    ``(values fp32 (k,), indices int64 (k,))``. ``k`` is clamped."""
    flat = x.reshape(-1).float()
    k = max(1, min(int(k), flat.shape[0]))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_densify(values: torch.Tensor, indices: torch.Tensor,
                 shape) -> torch.Tensor:
    """Scatter the sparse payload back to a dense fp32 tensor."""
    size = 1
    for s in shape:
        size *= int(s)
    dense = torch.zeros((size,), dtype=torch.float32, device=values.device)
    dense[indices] = values
    return dense.reshape(tuple(shape))


def topk_roundtrip(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sparsify-densify in one step (what the wire does to a tensor)."""
    v, i = topk_sparsify(x, k)
    return topk_densify(v, i, x.shape).to(x.dtype)


def ef_topk(residual: torch.Tensor, x: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback top-k sparsification step (DGC-style memory):
    ``(values, indices, new_residual)``."""
    xc = x.float() + residual
    v, i = topk_sparsify(xc, k)
    return v, i, xc - topk_densify(v, i, xc.shape)


def ef_topk_roundtrip(residual: torch.Tensor, x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wire round-trip with residual carry: ``(decoded, new_residual)``."""
    v, i, residual = ef_topk(residual, x, k)
    return topk_densify(v, i, x.shape).to(x.dtype), residual


def ef_topk_int8_roundtrip(residual: torch.Tensor, x: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composed top-k + int8 wire round-trip with ONE shared residual:
    the ``ef_topk_int8_roundtrip`` kernel on the card, its plain version
    on the CPU. Selection is by the k-th-largest-magnitude threshold, so
    ties at the threshold are all kept (identical to exact top-k for
    tie-free inputs); the EF identity holds for any selection."""
    return kops.ef_topk_int8_roundtrip(residual, x, int(k))


def compressed_allreduce_mean(x: torch.Tensor, group=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of int8-compressed per-worker tensors.

    With ``group`` (a process group, or the name of a dim of the active
    ``DeviceMesh``), each rank quantizes its own tensor and
    ``all_reduce(AVG)`` over the group averages the dequantized values
    and the error: the wire-equivalent path. Without it, the leading dim
    of ``x`` is the worker dim (host-side simulation of the uplink).

    Returns ``(mean, err)`` where ``err`` is the mean per-worker max
    quantization error — finite by construction, useful as an SLA
    telemetry signal.
    """
    if group is not None:
        import torch.distributed as tdist
        if isinstance(group, str):
            from repro_torch.dist import current_mesh
            group = current_mesh().get_group(group)
        xf = x.float()
        deq = int8_roundtrip(xf)
        err = torch.max(torch.abs(deq - xf)).reshape(1)
        tdist.all_reduce(deq, op=tdist.ReduceOp.AVG, group=group)
        tdist.all_reduce(err, op=tdist.ReduceOp.AVG, group=group)
        return deq, err[0]
    xf = x.float()
    deq = torch.stack([int8_roundtrip(w) for w in xf])
    gap = torch.abs(deq - xf)
    per_worker = gap.reshape(gap.shape[0], -1).amax(dim=1) if gap.dim() > 1 \
        else gap
    return deq.mean(dim=0), per_worker.mean()
