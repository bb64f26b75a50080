"""Uplink codecs: the pluggable compression protocol attached to
:class:`~repro_torch.core.costmodel.Link` objects in a ``ClusterSpec``.

A :class:`UplinkCodec` bundles the three views one compression scheme
needs across the stack:

  * **pricing** — ``ratio`` (wire bytes as a fraction of the raw fp32
    payload) lets :func:`~repro_torch.core.costmodel.evaluate_graph_plan`
    charge codec-compressed bytes on every crossing link;
  * **admission** — ``error_bound`` is the codec's accumulated relative
    error bound (the telescoping error-feedback residual, normalized by
    the stream's peak magnitude). :func:`repro_torch.core.sla.pick_codec`
    admits a codec only when this bound fits the SLA error budget; the
    bounds are the JAX package's, and ``tests/test_torch_codecs.py``
    checks that they hold for the port's round-trips;
  * **execution** — ``roundtrip(residual, x) -> (decoded, residual)`` is
    the wire transform with error-feedback carry the orchestrator applies
    to batch tensors crossing the edge->cloud boundary.

All codecs are built from the :mod:`repro_torch.dist.compression`
primitives; ``topk_int8_ef`` is the composed scheme (sparsify first,
then int8-quantize the survivors) sharing ONE residual so the
telescoping identity ``sum(decoded) + residual == sum(true)`` holds for
the composition exactly as it does for each half. On the card,
``int8_ef`` and ``topk_int8_ef`` run the port's EF kernels; the other
codecs are plain torch.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.compression import (dequantize_int8, ef_init,
                                          ef_roundtrip, ef_topk_int8_roundtrip,
                                          ef_topk_roundtrip, quantize_int8)

# one int8 quantum, relative to the tensor's peak magnitude: the EF carry
# keeps accumulated error under ~2 quanta (see ef_roundtrip's bounded-
# error test), so the admission bound is 2/127.
_INT8_QUANTUM = 1.0 / 127.0

Roundtrip = Callable[[torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class UplinkCodec:
    """One uplink compression scheme: pricing ratio, tested accumulated
    error bound, and the error-feedback wire transform.

    ``error_bound`` is relative: after any number of round-trips over a
    stream of tensors, ``max|cum(decoded) - cum(true)| <= error_bound *
    max|x|`` (by the telescoping EF identity the accumulated error IS the
    carried residual, so this is a bound on the residual magnitude).
    """
    name: str
    ratio: float                   # wire bytes / raw fp32 payload bytes
    error_bound: float             # accumulated relative error (tested)
    roundtrip: Roundtrip = field(repr=False, compare=False,
                                 default=lambda r, x: (x, r))

    @property
    def lossless(self) -> bool:
        return self.error_bound == 0.0

    def wire_bytes(self, raw_bytes: float) -> float:
        """Bytes that actually cross the link for a raw fp32 payload."""
        return raw_bytes * self.ratio

    def init_residual(self, x: torch.Tensor) -> torch.Tensor:
        return ef_init(x)


def _identity_roundtrip(residual, x):
    return x, residual


def _topk_int8_roundtrip(residual, x, k_frac: float):
    """Composed sparsify-then-quantize wire round-trip with ONE shared
    error-feedback residual: the dropped coordinates AND the quantization
    error of the survivors are both carried to the next round. The
    mask/amax/quantize/carry chain is the ``ef_topk_int8_roundtrip``
    kernel (selection by magnitude threshold — identical to exact top-k
    for tie-free inputs, and the EF telescoping identity holds for any
    selection, so ``error_bound`` is unchanged)."""
    k = max(1, int(round(k_frac * x.numel())))
    return ef_topk_int8_roundtrip(residual, x, k)


def identity_codec() -> UplinkCodec:
    """Lossless pass-through (the default on every link)."""
    return UplinkCodec("identity", ratio=1.0, error_bound=0.0,
                       roundtrip=_identity_roundtrip)


def int8_ef_codec() -> UplinkCodec:
    """Symmetric per-tensor int8 with error feedback: 4x fewer bytes,
    accumulated error bounded by ~2 quanta of the peak magnitude."""
    return UplinkCodec("int8_ef", ratio=0.25,
                       error_bound=2.0 * _INT8_QUANTUM,
                       roundtrip=ef_roundtrip)


def _parameterized_name(base: str, k_frac: float) -> str:
    """Codec names must be bijective with behavior: Link stores only the
    name, so a non-default ``k_frac`` gets its own registry entry (e.g.
    ``topk_ef_k0.25``) and pricing resolves the codec that actually
    runs, not the default-parameter one."""
    return base if k_frac == 0.1 else f"{base}_k{k_frac:g}"


def topk_ef_codec(k_frac: float = 0.1) -> UplinkCodec:
    """Top-k sparsification with error feedback: ship ``(value fp32,
    index int32)`` pairs for the ``k_frac`` largest coordinates (8 bytes
    each vs 4 per dense fp32 -> ratio ``2*k_frac``). The EF carry bounds
    the accumulated error by one round-robin sweep of dropped mass:
    ``(1/k_frac) * max|x|`` (the ``ef_topk_roundtrip`` tested bound)."""
    if not 0.0 < k_frac <= 1.0:
        raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")

    def rt(residual, x):
        k = max(1, int(round(k_frac * x.numel())))
        return ef_topk_roundtrip(residual, x, k)

    return _register(UplinkCodec(
        _parameterized_name("topk_ef", k_frac), ratio=2.0 * k_frac,
        error_bound=1.0 / k_frac, roundtrip=rt))


def topk_int8_ef_codec(k_frac: float = 0.1) -> UplinkCodec:
    """The composed codec: top-k sparsify, then int8-quantize the
    surviving values (1-byte value + 4-byte index per kept coordinate ->
    ratio ``1.25*k_frac``; a third of ``int8_ef`` at k=10%). One shared
    residual carries both error sources, so the bounds add:
    ``1/k_frac + 2/127`` (property-tested under composition)."""
    if not 0.0 < k_frac <= 1.0:
        raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")

    def rt(residual, x):
        return _topk_int8_roundtrip(residual, x, k_frac)

    return _register(UplinkCodec(
        _parameterized_name("topk_int8_ef", k_frac), ratio=1.25 * k_frac,
        error_bound=1.0 / k_frac + 2.0 * _INT8_QUANTUM, roundtrip=rt))


# -- KV-cache codecs ---------------------------------------------------------
# Serving ships *state* over the wire (the prefill op's KV cache riding
# the cloud->edge downlink), not an accumulating gradient stream: every
# wave's payload is fresh, so these codecs carry NO error feedback — the
# residual passes through untouched (zeros) and the per-payload bound IS
# the accumulated bound. They are registered but deliberately NOT in
# DEFAULT_CODECS: gradient jobs keep their EF ladder; serving jobs pass
# the KV ladder explicitly (StreamJob.uplink_codecs / KV_CODECS).

def _kv_int8_roundtrip(residual, x):
    dec = dequantize_int8(*quantize_int8(x))
    return dec.to(x.dtype), residual


def kv_int8_codec() -> UplinkCodec:
    """Symmetric per-tensor int8 over attention state (KV cache), no
    error feedback: each shipped cache decodes within one int8 quantum
    of its peak magnitude (``1/127``), independently per wave."""
    return _register(UplinkCodec("kv_int8", ratio=0.25,
                                 error_bound=_INT8_QUANTUM,
                                 roundtrip=_kv_int8_roundtrip))


# fixed seeded orthonormal bases for the latent projection, cached per
# (feature dim, latent dim) — both wire endpoints derive the identical
# basis from the seed, so only the int8 latent crosses the link
_KV_BASES: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _latent_basis(d: int, r: int, device) -> torch.Tensor:
    key = (d, r, str(device))
    basis = _KV_BASES.get(key)
    if basis is None:
        rng = np.random.default_rng(20260809 + 1000 * d + r)
        q, _ = np.linalg.qr(rng.standard_normal((d, r)))
        basis = torch.as_tensor(q, dtype=torch.float32, device=device)
        _KV_BASES[key] = basis
    return basis


def _kv_latent_roundtrip(residual, x, r_frac: float):
    """Project the head/feature (last) axis onto a fixed seeded
    orthonormal ``r = r_frac * D`` basis (the MLA-style latent view of
    attention state), int8 the latent, and reconstruct."""
    d = int(x.shape[-1]) if x.dim() else 1
    r = max(1, int(round(r_frac * d)))
    if x.dim() == 0 or r >= d:
        dec = dequantize_int8(*quantize_int8(x))
        return dec.to(x.dtype), residual
    basis = _latent_basis(d, r, x.device)
    z = x.float() @ basis
    zq = dequantize_int8(*quantize_int8(z))
    dec = zq @ basis.T
    return dec.to(x.dtype), residual


def kv_latent_codec(r_frac: float = 0.5) -> UplinkCodec:
    """Latent-projected int8 KV compression: rank ``r_frac * D`` down the
    feature axis, then int8 the latent — ``0.25 * r_frac`` of the raw
    bytes. The declared bound is *distributional*: for approximately
    isotropic attention state a random rank-r orthonormal projection
    keeps ``r/D`` of the energy in expectation, so the relative RMS
    reconstruction error concentrates near ``sqrt(1 - r_frac)`` (plus
    one int8 quantum on the latent); property-tested with margin on
    Gaussian and real zoo KV tensors. Adversarial inputs concentrated in
    the discarded subspace can exceed it — a serving budget admitting
    this codec accepts that distributional (not worst-case) contract."""
    if not 0.0 < r_frac <= 1.0:
        raise ValueError(f"r_frac must be in (0, 1], got {r_frac}")

    def rt(residual, x):
        return _kv_latent_roundtrip(residual, x, r_frac)

    name = "kv_latent" if r_frac == 0.5 else f"kv_latent_r{r_frac:g}"
    return _register(UplinkCodec(
        name, ratio=0.25 * r_frac,
        error_bound=(1.0 - r_frac) ** 0.5 + _INT8_QUANTUM, roundtrip=rt))


# The registry Link codec names resolve through. Constructors register
# their instances (parameterized variants under k_frac-qualified names),
# so pricing always resolves the codec whose roundtrip actually runs.
_REGISTRY: Dict[str, UplinkCodec] = {}


def _register(codec: UplinkCodec) -> UplinkCodec:
    return _REGISTRY.setdefault(codec.name, codec)


# The candidate set sla.pick_codec chooses from. Ordered loosely by
# fidelity; pick_codec sorts by ratio itself.
DEFAULT_CODECS: Sequence[UplinkCodec] = (
    _register(identity_codec()),
    _register(int8_ef_codec()),
    topk_ef_codec(),
    topk_int8_ef_codec(),
)

# The serving ladder: the candidate set a KV-shipping job hands to
# admission (most faithful -> cheapest wire). Not part of
# DEFAULT_CODECS — gradient-uplink jobs never silently admit a
# distributional-bound codec.
KV_CODECS: Sequence[UplinkCodec] = (
    _REGISTRY["identity"],
    kv_int8_codec(),
    kv_latent_codec(),
)


_PARAM_NAME = re.compile(r"^(topk_ef|topk_int8_ef)_k([0-9.eE+-]+)$")
_PARAM_CTORS = {"topk_ef": topk_ef_codec, "topk_int8_ef": topk_int8_ef_codec}
_KV_PARAM_NAME = re.compile(r"^kv_latent_r([0-9.eE+-]+)$")


def get_codec(name: str) -> UplinkCodec:
    """Resolve a codec by its registry name (as stored on a Link).

    Parameterized names following the ``_parameterized_name`` scheme
    (``topk_ef_k0.25``) are constructed on demand, so a name arriving
    from config/serialization resolves without the matching constructor
    having run in this process."""
    codec = _REGISTRY.get(name)
    if codec is not None:
        return codec
    m = _PARAM_NAME.match(name)
    if m is not None:
        try:
            return _PARAM_CTORS[m.group(1)](float(m.group(2)))
        except ValueError as e:
            raise KeyError(f"bad uplink codec name {name!r}: {e}") from None
    m = _KV_PARAM_NAME.match(name)
    if m is not None:
        try:
            return kv_latent_codec(float(m.group(1)))
        except ValueError as e:
            raise KeyError(f"bad uplink codec name {name!r}: {e}") from None
    raise KeyError(f"unknown uplink codec {name!r}; known: "
                   f"{sorted(_REGISTRY)} (or a parameterized "
                   f"'topk_ef_k<frac>' / 'topk_int8_ef_k<frac>' / "
                   f"'kv_latent_r<frac>' name)")
