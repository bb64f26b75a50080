"""Plain-torch twins of the JAX package's kernel oracles
(``repro/kernels/ref.py``) for the kernels on the port's current path.

Each is the plain version its CUDA kernel is held against: the kernel
wrappers run these for tensors on the CPU, the tests hold them to the
JAX oracles, and ``chip_smoke.py`` holds each kernel to them on the
card. They run on any device.
"""

from __future__ import annotations

import torch

HASH_P = 2_147_483_647
HASH_C = 0x9E37
QMAX = 127.0


def fused_normalize_ref(x, n0, mean0, m20, *, impute: bool = True):
    """Impute (NaN -> prior mean) + Welford merge + normalize: the
    composition ``impute_with_mean`` then ``norm_update_apply``."""
    x = x.float()
    dev = x.device
    mean0 = torch.as_tensor(mean0, dtype=torch.float32, device=dev)
    m20 = torch.as_tensor(m20, dtype=torch.float32, device=dev)
    n0 = torch.as_tensor(n0, dtype=torch.float32, device=dev)
    if impute:
        x = torch.where(torch.isnan(x), mean0[None, :], x)
    nb = x.shape[0]
    mean_b = x.mean(0)
    m2_b = torch.square(x - mean_b).sum(0)
    n1 = n0 + nb
    delta = mean_b - mean0
    mean1 = mean0 + delta * (nb / torch.clamp(n1, min=1.0))
    m21 = m20 + m2_b + torch.square(delta) * n0 * nb / torch.clamp(n1, min=1.0)
    var = m21 / torch.clamp(n1 - 1.0, min=1.0)
    y = (x - mean1) * torch.rsqrt(var + 1e-6)
    return y, n1, mean1, m21


def hash_slots(ids: torch.Tensor, dim: int, seed: int = 17):
    """``(slot, sign)`` of signed feature hashing, with jnp's semantics:
    ``id * a + 0x9E37`` wraps in int32, and ``%``/``//`` floor."""
    a = 2 * seed + 1
    h = (ids.to(torch.int64) * a + HASH_C) & 0xFFFFFFFF
    h = torch.where(h >= 2 ** 31, h - 2 ** 32, h)          # int32 wrap
    h = torch.remainder(h, HASH_P)
    slot = torch.remainder(h, dim)
    odd = torch.remainder(torch.div(h, dim, rounding_mode="floor"), 2) == 1
    return slot, odd


def hash_features_ref(ids, vals, dim: int, seed: int = 17):
    """Signed feature hashing: ids/vals (n, f) -> dense (n, dim) fp32.
    Features are added into each row in feature order, as the oracle's
    scatter-add applies them, so the sums are bitwise the oracle's."""
    slot, odd = hash_slots(ids, dim, seed)
    v = vals.float()
    contrib = torch.where(odd, -v, v)
    n, f = ids.shape
    out = torch.zeros((n, dim), dtype=torch.float32, device=vals.device)
    for j in range(f):
        out.scatter_add_(1, slot[:, j:j + 1], contrib[:, j:j + 1])
    return out


def ef_int8_roundtrip_ref(residual, x):
    """Int8 error-feedback wire round-trip: fold the carried residual,
    symmetric per-tensor int8 quantize-dequantize, carry the fresh
    error. ``(decoded, new_residual)``."""
    xc = x.float() + residual
    amax = torch.max(torch.abs(xc))
    scale = torch.clamp(amax, min=1e-30) / QMAX
    q = torch.clamp(torch.round(xc / scale), -QMAX, QMAX)
    dec = q * scale
    return dec.to(x.dtype), xc - dec


def topk_threshold(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value of the flat tensor ``a`` (0-dim)."""
    return torch.topk(a, k, sorted=False).values.min()


def ef_topk_int8_roundtrip_ref(residual, x, k: int):
    """Top-k + int8 EF round-trip with one shared residual. Selection is
    by magnitude threshold (the k-th largest ``|x + residual|``), so ties
    at the threshold are all kept."""
    xc = x.reshape(-1).float() + residual.reshape(-1)
    k = max(1, min(int(k), xc.shape[0]))
    t = topk_threshold(torch.abs(xc), k)
    kept = torch.abs(xc) >= t
    zero = torch.zeros((), dtype=torch.float32, device=xc.device)
    amax = torch.max(torch.where(kept, torch.abs(xc), zero))
    scale = torch.clamp(amax, min=1e-30) / QMAX
    q = torch.clamp(torch.round(torch.where(kept, xc, zero) / scale),
                    -QMAX, QMAX)
    dec = torch.where(kept, q * scale, zero)
    shape = x.shape
    return dec.reshape(shape).to(x.dtype), (xc - dec).reshape(shape)
