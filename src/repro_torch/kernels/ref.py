"""Plain-torch twins of the JAX package's kernel oracles
(``repro/kernels/ref.py``), and of its Misra-Gries scan
(``streams/sketches.py::mg_update``).

Each is the plain version its CUDA kernel is held against: the kernel
wrappers run these for tensors on the CPU, the tests hold them to the
JAX oracles, and ``chip_smoke.py`` holds each kernel to them on the
card. They run on any device. ``mg_update_chunked_ref``,
``ddm_scan_restart_ref``, ``adwin_scan_restart_ref``,
``rwkv6_wkv_chunked_ref``,
``hash_features_grouped_ref``, ``fused_normalize_slices_ref`` and
``mamba_scan_lanes_ref`` spell out the kernel algorithms of the two
chained scans, of the WKV tensor-core kernel, of the staged hash kernel,
of the persistent normalize and of the lane-split Mamba scan for the CPU
tests (and ``chip_smoke.py``) only; nothing on a main path calls them.
"""

from __future__ import annotations

import math

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


NORM_THREADS = 512  # threads a CTA of the persistent normalize kernel


def fused_normalize_slices_ref(x, n0, mean0, m20, *, impute: bool = True,
                               ctas: int = 132, vec: bool = True):
    """The persistent normalize kernel's order of sums (``csrc/
    preprocess.cu``, ``normalize_persistent``), spelled out for the CPU
    tests: CTA ``b`` of ``ctas`` owns rows ``[b n / ctas, (b + 1) n /
    ctas)``; a column's ``L`` row lanes (``NORM_THREADS`` over the column
    vectors of a tile, 4 floats a vector where ``vec`` and d % 4 == 0)
    each sum x and x^2 over rows ``l, l + L, ...`` of the slice in order,
    the lanes are added in lane order, the CTAs' partials in CTA order,
    and the merge is the TPU kernel's, from raw moments."""
    x = x.float()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    mean0 = torch.as_tensor(mean0, **f32)
    m20 = torch.as_tensor(m20, **f32)
    n0 = torch.as_tensor(n0, **f32)
    if impute:
        x = torch.where(torch.isnan(x), mean0[None, :], x)
    n, d = x.shape
    q = d // 4 if vec and d % 4 == 0 else d
    lanes = NORM_THREADS // min(q, NORM_THREADS)
    s1 = torch.zeros(d, **f32)
    s2 = torch.zeros(d, **f32)
    for b in range(ctas):
        xs = x[b * n // ctas:(b + 1) * n // ctas]
        l1 = torch.zeros((lanes, d), **f32)
        l2 = torch.zeros((lanes, d), **f32)
        for k in range(0, xs.shape[0], lanes):
            blk = xs[k:k + lanes]
            m = blk.shape[0]
            l1[:m] = l1[:m] + blk
            l2[:m] = l2[:m] + blk * blk
        p1 = torch.zeros(d, **f32)
        p2 = torch.zeros(d, **f32)
        for lane in range(lanes):
            p1 = p1 + l1[lane]
            p2 = p2 + l2[lane]
        s1 = s1 + p1
        s2 = s2 + p2
    nb = torch.tensor(float(n), **f32)
    mean_b = s1 / nb
    m2_b = torch.clamp(s2 - nb * mean_b * mean_b, min=0.0)
    n1 = n0 + nb
    delta = mean_b - mean0
    denom = torch.clamp(n1, min=1.0)
    mean1 = mean0 + delta * (nb / denom)
    m21 = m20 + m2_b + delta * delta * n0 * nb / denom
    var = m21 / torch.clamp(n1 - 1.0, min=1.0)
    rstd = 1.0 / torch.sqrt(var + 1e-6)
    y = (x - mean1) * rstd
    return y, n1, mean1, m21


def _wrap_int32(h: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to int32 two's complement (still int64)."""
    h = h & 0xFFFFFFFF
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h)


def hash_slots(ids: torch.Tensor, dim: int, seed: int = 17):
    """``(slot, sign)`` of signed feature hashing, with jnp's semantics:
    ``id * a + 0x9E37`` wraps in int32, and ``%``/``//`` floor."""
    a = 2 * seed + 1
    h = _wrap_int32(ids.to(torch.int64) * a + HASH_C)
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


HASH_PASS = 32     # features a warp takes at once in the staged hash kernel


def hash_features_grouped_ref(ids, vals, dim: int, seed: int = 17):
    """The staged hash kernel's order of adds (``csrc/preprocess.cu``,
    ``hash_staged``), spelled out for the CPU tests: per row, passes of
    ``HASH_PASS`` features; in a pass the features whose slots are equal
    form a group, and the group's first feature reads its cell (+0.0 at
    the start), adds the group's values onto it in feature order and
    stores the sum once. Bitwise :func:`hash_features_ref`."""
    slot, odd = hash_slots(ids, dim, seed)
    v = vals.float()
    contrib = torch.where(odd, -v, v)
    n, f = ids.shape
    out = torch.zeros((n, dim), dtype=torch.float32, device=vals.device)
    for p in range(0, f, HASH_PASS):
        s, c = slot[:, p:p + HASH_PASS], contrib[:, p:p + HASH_PASS]
        w = s.shape[1]
        same = s[:, :, None] == s[:, None, :]              # (n, lane, peer)
        lead = torch.argmax(same.to(torch.int8), dim=2)     # first peer
        sums = torch.gather(out, 1, s)                      # cells at start
        for j in range(w):
            col = lead[:, j:j + 1]
            sums.scatter_(1, col, torch.gather(sums, 1, col) + c[:, j:j + 1])
        leader = lead == torch.arange(w, device=s.device)
        rows = torch.arange(n, device=s.device)[:, None].expand(n, w)
        out[rows[leader], s[leader]] = sums[leader]
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
    """The k-th largest value of the flat tensor ``a`` (0-dim) by
    ``torch.topk``: NaN if ``a`` holds one (``min`` propagates it). The
    top-k kernel's select replaced it on the path; it stays as that
    select's witness and library yardstick."""
    return torch.topk(a, k, sorted=False).values.min()


# the top-k select's digits of a key (the 31 bits of |v|: bit 31 is the
# sign): (shift, bits), top digit first; csrc/ef_codec.cu counts digit 1
# in its first pass and digits 2 and 3 together in its second
SELECT_DIGITS = ((19, 12), (9, 10), (0, 9))


def _pick_bin(hist: torch.Tensor, k: int):
    """The highest bin whose count with the bins above reaches k, and k
    less the count above it."""
    above = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    b = int(torch.nonzero(above >= k).max())
    return b, k - (int(above[b + 1]) if b + 1 < hist.numel() else 0)


def topk_threshold_radix(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest ``|a|`` (0-dim fp32) by the top-k kernel's radix
    select: the keys are the bit patterns of ``|a|``, which order like
    the values with NaN above +inf (as ``torch.topk`` and ``lax.top_k``
    order them); a histogram of each digit in turn (``SELECT_DIGITS``),
    over the keys whose higher digits are those already chosen, picks the
    next digit of the k-th largest key. Exact: bitwise
    ``lax.top_k(|a|, k)[0][-1]``."""
    keys = a.reshape(-1).float().contiguous().view(torch.int32) & 0x7FFFFFFF
    if keys.numel() == 0:
        raise ValueError("top-k of an empty tensor")
    k = max(1, min(int(k), keys.numel()))
    t, inside = 0, None
    for shift, bits in SELECT_DIGITS:
        digit = (keys >> shift) & ((1 << bits) - 1)
        hist = torch.bincount((digit if inside is None else digit[inside])
                              .long(), minlength=1 << bits)
        b, k = _pick_bin(hist, k)
        t |= b << shift
        inside = digit == b if inside is None else inside & (digit == b)
    return torch.tensor(t, dtype=torch.int32,
                        device=a.device).view(torch.float32)


def ef_topk_int8_roundtrip_ref(residual, x, k: int):
    """Top-k + int8 EF round-trip with one shared residual. Selection is
    by magnitude threshold (the k-th largest ``|x + residual|``, by
    :func:`topk_threshold_radix`), so ties at the threshold are all kept.
    A NaN anywhere makes the threshold NaN, so nothing is kept (what
    ``topk_threshold`` gives)."""
    xc = x.reshape(-1).float() + residual.reshape(-1)
    k = max(1, min(int(k), xc.shape[0]))
    mag = torch.abs(xc)
    t = topk_threshold_radix(mag, k)
    t = torch.where(torch.isnan(mag).any(), torch.nan, t)
    kept = mag >= t
    zero = torch.zeros((), dtype=torch.float32, device=xc.device)
    amax = torch.max(torch.where(kept, mag, zero))
    scale = torch.clamp(amax, min=1e-30) / QMAX
    q = torch.clamp(torch.round(torch.where(kept, xc, zero) / scale),
                    -QMAX, QMAX)
    dec = torch.where(kept, q * scale, zero)
    shape = x.shape
    return dec.reshape(shape).to(x.dtype), (xc - dec).reshape(shape)


def attention_ref(q, k, v, *, causal: bool = True, scale_dim=None):
    """Materialized-softmax attention. q: (B,S,H,D); k,v: (B,T,KV,D)
    (GQA expanded here). Scores, softmax and the product in fp32, the
    result in q's dtype. The scores are divided by the square root of
    ``scale_dim`` (D by default; the original head dim of a call whose
    q, k, v were zero-padded to a wider one).

    The causal mask is the flash kernel's: ``kpos <= qpos`` with both
    counted from 0 (start-aligned). The JAX package's oracle
    (``repro/kernels/ref.py::attention_ref``) aligns the mask to the end
    (``tril(k=T-S)``) while its Pallas kernel aligns it to the start; the
    two agree only at S = T. This twin takes the kernel's semantics, so
    that the wrapper computes the same function on either device."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(
        D if scale_dim is None else scale_dim)
    if causal:
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s,
                        torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v.float())
    return o.to(q.dtype)


def rwkv6_wkv_ref(r, k, v, lw, u, h0):
    """Naive per-timestep RWKV6 WKV recurrence. r,k,v,lw: (B,S,H,hs);
    u: (H,hs); h0: (B,H,hs,hs). Returns (o, h_last) in fp32."""
    B, S, H, hs = r.shape
    rf, kf, vf = (t.float() for t in (r, k, v))
    w = torch.exp(lw.float())                    # decay in (0,1]
    uf = u.float()
    h = h0.float()
    outs = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], w[:, t]
        kv = torch.einsum("bhi,bhj->bhij", kt, vt)
        outs.append(torch.einsum("bhi,bhij->bhj", rt,
                                 h + uf[None, :, :, None] * kv))
        h = wt[..., None] * h + kv
    return torch.stack(outs, dim=1), h           # (B,S,H,hs), (B,H,hs,hs)


def _bf16_split(x):
    """x as hi + lo, both bf16 values (in fp32): the WKV kernel's split of
    an fp32 operand for the bf16 tensor cores."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm3(a, b, split: bool):
    """a @ b with both operands split: hi*hi + lo*hi + hi*lo."""
    if not split:
        return a @ b
    ah, al = _bf16_split(a)
    bh, bl = _bf16_split(b)
    return ah @ bh + al @ bh + ah @ bl


def _mm2(a, b, split: bool):
    """a @ b with a split and b (v, bf16 on the kernel's route) whole."""
    if not split:
        return a @ b
    ah, al = _bf16_split(a)
    return ah @ b + al @ b


def rwkv6_wkv_chunked_ref(r, k, v, lw, u, h0, chunk: int = 32, *,
                          operand_split: bool = True):
    """The WKV tensor-core kernel's decomposition (``csrc/rwkv6_wkv.cu``,
    ``wkv_chunk_mma``), model layout like :func:`rwkv6_wkv_ref`, fp32.

    The sequence is padded to a multiple of ``chunk`` (16 or 32) with
    r = k = v = 0 and lw = 0. Each chunk is cut into sub-chunks of 16
    steps; every decay is a running product of w = exp(lw), multiplied
    in the kernel's order: per quarter of 8 steps, started from the
    products of the quarters and sub-chunk around it, for exp(L_excl)
    and exp(L_end - L) (the state) and the off-diagonal block's factors
    r[t] exp(L_excl[t] - L[15]) and k[s] exp(L[15] - L[s]); the diagonal
    blocks' r[t] exp(L_excl[t] - L[s]) walked from s = t - 1 down. The bonus is
    the scores' diagonal. Products take the kernel's operand split
    (``operand_split``: fp32 operands as bf16 hi + lo, three passes, two
    where one side is v). Returns (o (B,S,H,hs), h_last (B,H,hs,hs)) in
    fp32."""
    if chunk not in (16, 32):
        raise ValueError(f"rwkv6_wkv_chunked_ref: chunk {chunk} not in "
                         "(16, 32)")
    B, S, H, hs = r.shape
    nsub, Sp = chunk // 16, -(-S // chunk) * chunk

    def heads(t, fill):
        t = t.float().transpose(1, 2)                   # (B, H, S, hs)
        pad = torch.full((B, H, Sp - S, hs), fill, dtype=torch.float32,
                         device=t.device)
        return torch.cat([t, pad], dim=2)
    rf, kf, vf = heads(r, 0.0), heads(k, 0.0), heads(v, 0.0)
    wf = torch.exp(heads(lw, 0.0))
    uf = u.float()
    h = h0.float().clone()                              # (B, H, hs, hs)
    o = torch.zeros((B, H, Sp, hs), dtype=torch.float32, device=r.device)
    ones = torch.ones((B, H, 1, hs), dtype=torch.float32, device=r.device)
    nq = chunk // 8
    for c0 in range(0, Sp, chunk):
        rc, kc, vc, wc = (t[:, :, c0:c0 + chunk] for t in (rf, kf, vf, wf))
        # products of w over quarters of 8 steps, each in step order
        Q = []
        for q in range(nq):
            p_ = ones[:, :, 0]
            for t in range(8):
                p_ = p_ * wc[:, :, 8 * q + t]
            Q.append(p_)
        W = [Q[2 * g] * Q[2 * g + 1] for g in range(nsub)]
        ex, kd, rhat, khat = [], [], [], []
        for q in range(nq):
            g, half = q // 2, q % 2
            qo = Q[q ^ 1]
            wo = W[1 - g] if nsub == 2 else ones[:, :, 0]
            # exp(L_excl[t] - L[16 g - 1]) walked up from the quarter before
            loc = qo if half else ones[:, :, 0]
            before = wo if g == 1 else ones[:, :, 0]
            for t in range(8):
                row = 8 * q + t
                ex.append(rc[:, :, row] * before * loc)
                if nsub == 2 and g == 1:
                    rhat.append(rc[:, :, row] * loc)
                loc = loc * wc[:, :, row]
            # exp(L[16 g + 15] - L[s]) walked down from the quarter after
            suf = ones[:, :, 0] if half else qo
            after = wo if (nsub == 2 and g == 0) else ones[:, :, 0]
            kq, hq = [], []
            for t in range(7, -1, -1):
                row = 8 * q + t
                kq.append(kc[:, :, row] * suf * after)
                if nsub == 2 and g == 0:
                    hq.append(kc[:, :, row] * suf)
                suf = suf * wc[:, :, row]
            kd += kq[::-1]
            khat += hq[::-1]
        rt = torch.stack(ex, dim=2)                     # r * exp(L_excl)
        kt = torch.stack(kd, dim=2)                     # k * exp(L_end - L)
        dec = W[0] * W[1] if nsub == 2 else W[0]        # exp(L_end)

        sc = torch.zeros((B, H, chunk, chunk), dtype=torch.float32,
                         device=r.device)
        for g in range(nsub):
            b0 = 16 * g
            rb, kb, wb = (t[:, :, b0:b0 + 16] for t in (rc, kc, wc))
            rd = rb[:, :, 1:]                           # r[t], t >= 1
            for off in range(1, 16):
                # rd = r[t] exp(L_excl[t] - L[t - off]), walked from s = t - 1
                if off > 1:
                    rd = rd[:, :, 1:] * wb[:, :, 1:16 - off + 1]
                s_ = torch.sum(rd * kb[:, :, :16 - off], dim=-1)
                t_idx = torch.arange(off, 16) + b0
                sc[:, :, t_idx, t_idx - off] = s_
            diag = torch.arange(16) + b0
            sc[:, :, diag, diag] = torch.sum(rb * uf[None, :, None] * kb,
                                             dim=-1)
        if nsub == 2:
            # r exp(L_excl - L[15]) against k exp(L[15] - L)
            sc[:, :, 16:, :16] = _mm3(torch.stack(rhat, dim=2),
                                      torch.stack(khat, dim=2
                                                  ).transpose(-1, -2),
                                      operand_split)
        o[:, :, c0:c0 + chunk] = (_mm2(sc, vc, operand_split)
                                  + _mm3(rt, h, operand_split))
        h = dec[..., None] * h + _mm2(kt.transpose(-1, -2), vc,
                                      operand_split)
    return o[:, :, :S].transpose(1, 2), h


def mamba_scan_ref(dt, x, Bm, Cm, A, h0):
    """Naive per-timestep selective scan. dt,x: (B,S,dI); Bm,Cm: (B,S,N);
    A: (dI,N); h0: (B,dI,N). ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
    ``y_t = h_t C_t``. Returns (y (B,S,dI), h_last (B,dI,N)) in fp32."""
    dtf, xf, Bf, Cf = (t.float() for t in (dt, x, Bm, Cm))
    Af = A.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        a = torch.exp(dtf[:, t][:, :, None] * Af[None])
        b = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t][:, None, :]
        h = a * h + b
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


LOG2E = 1.4426950408889634
MAMBA_LANES = 4    # threads a channel in the lane-split Mamba kernel


def mamba_scan_lanes_ref(dt, x, Bm, Cm, A, h0):
    """The lane-split Mamba kernel's arithmetic (``csrc/mamba_scan.cu``,
    ``mamba_scan_lanes``), spelled out for the CPU tests: A scaled by
    log2(e) once, ``exp(dt A)`` as ``exp2(dt (A log2 e))``; each of a
    channel's ``MAMBA_LANES`` lanes holds N / 4 consecutive states and
    sums its ``h C`` terms in state order, and the four partial sums are
    combined as the two xor shuffles do: ``(p0 + p1) + (p2 + p3)``.
    Same shapes and returns as :func:`mamba_scan_ref`."""
    dtf, xf, Bf, Cf = (t.float() for t in (dt, x, Bm, Cm))
    A2 = A.float() * torch.tensor(LOG2E, dtype=torch.float32)
    h = h0.float().clone()
    B, S, dI = dt.shape
    N = Bm.shape[-1]
    per = N // MAMBA_LANES
    ys = []
    for t in range(S):
        d = dtf[:, t]
        dx = d * xf[:, t]
        e = torch.exp2(d[:, :, None] * A2[None])
        h = e * h + dx[:, :, None] * Bf[:, t][:, None, :]
        terms = (h * Cf[:, t][:, None, :]).reshape(B, dI, MAMBA_LANES, per)
        p = terms[..., 0]
        for i in range(1, per):
            p = p + terms[..., i]
        ys.append((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3]))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Count-Min and Misra-Gries: integer paths, bitwise
# ---------------------------------------------------------------------------

def cms_hash(ids: torch.Tensor, a, b, width: int) -> torch.Tensor:
    """The count-min hash with jnp's semantics (``kernels/countmin.py::
    hash_ids``): ``id * a + b`` wraps in int32, then ``% (2^31 - 1)`` and
    ``% width`` floor, so every slot lies in ``[0, width)`` (int64)."""
    a = torch.as_tensor(a, device=ids.device).to(torch.int64)
    b = torch.as_tensor(b, device=ids.device).to(torch.int64)
    h = _wrap_int32(ids.to(torch.int32).to(torch.int64) * a + b)
    return torch.remainder(torch.remainder(h, HASH_P), width)


def _seeds(seeds, device):
    return torch.as_tensor(seeds, device=device).to(torch.int64).reshape(-1, 2)


def countmin_ref(ids, depth: int, width: int, seeds) -> torch.Tensor:
    """Scatter-add oracle of the Count-Min increment: ids (n,) ->
    (depth, width) int32 counts."""
    sd = _seeds(seeds, ids.device)
    out = torch.zeros((depth, width), dtype=torch.int32, device=ids.device)
    for d in range(depth):
        h = cms_hash(ids, sd[d, 0], sd[d, 1], width)
        out[d] = torch.bincount(h, minlength=width).to(torch.int32)
    return out


def countmin_add_ref(ids, table, seeds) -> torch.Tensor:
    """``table +`` the increment of ``ids``, as a new int32 table."""
    depth, width = table.shape
    return table.to(torch.int32) + countmin_ref(ids, depth, width, seeds)


def countmin_update_query_ref(ids, table, seeds):
    """Fold the batch into the sketch, then estimate each id against the
    UPDATED table (min over depths): ``(new_table, est (n,))``, int32
    throughout, so exact at any count (the JAX package's fused kernel
    counts in fp32: ROADMAP fault 9)."""
    depth, width = table.shape
    sd = _seeds(seeds, ids.device)
    new_table = countmin_add_ref(ids, table, sd)
    ests = [new_table[d][cms_hash(ids, sd[d, 0], sd[d, 1], width)]
            for d in range(depth)]
    return new_table, torch.stack(ests).amin(0)


def mg_update_ref(keys, counts, ids):
    """Misra-Gries over ``ids`` in order, as ``streams/sketches.py::
    mg_update`` steps it: a hit (over all k slots, stale keys with count
    0 included; an id of -1 matches an empty slot) adds one to the first
    hit; otherwise the first slot whose count is 0 takes the id with
    count 1; otherwise every count drops by one. In both placing cases
    ``keys[slot] = id`` and ``counts[slot] += 1`` (an empty slot counts
    0), so each step is one select. Returns ``(keys, counts)`` int32."""
    keys = keys.to(torch.int32).clone()
    counts = counts.to(torch.int32).clone()
    slots = torch.arange(keys.shape[0], device=keys.device)
    for item in ids.to(device=keys.device, dtype=torch.int32):
        hit = keys == item
        empty = counts == 0
        has = hit.any()
        place = has | empty.any()
        slot = torch.where(has, hit.to(torch.uint8).argmax(),
                           empty.to(torch.uint8).argmax())
        sel = (slots == slot) & place
        keys = torch.where(sel, item, keys)
        counts = torch.where(place, counts + sel.to(torch.int32), counts - 1)
    return keys, counts


def _mg_classify(keys, counts, ids, thr: int):
    """The safe slots of a state for a stretch of ids (the first slot of
    its key whose count exceeds ``thr``), each one's hits in ``ids``, and
    the other ids in order: ``(safe (k,) bool, hits (k,), rest)``."""
    earlier = torch.tril(keys[:, None] == keys[None, :], diagonal=-1)
    safe = ~earlier.any(1) & (counts > thr)
    match = (ids[:, None] == keys[None, :]) & safe[None, :]
    hits = match.sum(0).to(torch.int32)
    return safe, hits, ids[~match.any(1)]


def mg_update_chunked_ref(keys, counts, ids, chunk: int, stats=None):
    """``mg_update_ref``'s result by the MG kernel's algorithm
    (``csrc/mg_scan.cu``), spelled out in torch.

    The ids go in chunks of ``chunk``. Chunk c + 1 is classified against
    the state at the start of chunk c (chunk 0 against the input), with
    the threshold the ids from that state to chunk c + 1's end: a slot
    that is the first holding its key K, with a count above it, cannot
    reach 0 before that end, so every K there is a hit on it and nothing
    else touches it. Those ids leave the chain. The rest are walked in
    order by the plain loop, in which the safe slots take part as any
    slot does (their keys are not among these ids and their counts stay
    above 0, so each takes exactly the walk's decrements); then each safe
    slot gains its hits. Bitwise equal to the plain loop. ``stats``, a
    dict if given, gains ``chained``: the ids walked."""
    keys = keys.to(torch.int32).clone()
    counts = counts.to(torch.int32).clone()
    ids = ids.to(device=keys.device, dtype=torch.int32).reshape(-1)
    chunks = torch.split(ids, chunk)
    chained = 0
    nxt = _mg_classify(keys, counts, chunks[0], len(chunks[0]))
    for c, cur in enumerate(chunks):
        safe, hits, rest = nxt
        if c + 1 < len(chunks):
            nxt = _mg_classify(keys, counts, chunks[c + 1],
                               len(cur) + len(chunks[c + 1]))
        keys, counts = mg_update_ref(keys, counts, rest)
        if bool((counts[safe] <= 0).any()):
            raise AssertionError("a safe slot reached 0 in its chunk")
        counts = counts + hits
        chained += len(rest)
    if stats is not None:
        stats["chained"] = stats.get("chained", 0) + chained
    return keys, counts


# ---------------------------------------------------------------------------
# DDM: the drift scan's decomposition, bitwise
# ---------------------------------------------------------------------------

def _first_min_scan(v, pm, sm, ok):
    """Inclusive prefix of "the later candidate wins only if it is valid
    and strictly smaller", as a log-step scan of that associative rule:
    ties keep the earlier pair. Returns ``(v, pm, sm, ok)`` per event."""
    n, d = v.shape[0], 1
    while d < n:
        a = (v[:-d], pm[:-d], sm[:-d], ok[:-d])
        b = (v[d:], pm[d:], sm[d:], ok[d:])
        right = b[3] & (~a[3] | (b[0] < a[0]))
        merged = [torch.where(right, y, x) for x, y in zip(a, b)]
        v, pm, sm, ok = (torch.cat([t[:d], m]) for t, m in
                         zip((v, pm, sm, ok), merged))
        d *= 2
    return v, pm, sm, ok


def ddm_scan_restart_ref(state, err, tile: int):
    """DDM over ``err`` by the drift-scan kernel's algorithm
    (``csrc/detector_scan.cu``), spelled out in torch: ``(final state,
    levels (n,) int32)``, bitwise ``run_detector(ddm_step, ...)``'s.

    Per tile: (1) the chain ``n += 1; p += (e - p) / n`` step by step in
    fp32, as if nothing reset; (2) per event ``s``, ``q = p + s`` and the
    running ``(p_min, s_min)``: the first-occurrence strict prefix minimum
    of ``q`` over events with ``n >= 30`` (and ``q`` not NaN), seeded by
    the carried pair; then each level as ``ddm_step`` computes it; (3) at
    the first event at DRIFT the state resets and the next tile starts
    right after it."""
    dev = err.device
    f32 = dict(dtype=torch.float32, device=dev)
    e = err.to(**f32).reshape(-1)
    n_, p_, smin_, pmin_ = (torch.as_tensor(t, **f32).reshape(())
                            for t in state[:4])
    level = torch.as_tensor(state.level, dtype=torch.int32, device=dev)
    levels = torch.zeros(e.shape[0], dtype=torch.int32, device=dev)
    base = 0
    while base < e.shape[0]:
        et = e[base:base + tile]
        m = et.shape[0]
        P = torch.empty(m, **f32)
        N = torch.empty(m, **f32)
        nn, pp = n_, p_
        for i in range(m):
            nn = nn + 1.0
            pp = pp + (et[i] - pp) / nn
            N[i], P[i] = nn, pp
        s = torch.sqrt(P * (1 - P) / torch.clamp(N, min=1.0))
        q = P + s
        ok = (N >= 30) & ~torch.isnan(q)
        seed = [t.reshape(1) for t in (pmin_ + smin_, pmin_, smin_)]
        v, pm, sm, _ = _first_min_scan(
            *(torch.cat([a, b]) for a, b in zip(seed, (q, P, s))),
            torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ok]))
        pm, sm = pm[1:], sm[1:]
        lv = torch.where(q > pm + 3.0 * sm, 2,
                         torch.where(q > pm + 2.0 * sm, 1, 0))
        lv = torch.where(N < 30, 0, lv).to(torch.int32)
        drift = torch.nonzero(lv == 2)
        r = int(drift[0, 0]) if len(drift) else m
        levels[base:base + min(r + 1, m)] = lv[:r + 1]
        if r < m:
            n_, p_ = torch.zeros((), **f32), torch.zeros((), **f32)
            smin_ = pmin_ = torch.full((), 1e9, **f32)
            level = lv[r]
            base += r + 1
        else:
            n_, p_, smin_, pmin_ = N[-1], P[-1], sm[-1], pm[-1]
            level = lv[-1]
            base += m
    return type(state)(n_, p_, smin_, pmin_, level), levels


# ---------------------------------------------------------------------------
# Page-Hinkley and EDDM on DDM's tiled chain, bitwise
# ---------------------------------------------------------------------------

def _counter(c0, count: int):
    """``c0`` after 1, ..., ``count`` steps of ``c + 1.0`` in fp32, as the
    kernels form it: ``c0 + (j + 1)`` where that is exact (``c0`` whole,
    non-negative and at most ``2^24 - count``), else step by step (past
    2^24 the step rounds back)."""
    c0 = c0.reshape(())
    whole = bool(c0 >= 0) and bool(c0 == torch.trunc(c0)) and \
        float(c0) <= 16777216.0 - count
    if whole:
        return c0 + torch.arange(1, count + 1, dtype=c0.dtype,
                                 device=c0.device)
    out = torch.empty(count, dtype=c0.dtype, device=c0.device)
    c = c0
    for j in range(count):
        c = c + 1.0
        out[j] = c
    return out


def _prefix_fold(seed, v, op):
    """``op(seed, v[0])``, ``op(op(seed, v[0]), v[1])``, ...: the inclusive
    prefix of an associative ``op`` (``torch.minimum``, ``torch.maximum``)
    as a log-step scan, each combine's earlier operand first."""
    v = torch.cat([seed.reshape(1), v])
    n, d = v.shape[0], 1
    while d < n:
        v = torch.cat([v[:d], op(v[:-d], v[d:])])
        d *= 2
    return v[1:]


def ph_scan_restart_ref(state, err, tile: int):
    """Page-Hinkley over ``err`` by the drift-scan kernel's algorithm
    (``csrc/detector_scan.cu`` ``ph_tiled_kernel``), spelled out in torch:
    ``(final state, levels (n,) int32)``, bitwise
    ``run_detector(ph_step, ...)``'s.

    Per tile: (1) ``n`` in closed form (:func:`_counter`); (2) the two
    chains step by step, as if nothing reset: ``mean += (x - mean) / n``
    and ``cum = cum + x - mean - 0.005``; (3) ``cum_min`` as a prefix
    minimum seeded by the carried one, each level ``cum - cum_min > 50``;
    (4) at the first event at DRIFT the state resets to zeros and the next
    tile starts right after it."""
    dev = err.device
    f32 = dict(dtype=torch.float32, device=dev)
    e = err.to(**f32).reshape(-1)
    n_, mean_, cum_, cmin_ = (torch.as_tensor(t, **f32).reshape(())
                              for t in state[:4])
    level = torch.as_tensor(state.level, dtype=torch.int32, device=dev)
    levels = torch.zeros(e.shape[0], dtype=torch.int32, device=dev)
    base = 0
    while base < e.shape[0]:
        et = e[base:base + tile]
        m = et.shape[0]
        N = _counter(n_, m)
        C = torch.empty(m, **f32)
        mm, cc = mean_, cum_
        for i in range(m):
            mm = mm + (et[i] - mm) / N[i]
            cc = cc + et[i] - mm - 0.005
            C[i] = cc
        cmin = _prefix_fold(cmin_, C, torch.minimum)
        lv = torch.where(C - cmin > 50.0, 2, 0).to(torch.int32)
        drift = torch.nonzero(lv == 2)
        r = int(drift[0, 0]) if len(drift) else m
        levels[base:base + min(r + 1, m)] = lv[:r + 1]
        if r < m:
            n_ = mean_ = cum_ = cmin_ = torch.zeros((), **f32)
            level = lv[r]
            base += r + 1
        else:
            n_, mean_, cum_, cmin_ = N[-1], mm, C[-1], cmin[-1]
            level = lv[-1]
            base += m
    return type(state)(n_, mean_, cum_, cmin_, level), levels


def eddm_scan_restart_ref(state, err, tile: int):
    """EDDM over ``err`` by the drift-scan kernel's algorithm
    (``csrc/detector_scan.cu`` ``eddm_tiled_kernel``), spelled out in
    torch: ``(final state, levels (n,) int32)``, bitwise
    ``run_detector(eddm_step, ...)``'s.

    An event with ``e <= 0.5`` only advances ``since_last`` and takes
    level 0, so per tile: (1) the errors' positions (the compaction);
    each one's ``since``, the difference of its position and the previous
    error's, the first's the carried ``since_last`` stepped to it
    (:func:`_counter`); ``n_err`` in closed form; (2) the chain over the
    errors only, step by step, as if nothing reset: ``delta = since -
    mean_d``, ``mean_d += delta / n``, ``var_d += delta * (since -
    mean_d)``; (3) ``sd``, ``metric`` and ``best``, a prefix maximum
    seeded by the carried one, the ratio and each error's level (0 while
    ``n < 50``); (4) at the first error at DRIFT the state resets and the
    next tile starts right after it. A tile with no error leaves all but
    ``since_last`` (carried plus the tile's events) as it was."""
    dev = err.device
    f32 = dict(dtype=torch.float32, device=dev)
    e = err.to(**f32).reshape(-1)
    n_, since_, mean_, var_, best_ = (torch.as_tensor(t, **f32).reshape(())
                                      for t in state[:5])
    level = torch.as_tensor(state.level, dtype=torch.int32, device=dev)
    levels = torch.zeros(e.shape[0], dtype=torch.int32, device=dev)
    base = 0
    while base < e.shape[0]:
        et = e[base:base + tile]
        m = et.shape[0]
        pos = torch.nonzero(et > 0.5).reshape(-1)
        k = pos.shape[0]
        if k == 0:
            since_ = _counter(since_, m)[-1]
            level = torch.zeros((), dtype=torch.int32, device=dev)
            base += m
            continue
        S = torch.cat([_counter(since_, int(pos[0]) + 1)[-1:],
                       torch.diff(pos).to(**f32)])
        N = _counter(n_, k)
        MEAN = torch.empty(k, **f32)
        VAR = torch.empty(k, **f32)
        mm, vv = mean_, var_
        for j in range(k):
            delta = S[j] - mm
            mm = mm + delta / N[j]
            vv = vv + delta * (S[j] - mm)
            MEAN[j], VAR[j] = mm, vv
        sd = torch.sqrt(VAR / torch.clamp(N, min=1.0))
        metric = MEAN + 2 * sd
        best = _prefix_fold(best_, metric, torch.maximum)
        ratio = metric / torch.clamp(best, min=1e-9)
        lvk = torch.where(ratio < 0.85, 2, torch.where(ratio < 0.92, 1, 0))
        lvk = torch.where(N < 50, 0, lvk).to(torch.int32)
        lv = torch.zeros(m, dtype=torch.int32, device=dev)
        lv[pos] = lvk
        drift = torch.nonzero(lvk == 2)
        r = int(pos[drift[0, 0]]) if len(drift) else m
        levels[base:base + min(r + 1, m)] = lv[:r + 1]
        if r < m:
            n_ = since_ = mean_ = var_ = torch.zeros((), **f32)
            best_ = torch.full((), -1e9, **f32)
            level = lv[r]
            base += r + 1
        else:
            n_, mean_, var_, best_ = N[-1], MEAN[-1], VAR[-1], best[-1]
            since_ = torch.tensor(float(m - 1 - int(pos[-1])), **f32)
            level = lv[-1]
            base += m
    return type(state)(n_, since_, mean_, var_, best_, level), levels


# ---------------------------------------------------------------------------
# ADWIN: the drift scan's decomposition (closed-form layout, prefix sums,
# first cut, rebase), bitwise on 0/1 errors
# ---------------------------------------------------------------------------

ADWIN_LEVELS, ADWIN_M, ADWIN_HALF = 12, 5, 6


def adwin_layout(nb, k):
    """The buckets a level after ``k`` inserts from ``nb`` used a level
    (levels 0..11), in closed form: level l with ``d = 5 - nb[l]`` free
    slots and ``a`` arrivals (``a = k`` at level 0) holds ``nb[l] + a``
    and sends nothing up where ``a <= d``; else it sends ``(a - d + 1) // 2``
    merged buckets up and holds 5 if ``a - d`` is even, 4 if odd. What
    level 11 sends leaves the window. ``nb`` (12,) and ``k`` (m,) integer
    tensors; returns (m, 12) int64."""
    nb = torch.as_tensor(nb).to(torch.int64).reshape(-1)
    a = torch.as_tensor(k).to(torch.int64).reshape(-1)
    cnt = []
    for level in range(ADWIN_LEVELS):
        d = ADWIN_M - nb[level]
        fits = a <= d
        over = a - d
        cnt.append(torch.where(fits, nb[level] + a, ADWIN_M - over % 2))
        a = torch.where(fits, 0, (over + 1) // 2)
    return torch.stack(cnt, dim=-1)


def _adwin_flat_weights(cnt):
    """Each of the 60 flat buckets' weight (levels 11..0, slots 0..4,
    oldest first): 2^l in a used slot of level l, 0 in an empty one.
    ``cnt`` (m, 12) -> (m, 60) int64."""
    levels = torch.arange(ADWIN_LEVELS - 1, -1, -1, device=cnt.device)
    slots = torch.arange(ADWIN_M, device=cnt.device)
    used = slots[None, None, :] < cnt[:, levels, None]
    return torch.where(used, (2 ** levels)[None, :, None], 0).reshape(
        cnt.shape[0], -1)


def _adwin_tree_sum(sums, weights):
    """One bucket's sum in the order the merges formed it: leaves (oldest
    first, weights non-increasing powers of two summing to a power of
    two) joined pairwise, older + newer, from the lightest up. fp32."""
    while sums.shape[0] > 1:
        w = int(weights[-1])
        run = int((weights == w).sum())
        head = sums.shape[0] - run
        pair = sums[head:].reshape(-1, 2)
        sums = torch.cat([sums[:head], pair[:, 0] + pair[:, 1]])
        weights = torch.cat([weights[:head],
                             torch.full((run // 2,), 2 * w,
                                        dtype=weights.dtype,
                                        device=weights.device)])
    return sums[0]


def adwin_scan_restart_ref(state, err, window: int, stats=None):
    """ADWIN over ``err`` by the drift-scan kernel's algorithm
    (``csrc/detector_scan.cu``, ``adwin_scan_kernel``), spelled out in
    torch: ``(final state, levels (n,) int32)``, bitwise
    ``run_detector(adwin_step, ...)``'s on 0/1 errors.

    Every bucket is a contiguous run of one stream: the carried buckets
    (levels 11..0, slots 0..4; level l weighs 2^l, as every state
    ``adwin_step`` builds from ``adwin_init`` does) then the batch's
    events. Merges join neighbours and the overflow and a drift's drop
    take the oldest, so the window is the stream's last W weight, W
    following from the closed-form layout (:func:`adwin_layout`) of the
    base (the carried ``n_buckets``, or the layout after the last drop)
    and the inserts since. Each cut point's ``(n0, s0)`` is then a
    difference of fp64 prefix sums over that stream, rounded to fp32
    (whole numbers below 2^24 on 0/1 errors: exactly the plain loop's
    cumsum), and tested as ``adwin_step`` tests it. Rounds test
    ``window`` events at once from the base. A cut drops levels 6..11;
    where the layout there holds no bucket at those levels the drop
    changes nothing, so the events after it keep their base and their
    tests (a drift lasts many events, and these are most of them). At
    the first cut whose drop removes a bucket, its layout less levels
    6..11 is the new base, and the events after it are tested again.
    The final buckets' sums are rebuilt in the merges' order
    (:func:`_adwin_tree_sum`), so the state is the plain loop's wherever
    the levels are. ``stats``, if given, is a list ``[rounds, events at
    DRIFT, rebases]`` added to. Errors are finite.
    """
    dev = err.device
    f32 = dict(dtype=torch.float32, device=dev)
    e = err.to(**f32).reshape(-1)
    n = e.shape[0]
    levels_out = torch.zeros(n, dtype=torch.int32, device=dev)
    nb0 = torch.as_tensor(state.n_buckets).to(device=dev,
                                                dtype=torch.int64)
    sums = torch.as_tensor(state.sums).to(**f32)
    # the carried buckets, oldest first: weights, sums, start positions
    cw = _adwin_flat_weights(nb0[None])[0]
    used = cw > 0
    c_w = cw[used]
    c_s = sums.flip(0).reshape(-1)[used]
    c_pos = torch.cumsum(c_w, 0) - c_w
    Wc = int(c_w.sum())
    # P[pos]: the stream's fp64 prefix sum before weight position pos
    # (a carried bucket's positions share its start's prefix)
    c_pre = torch.cumsum(c_s.double(), 0) - c_s.double()
    S_c = c_s.double().sum()
    P = torch.cat([torch.repeat_interleave(c_pre, c_w),
                   S_c + torch.cat([torch.zeros(1, dtype=torch.float64,
                                                device=dev),
                                    torch.cumsum(e.double(), 0)])])
    sizes = 2 ** torch.arange(ADWIN_LEVELS, device=dev)
    nb, base, t0, rounds, rebases = nb0, 0, 0, 0, 0
    while t0 < n:
        t = torch.arange(t0, min(t0 + window, n), device=dev)
        cnt = adwin_layout(nb, t - base + 1)
        W = (cnt * sizes).sum(-1)
        E = Wc + t + 1
        start = E - W
        n0i = torch.cumsum(_adwin_flat_weights(cnt), -1)
        s0 = (P[start[:, None] + n0i] - P[start][:, None]).float()
        total_s = (P[E] - P[start]).float()[:, None]
        total_n = W.float()[:, None]
        n0 = n0i.float()
        # adwin_step's test, operation for operation
        n1, s1 = total_n - n0, total_s - s0
        valid = (n0 >= 1) & (n1 >= 1)
        m0 = s0 / torch.clamp(n0, min=1.0)
        m1 = s1 / torch.clamp(n1, min=1.0)
        m = 1.0 / (1.0 / torch.clamp(n0, min=1.0)
                   + 1.0 / torch.clamp(n1, min=1.0))
        dp = torch.log(2.0 * torch.log(torch.clamp(total_n, min=2.0))
                       / 0.002)
        eps = torch.sqrt(dp / (2.0 * torch.clamp(m, min=1e-9)))
        cut = (valid & (torch.abs(m0 - m1) > eps)).any(-1)
        rounds += 1
        hit = torch.nonzero(cut & (cnt[:, ADWIN_HALF:] > 0).any(-1))
        r = int(hit[0, 0]) if len(hit) else t.shape[0] - 1
        levels_out[t0:t0 + r + 1] = torch.where(cut[:r + 1], 2, 0)
        if len(hit):
            nb = cnt[r].clone()
            nb[ADWIN_HALF:] = 0
            rebases += 1
            base = t0 + r + 1
        t0 += r + 1
    # the final state: the layout after the last event, each bucket's sum
    # rebuilt from its leaves in the merges' order
    cnt = adwin_layout(nb, torch.tensor([n - base], device=dev))[0]
    fw = _adwin_flat_weights(cnt[None])[0]
    start = Wc + n - int(fw.sum())
    flat_c = torch.zeros(ADWIN_LEVELS * ADWIN_M, **f32)
    flat_s = torch.zeros(ADWIN_LEVELS * ADWIN_M, **f32)
    p = start
    for f in range(ADWIN_LEVELS * ADWIN_M):
        w = int(fw[f])
        if not w:
            continue
        inc = (c_pos >= p) & (c_pos < p + w)
        ev = e[max(p - Wc, 0):max(p + w - Wc, 0)]
        flat_c[f] = float(w)
        flat_s[f] = _adwin_tree_sum(
            torch.cat([c_s[inc], ev]),
            torch.cat([c_w[inc], torch.ones(ev.shape[0], dtype=torch.int64,
                                            device=dev)]))
        p += w
    counts_out = flat_c.reshape(ADWIN_LEVELS, ADWIN_M).flip(0)
    sums_out = flat_s.reshape(ADWIN_LEVELS, ADWIN_M).flip(0)
    if n == 0:
        level = torch.as_tensor(state.level).to(device=dev,
                                                dtype=torch.int32)
    else:
        level = levels_out[-1]
    if stats is not None:
        stats[0] += rounds
        stats[1] += int((levels_out == 2).sum())
        stats[2] += rebases
    return type(state)(counts_out, sums_out, cnt.to(torch.int32),
                       level.reshape(())), levels_out
