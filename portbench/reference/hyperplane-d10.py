"""The plain reference of the S2CE standard chain on one stream batch:
normalize -> sketch -> sample -> online logistic regression (test, then
train) -> the uplink's int8 error-feedback round-trip at the plan's cut
-> DDM over the decoded error stream -> the drift response.

Written from the semantics the configuration states, in plain PyTorch
(fp32, no TF32) and NumPy: the Welford merge of a batch into running
moments; Algorithm R over the batch with counter-based draws
(splitmix64 of the reservoir's seed and the item's index) and Bernoulli
thinning from the per-step seed; prequential (test-then-train) metrics;
one AdaGrad step on the kept rows; per-tensor symmetric int8 with the
carried residual folded in; DDM (Gama et al., 2004) event by event in
float32, reset after a drift. Nothing of the program is imported or
called: its state comes in as a flat dict of tensors (``init_state``'s
names) and the comparison reads the program's state the same way.

``precision="tf32"`` rounds the batch entering the chain and the
learner's matrix-product operands to TF32 (10 explicit mantissa bits, to
nearest even): the control, the step below the float32 (TF32 off) the
configuration states.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

MASK63 = (1 << 63) - 1
_M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB


def splitmix(seed: int, counter: int) -> int:
    """splitmix64's finalizer of ``seed * golden + counter + 1`` (host)."""
    z = (int(seed) * GOLDEN + int(counter) + 1) & _M64
    z = ((z ^ (z >> 30)) * MIX1) & _M64
    z = ((z ^ (z >> 27)) * MIX2) & _M64
    return z ^ (z >> 31)


def step_seed(root: int, step: int) -> int:
    """The per-batch seed of batch ``step`` under the job's root seed."""
    return splitmix(root, step) & MASK63


def splitmix_np(seed: int, counters: np.ndarray) -> np.ndarray:
    """:func:`splitmix` over a vector of counters, in wrapping uint64."""
    with np.errstate(over="ignore"):
        z = (np.uint64(int(seed) & _M64) * np.uint64(GOLDEN)
             + counters.astype(np.uint64) + np.uint64(1))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(MIX2)
        return z ^ (z >> np.uint64(31))


def init_state(cfg: dict, device) -> Dict[str, torch.Tensor]:
    d = cfg["num_features"]
    k = cfg["pipeline"]["reservoir_k"]
    f = dict(dtype=torch.float32, device=device)
    z = lambda *s: torch.zeros(s, **f)  # noqa: E731
    return {
        "norm.n": z(), "norm.mean": z(d), "norm.m2": z(d),
        "sketch.n": z(), "sketch.mean": z(d), "sketch.m2": z(d),
        "sketch.min": torch.full((d,), float("inf"), **f),
        "sketch.max": torch.full((d,), float("-inf"), **f),
        "sample.buf": z(k, d),
        "sample.labels": torch.zeros(k, dtype=torch.int32, device=device),
        "sample.seen": torch.zeros((), dtype=torch.int32, device=device),
        "sample.seed": torch.zeros((), dtype=torch.int64, device=device),
        "learner.w": z(d), "learner.b": z(), "learner.g2":
            torch.full((d,), 1e-8, **f), "learner.n": z(),
        "preq.n": z(), "preq.correct": z(), "preq.loss_sum": z(),
        "preq.ewma": torch.full((), 0.5, **f),
        "ddm.n": z(), "ddm.p": z(), "ddm.s_min": torch.full((), 1e9, **f),
        "ddm.p_min": torch.full((), 1e9, **f),
        "ddm.level": torch.zeros((), dtype=torch.int32, device=device),
    }


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (to nearest, ties to even; 13 bits dropped)."""
    b = t.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _mm(a, b, precision):
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def _merge(n0, mean0, m20, x):
    """Welford: the batch ``x`` (n, d) merged into running moments."""
    nb = x.shape[0]
    mean_b = x.mean(0)
    m2_b = torch.square(x - mean_b).sum(0)
    n = n0 + nb
    delta = mean_b - mean0
    mean = mean0 + delta * (nb / torch.clamp(n, min=1.0))
    m2 = m20 + m2_b + torch.square(delta) * n0 * nb / torch.clamp(n, min=1.0)
    return n, mean, m2


def _reservoir(state, x, y, k):
    """Algorithm R over the batch in order: item i is the (seen + i + 1)-th
    item seen, draws j uniform in [0, that count) from splitmix64 of the
    reservoir's seed and i, fills slot (count - 1) while the reservoir
    fills and slot j when j < k after; each slot keeps the last item that
    took it. The seed then advances (splitmix64 at counter -2)."""
    n = x.shape[0]
    seed = int(state["sample.seed"])
    seen0 = int(state["sample.seen"])
    i = np.arange(n, dtype=np.int64)
    seen = seen0 + i + 1
    j = (splitmix_np(seed, i) & np.uint64(MASK63)).astype(np.int64) % seen
    take = (seen <= k) | (j < k)
    slot = np.where(seen <= k, seen - 1, j)
    last = np.full(k, -1, dtype=np.int64)
    np.maximum.at(last, slot[take], i[take])
    hit = torch.from_numpy(last >= 0).to(x.device)
    src = torch.from_numpy(np.maximum(last, 0)).to(x.device)
    buf = torch.where(hit[:, None], x[src], state["sample.buf"])
    labels = torch.where(hit, y[src].to(torch.int32), state["sample.labels"])
    return {"sample.buf": buf, "sample.labels": labels,
            "sample.seen": (state["sample.seen"] + n).to(torch.int32),
            "sample.seed": torch.tensor(splitmix(seed, -2) & MASK63,
                                        dtype=torch.int64, device=x.device)}


def _thin(seed: int, n: int, rate: float, device) -> torch.Tensor:
    """Bernoulli thinning: keep item i when the top 53 bits of
    splitmix64(seed, i) fall below rate * 2**53."""
    u = splitmix_np(seed, np.arange(n, dtype=np.int64)) >> np.uint64(11)
    keep = u < np.uint64(int(min(max(rate, 0.0), 1.0) * (1 << 53)))
    return torch.from_numpy(keep).to(device)


def _int8_ef(x, r, qmax: float):
    """Per-tensor symmetric int8 with error feedback: (decoded, residual).
    The scale is an IEEE division of the peak by ``qmax`` (a tensor
    divided by a Python number on the card is a multiply by its
    reciprocal, a bit off at times)."""
    xc = x.float() + r
    scale = torch.clamp(torch.max(torch.abs(xc)), min=1e-30) / torch.full(
        (), qmax, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xc / scale), -qmax, qmax)
    dec = q * scale
    return dec, xc - dec


def ddm(state: dict, err: np.ndarray, warn: float, drift: float,
        warmup: float) -> Tuple[dict, bool]:
    """DDM event by event in float32: the running error rate p, its
    deviation s, the minimum of p + s after warm-up, a warning at
    p + s > p_min + warn * s_min and a drift at ... + drift * s_min,
    after which the detector restarts."""
    f = np.float32
    n, p = f(float(state["ddm.n"])), f(float(state["ddm.p"]))
    s_min, p_min = f(float(state["ddm.s_min"])), f(float(state["ddm.p_min"]))
    level = int(state["ddm.level"])
    one, w_, d_, wu = f(1.0), f(warn), f(drift), f(warmup)
    drifted = False
    for e in err.astype(np.float32).tolist():
        n = n + one
        p = p + (f(e) - p) / n
        s = np.sqrt(p * (one - p) / max(n, one))
        ps = p + s
        if n >= wu and ps < p_min + s_min:
            p_min, s_min = p, s
        if n < wu:
            level = 0
        elif ps > p_min + d_ * s_min:
            level = 2
        elif ps > p_min + w_ * s_min:
            level = 1
        else:
            level = 0
        if level == 2:
            drifted = True
            n, p, s_min, p_min = f(0.0), f(0.0), f(1e9), f(1e9)
    return {"ddm.n": n, "ddm.p": p, "ddm.s_min": s_min, "ddm.p_min": p_min,
            "ddm.level": level}, drifted


def _normalize(st, env, pc, precision):
    """Merge the batch into the running moments, then standardize by them."""
    x = env["x"]
    n, mean, m2 = _merge(st["norm.n"], st["norm.mean"], st["norm.m2"], x)
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    st.update({"norm.n": n, "norm.mean": mean, "norm.m2": m2})
    env["x"] = (x - mean) * torch.rsqrt(var + 1e-6)


def _sketch(st, env, pc, precision):
    """Running moments and extremes of the stream (a sink)."""
    x = env["x"]
    n, mean, m2 = _merge(st["sketch.n"], st["sketch.mean"], st["sketch.m2"],
                         x)
    st.update({"sketch.n": n, "sketch.mean": mean, "sketch.m2": m2,
               "sketch.min": torch.minimum(st["sketch.min"], x.amin(0)),
               "sketch.max": torch.maximum(st["sketch.max"], x.amax(0))})


def _sample(st, env, pc, precision):
    """The reservoir, then the batch's Bernoulli keep mask."""
    st.update(_reservoir(st, env["x"], env["y"], pc["reservoir_k"]))
    env["mask"] = _thin(env["seed"], env["x"].shape[0], pc["sample_rate"],
                        env["x"].device)


def _learner(st, env, pc, precision):
    """Prequential: predict on every row and score it (test), then one
    AdaGrad step on the kept rows, the others zeroed in x and y (train).
    Writes the prediction ``p`` and the error stream ``err``."""
    x, y, mask = env["x"], env["y"], env["mask"]
    w, b = st["learner.w"], st["learner.b"]
    p = torch.sigmoid(_mm(x, w, precision) + b)
    yhat = (p > 0.5).to(torch.int32)
    acc = (yhat == y).float().mean()
    ll = -torch.mean(y * torch.log(p + 1e-9)
                     + (1 - y) * torch.log(1 - p + 1e-9))
    nb = p.shape[0]
    decay = pc["fading"] ** nb
    st.update({"preq.n": st["preq.n"] + nb,
               "preq.correct": st["preq.correct"] + acc * nb,
               "preq.loss_sum": st["preq.loss_sum"] + ll * nb,
               "preq.ewma": decay * st["preq.ewma"] + (1 - decay) * acc})
    xm = x * mask.float()[:, None]
    ym = (y * mask).float()
    pm = torch.sigmoid(_mm(xm, w, precision) + b)
    e2 = pm - ym
    gw = _mm(xm.T, e2, precision) / nb + pc["l2"] * w
    g2 = st["learner.g2"] + torch.square(gw)
    st.update({"learner.w": w - pc["lr"] * gw * torch.rsqrt(g2),
               "learner.b": b - pc["lr"] * e2.mean(), "learner.g2": g2,
               "learner.n": st["learner.n"] + nb})
    env["p"] = p
    env["err"] = ((p > 0.5).to(y.dtype) != y).float()


def _drift(st, env, pc, precision):
    """DDM over the error stream as it arrives (decoded, past the cut)."""
    dd = pc["ddm"]
    new, env["drifted"] = ddm(st, env["err"].cpu().numpy(), dd["warn"],
                              dd["drift"], dd["warmup"])
    dev = env["err"].device
    for k, v in new.items():
        dt = torch.int32 if k == "ddm.level" else torch.float32
        st[k] = torch.tensor(v, dtype=dt, device=dev)


CHAIN = (_normalize, _sketch, _sample, _learner, _drift)


def batch_step(state: dict, x: torch.Tensor, y: torch.Tensor, seed: int,
               cfg: dict, precision: str = "fp32") -> Tuple[dict, bool]:
    """One batch through the chain from ``state``: ``(next state, whether
    DDM saw a drift)``. ``x`` (n, d) fp32 and ``y`` (n,) int32 on the
    state's device; ``seed`` the batch's per-step seed. The plan's first
    ``cut`` ops run on the edge; where the batch enters the cloud every
    float channel round-trips the uplink codec with its own residual."""
    pc, plan = cfg["pipeline"], cfg["plan"]
    st = dict(state)
    env = {"x": _tf32(x) if precision == "tf32" else x, "y": y, "seed": seed}
    for i, op in enumerate(CHAIN):
        if i == plan["cut"]:
            crossing = [k for k, v in env.items() if isinstance(
                v, torch.Tensor) and v.is_floating_point()]
            if crossing != list(plan["crossing"]):
                raise ValueError(f"channels {crossing} cross at cut "
                                 f"{plan['cut']}, the plan says "
                                 f"{plan['crossing']}")
            for k in crossing:
                r = st.get(f"ef.{k}")
                if r is None or r.shape != env[k].shape:   # a fresh channel
                    r = torch.zeros(env[k].shape, dtype=torch.float32,
                                    device=env[k].device)
                env[k], st[f"ef.{k}"] = _int8_ef(env[k], r,
                                                 cfg["codec"]["qmax"])
        op(st, env, pc, precision)
    if env["drifted"]:
        keep = pc["drift_keep"]
        st.update({"learner.w": st["learner.w"] * keep,
                   "learner.b": st["learner.b"] * keep,
                   "learner.g2": torch.full_like(st["learner.g2"], 1e-8),
                   "learner.n": torch.zeros_like(st["learner.n"])})
    return st, env["drifted"]
