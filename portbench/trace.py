"""The traced run's device trace: ``torch.profiler`` over the measured
window, the card's activity only (tracing every host operation as well
would slow the host's launches, which pace the stream job), read from the
raw kineto events.

What is kept of the trace: every operation that ran on the card (kernel,
copy or set) with its interval, and the window's bounds, stamped by the
harness on the clock kineto's events carry (``time.time_ns``). An idle
gap of the card is named by the operation the card waited for (the next
one it ran), which says what the host was issuing. The profiler's own
bookkeeping events are left out, as ``torch.autograd.profiler_util``
leaves them out of its tables (the same filters as
``launch/profile_stream.py::_device_events`` of the port, copied here so
that the yardstick stays in the benchmark).
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

# device activity that is the profiler's own, never the program's
_PROFILER_OWN = ("[memory]", "Activity Buffer Request")


@contextlib.contextmanager
def traced(enabled: bool):
    """``torch.profiler`` over the block (the card's activity; the host's
    where there is no card); yields the profile, None when off."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        yield prof


@dataclass
class Trace:
    """Device operations ``(start_ns, end_ns, name, kind)`` with ``kind``
    one of ``kernel``, ``memcpy``, ``memset``, and the window's bounds."""
    window: Tuple[int, int]
    device_ops: List[Tuple[int, int, str, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card
        (the union of their intervals)."""
        return _union_ns(self.device_ops, self.window) / 1e9

    def seconds(self, keep: Callable[[str, str], bool]) -> float:
        """Summed device seconds of the operations ``keep(name, kind)``
        accepts (not a union: each operation's own time)."""
        return sum(e - s for s, e, n, k in self.device_ops if keep(n, k)) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """The card's idle intervals inside the window."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e, _, _ in sorted(self.device_ops):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time (summed by name),
        and the idle time summed by the operation the card waited for."""
        by_op: Dict[str, float] = {}
        for s, e, n, k in self.device_ops:
            key = _label((s, e, n, k))
            by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e9
        ops = sorted(self.device_ops)
        starts = [o[0] for o in ops]
        by_wait: Dict[str, float] = {}
        for a, b in self.idle_gaps():
            i = bisect.bisect_left(starts, b)
            name = "before " + (_label(ops[i]) if i < len(ops)
                                else "the window's end")
            by_wait[name] = by_wait.get(name, 0.0) + (b - a) / 1e9
        ops_top = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_wait.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops_top],
                "idle_gaps": [[n, t] for n, t in gaps]}


def idle_share(run):
    """The card's idle share of a traced run's window, in %: the time in
    which no kernel, copy or set ran on the card (the union of their
    intervals). None off the card or without a trace. Each system's
    ``device_idle_share.<system>`` metric reads it."""
    if not str(run.device).startswith("cuda"):
        return None
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _label(op) -> str:
    """An operation's name for the breakdown: a kernel's without its
    argument list, at most 120 characters; a copy's or set's whole."""
    _, _, name, kind = op
    if kind != "kernel":
        return name
    return name.replace("(anonymous namespace)::", "").split("(")[0][:120]


def _union_ns(ops, window) -> int:
    lo, hi = window
    total, at = 0, lo
    for s, e, _, _ in sorted(ops):
        s, e = max(s, lo, at), min(e, hi)
        if e > s:
            total += e - s
            at = e
    return total


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def read(prof, window_ns: Tuple[int, int]) -> Trace:
    """The :class:`Trace` of a finished profile over the window
    ``window_ns`` (``time.time_ns`` stamps)."""
    import torch
    from torch.autograd.profiler_util import _filter_name
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        # a host annotation's range on the card is no operation of it
        if name in _PROFILER_OWN or _filter_name(name) \
                or e.is_user_annotation() or getattr(
                    e, "is_hidden_event", lambda: False)():
            continue
        s, t = e.start_ns(), e.end_ns()
        if t > s:
            dev.append((s, t, name, _kind(name)))
    return Trace(tuple(window_ns), dev)
