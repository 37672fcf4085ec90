"""Arithmetic shared by the readers of the program's own spans.

The program opens its spans (`rechorus_tpu_torch/utils/spans.py` lists
them) as torch.profiler ranges while a profiler runs, so in the traced
window they land in `Trace.ranges` beside the benchmark's ranges, on the
device ops' clock. A device op belongs to a span when its launch (the
host's runtime call, matched through its correlation id) falls inside a
range of that name. Every reader returns None when its span is absent
(a program without the span) or the trace holds no device op.
"""
from __future__ import annotations

import bisect

from benchmark import readers


def _ranges(trace, name: str) -> list:
    """[(start, end)] of the ranges named `name`, by start."""
    return sorted((ts, ts + dur) for n, ts, dur in trace.ranges if n == name)


def _open_at(trace, name: str):
    """`at(t)`: whether a range named `name` is open at host time t (the
    program's ranges of one name never nest)."""
    spans = _ranges(trace, name)
    starts = [s for s, _ in spans]

    def at(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]
    return at


def device_us_under(trace, name: str, match=None) -> float:
    """Device time of the ops whose name `match` accepts (all when None)
    launched while a range named `name` was open."""
    at = _open_at(trace, name)
    total = 0.0
    for op, _, dur, corr in trace.device:
        t = trace.launch_ts.get(corr)
        if t is not None and (match is None or match(op)) and at(t):
            total += dur
    return total


def present(run, *names: str) -> bool:
    """The window has device ops and opened every one of `names`."""
    return readers.has_device(run) and all(run.trace.range_count(n) for n in names)


def ms_per_unit_under(run, *names: str, less: str | None = None):
    """Device ms per unit (batch or step) of the ops launched under any of
    `names`, less those of the kernel named `less`."""
    if not present(run, *names):
        return None
    us = sum(device_us_under(run.trace, n) for n in names)
    if less is not None:
        us -= sum(device_us_under(run.trace, n, lambda op: less in op) for n in names)
    return us / 1e3 / run.units


def _busy_intervals(trace) -> list:
    """The union of the device ops' intervals as [(start, end)], by start."""
    out = []
    for _, ts, dur, _ in trace.device:
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return out


def idle_ms_per_unit_within(run, name: str):
    """ms per unit of the time in which a range named `name` was open on
    the host and no device op ran."""
    if not present(run, name):
        return None
    busy = _busy_intervals(run.trace)
    ends = [e for _, e in busy]
    idle = 0.0
    for lo, hi in _ranges(run.trace, name):
        covered = 0.0
        i = bisect.bisect_right(ends, lo)        # the first interval ending after lo
        while i < len(busy) and busy[i][0] < hi:
            covered += min(hi, busy[i][1]) - max(lo, busy[i][0])
            i += 1
        idle += (hi - lo) - covered
    return idle / 1e3 / run.units


def host_ops_per_range(run, name: str, op: str):
    """Host operator calls named `op` that start inside a range named
    `name`, per such range."""
    n = run.trace.range_count(name)
    if not n:
        return None
    at = _open_at(run.trace, name)
    return sum(1 for o, ts, _ in run.trace.host_ops if o == op and at(ts)) / n
