"""The traced window: torch.profiler over a fixed piece of work, reduced to
the records the per-layer readers need.

`capture(fn)` runs `fn` under torch.profiler (CPU and, on a card, CUDA
activities), exports the Chrome trace into a temporary directory under
TMPDIR, reads it back and deletes it. `Trace` keeps, from that file:

- device ops: kernels, memory copies and memsets (name, start, length,
  correlation id), on the device's clock;
- launches: the host time of the runtime call behind each correlation id;
- ranges: the `record_function` ranges the benchmark opened (the host's
  `user_annotation` events);
- host ops: every `cpu_op` event (start, length, name).

Times are microseconds on the trace's common clock.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Trace:
    device: list = field(default_factory=list)     # (name, ts, dur, correlation)
    launch_ts: dict = field(default_factory=dict)  # correlation -> host ts
    ranges: list = field(default_factory=list)     # (name, ts, dur)
    host_ops: list = field(default_factory=list)   # (name, ts, dur)

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        t = cls()
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                t.device.append((e.get("name", ""), ts, dur, args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if args.get("correlation") is not None:
                    t.launch_ts[args["correlation"]] = ts
            elif cat == "user_annotation":
                t.ranges.append((e.get("name", ""), ts, dur))
            elif cat == "cpu_op":
                t.host_ops.append((e.get("name", ""), ts, dur))
        t.device.sort(key=lambda r: r[1])
        t.host_ops.sort(key=lambda r: r[1])
        return t

    # ---- device time
    def device_us(self, match=None) -> float:
        """Summed length of the device ops whose name `match` accepts (all
        when None)."""
        return sum(d for n, _, d, _ in self.device if match is None or match(n))

    def launches(self, match) -> list:
        """Lengths (us) of the device ops whose name `match` accepts."""
        return [d for n, _, d, _ in self.device if match(n)]

    def busy_us(self) -> float:
        """Length of the union of the device ops' intervals."""
        busy, end = 0.0, float("-inf")
        for _, ts, dur, _ in self.device:
            if ts + dur <= end:
                continue
            busy += ts + dur - max(ts, end)
            end = ts + dur
        return busy

    def device_us_under(self, range_name: str) -> float:
        """Device time of the ops launched while a range of that name was
        open on the host (matched through the launch's correlation id)."""
        spans = sorted((ts, ts + dur) for n, ts, dur in self.ranges if n == range_name)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, _, dur, corr in self.device:
            at = self.launch_ts.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += dur
        return total

    def range_count(self, range_name: str) -> int:
        return sum(1 for n, _, _ in self.ranges if n == range_name)

    def host_ops_under(self, range_name: str) -> int:
        """Host operator calls that start inside a range of that name."""
        spans = sorted((ts, ts + dur) for n, ts, dur in self.ranges if n == range_name)
        starts = [s for s, _ in spans]
        count = 0
        for _, ts, _ in self.host_ops:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                count += 1
        return count

    # ---- breakdown
    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device ops that took most time in all."""
        per = {}
        for name, _, dur, _ in self.device:
            per[name] = per.get(name, 0.0) + dur
        return [[k[:200], v / 1e6] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]]: the gaps between device
        ops, each named by the innermost host op, else the innermost
        benchmark range, open at its middle, and summed by that name; the
        longest n."""
        gaps, end = [], None
        for _, ts, dur, _ in self.device:
            if end is not None and ts > end:
                gaps.append((end, ts))
            end = ts + dur if end is None else max(end, ts + dur)
        per = {}
        ranges = sorted(self.ranges, key=lambda r: r[1])
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            name = _innermost(self.host_ops, mid) or _innermost(ranges, mid) or "host, no op open"
            per[name] = per.get(name, 0.0) + (hi - lo)
        return [[k[:200], v / 1e6] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(spans: list, t: float, look_back: int = 256):
    """The name of the latest-starting span open at `t` among the
    `look_back` spans that start last before it; `spans` sorted by start.
    The latest-starting open span is the innermost of nested ones."""
    i = bisect.bisect_right(spans, t, key=lambda r: r[1])
    for name, ts, dur in reversed(spans[max(0, i - look_back): i]):
        if ts + dur >= t:
            return name
    return None


def capture(fn) -> tuple[Trace, float, object]:
    """(trace, window seconds on the host clock, fn's result) of `fn()`
    under torch.profiler; the window ends in a device synchronise."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        result = fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return Trace.from_events(events), window_s, result
