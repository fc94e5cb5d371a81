"""A short steady slice of a cell under ``torch.profiler``, read back from
its trace: the device's operations, their union (busy time), the
benchmark's own host spans, and the longest idle gaps labelled by what the
host was doing when each began."""

from __future__ import annotations

import collections
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
SLICE, CALL, PASS = "bench.slice", "bench.call", "bench.pass"


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """The events of one profiled slice (times in µs, as the trace has them).

    The slice runs from its ``bench.slice`` span (a trace with host
    operations) or its first CUDA runtime call (a trace of the device
    alone) to the end of its last device operation."""

    def __init__(self, events: list, calls: int = 0):
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in x if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"])
                     for e in x if e.get("cat") in HOST_CATS]
        slices = [(a, b) for n, a, b, c in self.host if n == SLICE and c == "user_annotation"]
        starts = [a for n, a, b, c in self.host if c == "cuda_runtime"] + \
            [a for _, a, _ in self.device]
        if not slices and not starts:
            raise ValueError("the trace holds neither the slice's span nor a CUDA event")
        start, end = slices[0] if slices else (min(starts), min(starts))
        if self.device:
            end = max(end, max(b for _, _, b in self.device))
        self.start, self.end = start, end
        self.calls = calls

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list:
        return _union((max(a, self.start), min(b, self.end)) for _, a, b in self.device
                      if b > self.start and a < self.end)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_s(self, *names: str) -> float:
        """Seconds of the device operations whose name holds any of
        ``names`` (all of them when none is given)."""
        return 1e-6 * sum(b - a for n, a, b in self.device
                          if not names or any(s in n for s in names))

    def count(self, *names: str) -> int:
        return sum(1 for n, _, _ in self.device if any(s in n for s in names))

    def _label(self, t: float) -> str:
        """The benchmark's innermost span open at ``t`` and the innermost
        torch operation or runtime call open then, or what ended last."""
        open_ = [(a, n, c) for n, a, b, c in self.host if a <= t < b]
        span = max((o for o in open_ if o[2] == "user_annotation"), default=None)
        op = max((o for o in open_ if o[2] != "user_annotation"), default=None)
        parts = [o[1] for o in (span, op) if o is not None]
        if not parts:
            last = max(((b, n) for n, a, b, c in self.host if b <= t), default=None)
            parts = [f"after {last[1]}" if last else "before any host event"]
        return " > ".join(parts)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing when each began (seconds)."""
        by_name = collections.Counter()
        for n, a, b in self.device:
            by_name[n] += (b - a) * 1e-6
        busy = self.busy_intervals()
        edges = [self.start] + [v for iv in busy for v in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[_short(n), s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[self._label(a), (b - a) * 1e-6] for a, b in gaps[:top]]}


def _short(name: str) -> str:
    """A device operation's name without its trailing argument list, at
    most 160 characters (template arguments make some thousands long)."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:160]


def profile(fn, host: bool = False) -> Trace:
    """Run ``fn`` (which returns its count of calls) under the profiler, the
    device drained before the slice ends; the trace, read back.  With
    ``host`` the profiler records the host's operations and the
    ``bench.slice`` span too, which slows the host; without it, the device's
    operations and the CUDA runtime's calls alone."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    with _profile(activities=acts) as prof:
        with record_function(SLICE):
            calls = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, calls or 0)
