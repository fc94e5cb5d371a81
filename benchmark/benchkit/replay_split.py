"""A replayed call's device time split by the program's span that enqueued
each device operation, for the readers of ``graphs.glue_device_us`` and
``extract.elementwise_us``.

``utils/graphs.py`` replays a call in three host spans: ``graphs.fill``
(the caller's fill of the static input: the copy, the bucket tail's zeros),
``graphs.replay`` (the graph's launch) and ``graphs.copy_out`` (the
outputs' copies).  While ``torch.profiler`` runs, each span is a
``record_function`` scope of the trace.  Each device operation (kernel,
copy, fill) carries the ``correlation`` of the CUDA runtime call that
launched it, a replayed graph's kernels that of its ``cudaGraphLaunch``,
and goes under the span that held that call.

Once a ``--trace 1`` run, after the profiled slices: ``CALLS`` calls
through the cell's entry point on one batch of the cell's work shape (made
as :mod:`benchkit.spans` makes its own, from ``seed + 2``), under the
profiler with the host's operations recorded.  The numbers are kept on the
run's context.  None where the program records no such spans (a commit
before them, a path with no graph) or where the burst captured a graph."""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

from .trace import DEVICE_CATS

ATTR = "replay_split"  # the context's attribute that keeps the numbers
CALLS = 50
SPANS = ("graphs.fill", "graphs.replay", "graphs.copy_out")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def split(events: list, calls: int) -> dict | None:
    """{"us": {span: device µs a call of the operations it enqueued},
    "replay_ops": {operation name: device µs a call}} of a trace's events
    over ``calls`` calls; None where no span holds a device operation."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in SPANS)
    starts = [a for a, _, _ in spans]
    owner = {}  # correlation -> span name
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        if corr is not None and i >= 0 and ts <= spans[i][1]:
            owner[corr] = spans[i][2]
    us = dict.fromkeys(SPANS, 0.0)
    ops: dict = {}
    held = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        name = owner.get((e.get("args") or {}).get("correlation"))
        if name is None:
            continue
        held += 1
        d = float(e["dur"]) / calls
        us[name] += d
        if name == "graphs.replay":
            ops[e["name"]] = ops.get(e["name"], 0.0) + d
    return {"us": us, "replay_ops": ops} if held and calls else None


def _burst(ctx) -> dict | None:
    if ctx.device.type != "cuda":
        return None
    try:
        from mfcc_rust_tpu_torch.utils import graphs
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    t = ctx.traffic
    rows, samples = ctx.work_shape
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 2)
    x = torch.empty((rows, samples), device=ctx.device)
    x.normal_(0.0, float(t["std"]), generator=gen).clamp_(-float(t["clip"]), float(t["clip"]))
    call = ctx.entry()
    call(x)
    ctx.synchronize()
    captures = graphs.cache.captures
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            call(x)
        ctx.synchronize()
    del x
    if graphs.cache.captures != captures:
        return None
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return split(events, CALLS)


def numbers(ctx) -> dict | None:
    """:func:`split` of the burst, measured at the first call on this
    context."""
    if not hasattr(ctx, ATTR):
        setattr(ctx, ATTR, _burst(ctx))
    return getattr(ctx, ATTR)
