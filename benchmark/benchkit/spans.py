"""The program's own spans over a burst of calls, for the readers of the
``api.*`` / ``graphs.*`` span metrics.

Once a ``--trace 1`` run, after the profiled slices: ``traffic["batches"]``
batches of the cell's work shape, made as ``drivers/device_loop.py`` makes
its own (N(0, ``std``) clipped to +-``clip``, on the device) from
``seed + 1``; then, inside the program's span recorder
(``mfcc_rust_tpu_torch.utils.profiling.spans``) and with no profiler
running, ``traffic["slice_calls"]`` calls through the cell's entry point in
the window's closed loop, no synchronise between them.  Where the host
blocks (for launch-queue space, a stream, the allocator), the wait lands in
the span in which it happens.

A span's self time is its duration less the part of it that its child
spans cover.  Per call, each span name's self time (summed where a call
holds the name twice); then the median over the calls, in µs.  The numbers
are kept on the run's context, the tensors dropped.  None where the program
records no spans (a commit before them) or where the burst captured a graph
or lost spans (its calls are then not the window's replays)."""

from __future__ import annotations

import statistics
import time

import torch

ATTR = "program_spans"  # the context's attribute that keeps the numbers


def _covered(t0: int, t1: int, children) -> int:
    """Nanoseconds of [t0, t1] inside the union of the children's
    intervals."""
    total, end = 0, t0
    for a, b in sorted((max(c.t0_ns, t0), min(c.t1_ns, t1)) for c in children):
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


def self_times(records) -> dict:
    """{call id: {span name: self ns}} of the calls whose spans all closed."""
    kids: dict = {}
    for r in records:
        if r.parent is not None:
            kids.setdefault(id(r.parent), []).append(r)
    out: dict = {}
    open_calls = {r.call for r in records if r.t1_ns is None}
    for r in records:
        if r.call in open_calls:
            continue
        own = r.t1_ns - r.t0_ns - _covered(r.t0_ns, r.t1_ns, kids.get(id(r), ()))
        names = out.setdefault(r.call, {})
        names[r.name] = names.get(r.name, 0) + own
    return out


def medians_us(records) -> dict:
    """{span name: median over the calls that hold it of its self µs}."""
    by_name: dict = {}
    for names in self_times(records).values():
        for name, ns in names.items():
            by_name.setdefault(name, []).append(ns)
    return {name: statistics.median(v) / 1e3 for name, v in by_name.items()}


def _burst(ctx) -> dict | None:
    try:
        from mfcc_rust_tpu_torch.utils import graphs
        from mfcc_rust_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    t = ctx.traffic
    rows, samples = ctx.work_shape
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    xs = torch.empty((int(t["batches"]), rows, samples), device=ctx.device)
    xs.normal_(0.0, float(t["std"]), generator=gen).clamp_(-float(t["clip"]), float(t["clip"]))
    batches = list(xs.unbind(0))
    calls = int(t["slice_calls"])
    call = ctx.entry()
    ctx.synchronize()
    captures = graphs.cache.captures
    t0 = time.perf_counter()
    with spans(limit=64 * calls) as rec:
        for i in range(calls):
            call(batches[i % len(batches)])
    ctx.synchronize()
    wall = time.perf_counter() - t0
    del xs, batches
    if graphs.cache.captures != captures or rec.dropped or not rec.records:
        return None
    return {"calls": calls, "wall_us": 1e6 * wall / calls, "self_us": medians_us(rec.records)}


def numbers(ctx) -> dict | None:
    """The burst's numbers, measured at the first call on this context:
    ``calls``, ``wall_us`` (the burst's wall a call, its last synchronise
    included) and ``self_us`` (:func:`medians_us`)."""
    if not hasattr(ctx, ATTR):
        setattr(ctx, ATTR, _burst(ctx))
    return getattr(ctx, ATTR)


def median_us(ctx, name: str) -> float | None:
    """The median self µs a call of the span ``name``; None where the burst
    gave nothing or no call held it."""
    n = numbers(ctx)
    return None if n is None else n["self_us"].get(name)
