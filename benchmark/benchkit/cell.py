"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result."""

from __future__ import annotations

import functools
import gc
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from . import card, compare, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "mfcc_rust_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    that the port must not load, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a driver and a metric's reader see of the run."""

    cell: spec.Cell
    seed: int
    device: torch.device
    config: dict = field(init=False)
    traffic: dict = field(init=False)
    window: dict = field(default_factory=dict)  # the driver's window record
    scopes: dict = field(default_factory=dict)  # the program's host scopes over the window
    trace: trace.Trace | None = None
    enqueue_us: float | None = None
    phases: dict = field(default_factory=dict)  # set-up seconds by phase
    since: float = field(default_factory=time.perf_counter)

    def __post_init__(self):
        self.config, self.traffic = self.cell.config, self.cell.traffic

    def mark(self, phase: str) -> None:
        """Record the seconds since the last mark as set-up phase ``phase``."""
        now = time.perf_counter()
        self.phases[phase] = now - self.since
        self.since = now

    def entry(self):
        """The configuration's ``api`` entry point, bound to its arguments."""
        from mfcc_rust_tpu_torch import api

        e = self.config["api"]
        return functools.partial(getattr(api, e["function"]), **e["kwargs"], device=self.device)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def limit(self, name: str) -> float:
        return self.cell.limits.get(name, {}).get("limit", math.inf)

    @property
    def work_shape(self) -> tuple:
        """(rows, samples) of one call of a device cell."""
        t = self.traffic
        rate = int(self.config["feature_config"]["sample_rate"])
        return int(t["rows"]), int(round(float(t["seconds_of_audio"]) * rate))


def _counters() -> dict:
    """The program's counters: graphs captured and held, their bytes, K1
    and K2 launches."""
    from mfcc_rust_tpu_torch.ops.cuda import ct_mel, speechpy_mfcc
    from mfcc_rust_tpu_torch.parallel import data
    from mfcc_rust_tpu_torch.utils import graphs

    out = {"k1_launches": speechpy_mfcc.mfcc_fused.launches, "k2_launches": ct_mel.ct_mel.launches}
    for tag, cache in (("api", graphs.cache), ("steps", data.steps)):
        out[f"{tag}_captures"] = cache.captures
        out[f"{tag}_replays"] = cache.replays
        out[f"{tag}_graphs"] = len(cache)
    return out


def _held_bytes() -> dict:
    from mfcc_rust_tpu_torch.parallel import data
    from mfcc_rust_tpu_torch.utils import graphs

    return {tag: cache.stats()["bytes"] for tag, cache in (("api", graphs.cache),
                                                          ("steps", data.steps))}


def free_program() -> None:
    """Drop the program's graphs and cached blocks before the reference runs."""
    from mfcc_rust_tpu_torch.parallel import data
    from mfcc_rust_tpu_torch.utils import graphs

    graphs.cache.clear()
    data.steps.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: float | None = None) -> dict | None:
    """One run of ``cell``; the result's record, or None when a module the
    port must not load was loaded (named on standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ctx = Context(cell, seed % (1 << 63), dev, since=t_start)
    ctx.mark("imports")
    if on_card:
        torch.cuda.set_device(dev.index or 0)
        torch.cuda.init()
        torch.empty(1, device=dev)  # the CUDA context
    ctx.mark("context")
    drv = spec.driver(cell.traffic["kind"]).Driver(ctx)
    drv.setup()
    ctx.synchronize()
    ctx.mark("drain")
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    smi_before = card.smi() if on_card else {}
    before = _counters()

    ctx.window = drv.window(seconds)
    after = _counters()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ctx.scopes = drv.scopes()

    calls = ctx.window["units"] or 1
    checks = {"seconds_window": ctx.window["wall_s"], "units": ctx.window["units"], "pass_s": ctx.window.get("pass_s"),
              "captures_in_window": (after["api_captures"] - before["api_captures"]
                                     + after["steps_captures"] - before["steps_captures"]),
              "k1_launches_per_unit": (after["k1_launches"] - before["k1_launches"]) / calls,
              "k2_launches_per_unit": (after["k2_launches"] - before["k2_launches"]) / calls,
              "graphs_held": {"api": after["api_graphs"], "steps": after["steps_graphs"]},
              "setup_phases": ctx.phases, "card": smi_before}
    if on_card:
        checks["bytes_held"] = _held_bytes()
        checks["card_after"] = card.smi()

    metrics_out, dev_rec, breakdown = {}, {}, None
    if traced:
        ctx.trace = trace.profile(drv.slice)
        breakdown = trace.profile(lambda: drv.slice(host=True), host=True).breakdown()
        if on_card:
            ctx.enqueue_us = drv.enqueue_us()
        dev_rec = {"busy_s": ctx.trace.busy_s, "window_s": ctx.trace.window_s}
        checks["trace_calls"] = ctx.trace.calls
        wanted = cell.per_layer
    else:
        wanted = cell.end_to_end
    ctx.window["setup_s"] = setup_s
    for m in wanted:
        value = spec.metric(m["name"]).read(ctx)
        if value is not None:
            metrics_out[m["name"]] = {"value": float(value), "unit": m["unit"]}

    drv.release()
    free_program()
    numbers = drv.numbers("program")
    failed, compared_n = numbers.pop("_failed"), numbers.pop("_compared")
    correct, compared = compare.judge(numbers, cell.limits)
    drv.close()
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded in the measured process:", ", ".join(bad),
              file=sys.stderr, flush=True)
        return None
    checks["readings_not_compared"] = {k: v for k, v in numbers.items() if k not in compared}
    checks["answers_compared"] = compared_n

    rec = {"correct": bool(correct), "attempted": int(ctx.window["attempted"]),
           "failed": int(failed), "metrics": metrics_out,
           "device": {"platform": "gpu" if on_card else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                      "count": 1, "memory_peak_bytes": int(peak), **dev_rec}}
    if breakdown is not None:
        rec["breakdown"] = breakdown
    rec["checks"] = checks
    rec["compared"] = compared
    return rec
