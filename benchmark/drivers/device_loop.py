"""Device-resident batches through an ``api`` entry point, in a cycle.

Traffic parameters (``traffic/<name>.json``, ``"kind": "device_loop"``):
``batches`` distinct (``rows``, ``seconds_of_audio`` x the config's sample
rate) batches of N(0, ``std``) float32 noise clipped to +-``clip``, made on
the device from the seed; ``warm_cycles`` cycles of the loop over the
batches after the first call of each (its capture); ``keep_picks`` calls of the window drawn
from the seed among its first ``pick_range``, whose answers are kept and
compared with the reference besides the last call of each batch;
``slice_calls`` calls in the traced slice.

One caller, a closed loop with no synchronise between calls: each call is
``api.<function>(batch, **kwargs)``, the configuration's entry.  The window
ends at a ``torch.cuda.synchronize()`` after the first call that starts
past ``--seconds``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchkit import compare
from reference import plain

SPIN_CYCLES = 200_000_000  # ~0.1 s of device spin behind the enqueue probe
ENQ_CALLS, ENQ_REPS = 8, 5


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, t = ctx.config, ctx.traffic
        self.rate = int(cfg["feature_config"]["sample_rate"])
        self.rows = int(t["rows"])
        self.samples = int(round(float(t["seconds_of_audio"]) * self.rate))
        self.xs: list = []
        self.kept: dict = {}  # call index -> (batch index, answer)

    # ----------------------------------------------------------- set-up --
    def setup(self) -> None:
        ctx, t = self.ctx, self.ctx.traffic
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        xs = torch.empty((int(t["batches"]), self.rows, self.samples), device=ctx.device)
        xs.normal_(0.0, float(t["std"]), generator=gen).clamp_(-float(t["clip"]),
                                                               float(t["clip"]))
        self.xs = list(xs.unbind(0))
        ctx.synchronize()
        ctx.mark("inputs")
        self.call = ctx.entry()
        ctx.mark("program")
        for x in self.xs:  # the first call of each shape captures its graph
            self.call(x)
        ctx.synchronize()
        ctx.mark("captures")
        for _ in range(int(t["warm_cycles"])):
            for x in self.xs:
                self.call(x)
        ctx.synchronize()
        ctx.mark("warm")

    # ----------------------------------------------------------- window --
    def window(self, seconds: float) -> dict:
        t = self.ctx.traffic
        rng = np.random.default_rng(self.ctx.seed)
        picks = set(int(i) for i in rng.integers(0, int(t["pick_range"]), int(t["keep_picks"])))
        n, calls, last = len(self.xs), 0, {}
        kept = {}
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            b = calls % n
            out = self.call(self.xs[b])
            if calls in picks:
                kept[calls] = (b, out)
            last[b] = (calls, out)
            calls += 1
            if time.perf_counter() >= deadline:
                break
        self.ctx.synchronize()
        wall = time.perf_counter() - t0
        kept.update({i: (b, out) for b, (i, out) in last.items()})
        self.kept = kept
        return {"audio_s": calls * self.rows * self.samples / self.rate, "wall_s": wall,
                "attempted": calls, "units": calls}

    # ------------------------------------------------------------ trace --
    def slice(self, host: bool = False) -> int:
        """The traced slice: ``slice_calls`` calls (a tenth of them where the
        profiler records the host too), each in a ``bench.call`` span;
        returns the count."""
        from torch.profiler import record_function

        from benchkit.trace import CALL

        n = int(self.ctx.traffic["slice_calls"]) // (10 if host else 1)
        for i in range(n):
            with record_function(CALL):
                self.call(self.xs[i % len(self.xs)])
        return n

    def enqueue_us(self) -> float:
        """Host µs to enqueue one call: groups of calls enqueued behind a
        device spin, so that no call waits for the device; one untimed call
        first after each synchronise (the first after one costs the host
        more, whatever it runs); the median over the groups."""
        host = []
        for _ in range(ENQ_REPS):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            self.call(self.xs[-1])
            t0 = time.perf_counter()
            out = None
            for i in range(ENQ_CALLS):
                out = self.call(self.xs[i % len(self.xs)])
            host.append((time.perf_counter() - t0) / ENQ_CALLS)
            torch.cuda.synchronize()
            del out
        return 1e6 * statistics.median(host)

    def scopes(self) -> dict:
        return {}

    # ----------------------------------------------------------- answers --
    def release(self) -> None:
        """Drop what only the program needs; keep the inputs and answers."""
        self.call = None

    def numbers(self, source: str = "program") -> dict:
        """The numbers that decide ``correct``: the worst kept answer of the
        window against the reference (``source="program"``), or the control
        in the program's place on the same batches (``"control"``)."""
        cfg = self.ctx.config
        ref_cfg = cfg["reference"]
        fn = plain.FUNCTIONS[ref_cfg["function"]]
        kind = cfg["compare"]
        worst, failed = 0.0, 0
        by_batch: dict = {}
        for i, (b, out) in sorted(self.kept.items()):
            by_batch.setdefault(b, []).append(out)
        for b, outs in sorted(by_batch.items()):
            x = self.xs[b]
            ref = fn(x, precision="float64", **ref_cfg["kwargs"])
            if source == "control":
                outs = [fn(x, precision="tf32", **ref_cfg["kwargs"])]
            for out in outs:
                err = compare.answer_err(kind, out, ref)
                worst = max(worst, err)
                failed += not err <= self.ctx.limit("max_err")
            del ref
        return {"max_err": worst, "_failed": failed, "_compared": len(self.kept)}

    def close(self) -> None:
        pass
