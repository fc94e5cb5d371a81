"""Device-resident batches of 30-s Whisper windows through
``api.log_mel_spectrogram_whisper``, in a cycle.

Traffic parameters (``traffic/<name>.json``, ``"kind": "device_whisper"``):
those of ``drivers/device_loop.py``, whose window, traced slice and enqueue
probe this driver keeps as they are, and whose set-up it repeats with
another batch maker: each row of ``seconds_of_audio`` x the config's sample
rate samples holds speech of a true length drawn from the seed,
clip(lognormal(ln ``median_s``, ``sigma``), ``min_s``, ``max_s``) seconds, as
N(0, ``std``) float32 noise clipped to +-``clip``, then zeros to the end of
the window (transformers' ``padding="max_length"``).  The noise is made on
the device from the seed, the lengths by numpy from it.  The window counts
every row as its whole 30-s window, which is what Whisper's encoder takes.

What it changes besides is the comparison: one number, ``max_abs_err``,
max |got - ref| in Whisper's output units over the kept answers, against
the configuration's ``reference`` (a function of
``reference/whisper_ref.py``); a wrong shape or a non-finite value reads
inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchkit import spec
from reference import whisper_ref

_loop = spec.driver("device_loop")


def abs_err(got, ref: torch.Tensor) -> float:
    """max |got - ref|; inf where the shapes differ or ``got`` is not
    finite."""
    got = torch.as_tensor(got).to(ref.device)
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    if got.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got.double() - ref.double()).abs().max())


def true_lengths(seed: int, t: dict, shape: tuple, rate: int) -> np.ndarray:
    """Samples of speech in each row of ``shape`` (batches, rows) from the
    seed."""
    rng = np.random.default_rng([seed, 1])
    s = rng.lognormal(math.log(float(t["median_s"])), float(t["sigma"]), shape)
    s = np.clip(s, float(t["min_s"]), float(t["max_s"]))
    return np.round(s * rate).astype(np.int64)


class Driver(_loop.Driver):
    def setup(self) -> None:
        ctx, t = self.ctx, self.ctx.traffic
        shape = (int(t["batches"]), self.rows)
        lengths = true_lengths(ctx.seed, t, shape, self.rate)
        self.lengths = lengths
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        xs = torch.empty(shape + (self.samples,), device=ctx.device)
        xs.normal_(0.0, float(t["std"]), generator=gen).clamp_(-float(t["clip"]),
                                                               float(t["clip"]))
        tail = (torch.arange(self.samples, device=ctx.device)
                >= torch.as_tensor(lengths, device=ctx.device).unsqueeze(-1))
        xs.masked_fill_(tail, 0.0)
        del tail
        self.xs = list(xs.unbind(0))
        ctx.synchronize()
        ctx.mark("inputs")
        self.call = ctx.entry()
        ctx.mark("program")
        for x in self.xs:  # the first call of each batch
            self.call(x)
        ctx.synchronize()
        ctx.mark("captures")
        for _ in range(int(t["warm_cycles"])):
            for x in self.xs:
                self.call(x)
        ctx.synchronize()
        ctx.mark("warm")

    def numbers(self, source: str = "program") -> dict:
        """The worst kept answer against the reference (``source="program"``),
        or the control in the program's place on the same batches
        (``"control"``)."""
        ref_cfg = self.ctx.config["reference"]
        fn = whisper_ref.FUNCTIONS[ref_cfg["function"]]
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
                err = abs_err(out, ref)
                worst = max(worst, err)
                failed += not err <= self.ctx.limit("max_abs_err")
            del ref
        return {"max_abs_err": worst, "_failed": failed, "_compared": len(self.kept)}
