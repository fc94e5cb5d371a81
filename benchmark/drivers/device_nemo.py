"""Device-resident ragged batches through ``api.log_mel_spectrogram_nemo``,
in a cycle: each batch padded to its own longest row, with the rows'
lengths beside it (NeMo's collate).

Traffic parameters (``traffic/<name>.json``, ``"kind": "device_nemo"``):
those of ``drivers/device_loop.py``, whose window, traced slice and enqueue
probe this driver keeps, and whose set-up it repeats with another batch
maker: ``batches`` batches of ``rows`` rows, each row N(0, ``std``) float32
noise clipped to +-``clip`` for its true length, then zeros to the batch's
longest row; the lengths as an int64 tensor on the device.  Each row's
true length is drawn from the seed, independently of every other row, as
the Whisper cell draws its own (``device_whisper.true_lengths``):
clip(lognormal(ln ``median_s``, ``sigma``), ``min_s``, ``max_s``) seconds.
The noise is made on the device from the seed.  ``seconds_of_audio``,
which ``device_loop`` reads at its start as its rows' length, is set to
``max_s``; this driver's batches take their longest row's length.

Each call is ``api.log_mel_spectrogram_nemo(x_b, lengths_b, **kwargs)``.
The window counts the true speech of the calls made, the sum of each
batch's lengths, since NeMo's encoder reads only each row's own frames;
its record gives each batch's shape and lengths to the readers of the
per-layer metrics (``batches``).

What it changes besides is the comparison: one number, ``max_abs_err``,
max |got - ref| over the kept answers, the zeros past each row's frames
included, against the configuration's ``reference`` (a function of
``reference/nemo_ref.py``); a wrong shape, a non-finite value or frame
counts that differ from the reference's read inf.
"""

from __future__ import annotations

import math

import torch

from benchkit import spec
from reference import nemo_ref

_loop = spec.driver("device_loop")
_whisper = spec.driver("device_whisper")


class Driver(_loop.Driver):
    def setup(self) -> None:
        ctx, t = self.ctx, self.ctx.traffic
        shape = (int(t["batches"]), self.rows)
        self.lengths = _whisper.true_lengths(ctx.seed, t, shape, self.rate)
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        self.xs = []  # (audio, lengths) a batch
        for lengths in self.lengths:
            n = int(lengths.max())
            x = torch.empty((self.rows, n), device=ctx.device)
            x.normal_(0.0, float(t["std"]), generator=gen).clamp_(-float(t["clip"]),
                                                                   float(t["clip"]))
            lens = torch.as_tensor(lengths, dtype=torch.int64, device=ctx.device)
            x.masked_fill_(torch.arange(n, device=ctx.device) >= lens.unsqueeze(-1), 0.0)
            self.xs.append((x, lens))
        ctx.synchronize()
        ctx.mark("inputs")
        entry = ctx.entry()
        self.call = lambda batch: entry(*batch)
        ctx.mark("program")
        for batch in self.xs:  # the first call of each batch
            self.call(batch)
        ctx.synchronize()
        ctx.mark("captures")
        for _ in range(int(t["warm_cycles"])):
            for batch in self.xs:
                self.call(batch)
        ctx.synchronize()
        ctx.mark("warm")

    def window(self, seconds: float) -> dict:
        rec = super().window(seconds)
        n, calls = len(self.xs), rec["units"]
        rec["audio_s"] = sum(int(self.lengths[b].sum()) * len(range(b, calls, n))
                             for b in range(n)) / self.rate
        rec["batches"] = [[int(x.shape[-1]), [int(v) for v in lengths]]
                          for (x, _), lengths in zip(self.xs, self.lengths)]
        return rec

    def numbers(self, source: str = "program") -> dict:
        """The worst kept answer against the reference (``source="program"``),
        or the control in the program's place on the same batches
        (``"control"``)."""
        ref_cfg = self.ctx.config["reference"]
        fn = nemo_ref.FUNCTIONS[ref_cfg["function"]]
        worst, failed = 0.0, 0
        by_batch: dict = {}
        for i, (b, out) in sorted(self.kept.items()):
            by_batch.setdefault(b, []).append(out)
        for b, outs in sorted(by_batch.items()):
            x, lens = self.xs[b]
            ref, ref_lens = fn(x, lens, precision="float64", **ref_cfg["kwargs"])
            if source == "control":
                outs = [fn(x, lens, precision="tf32", **ref_cfg["kwargs"])]
            for feats, feat_lens in outs:
                same = torch.equal(torch.as_tensor(feat_lens).to(ref_lens.device), ref_lens)
                err = _whisper.abs_err(feats, ref) if same else math.inf
                worst = max(worst, err)
                failed += not err <= self.ctx.limit("max_abs_err")
            del ref
        return {"max_abs_err": worst, "_failed": failed, "_compared": len(self.kept)}
