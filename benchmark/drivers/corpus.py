"""Whole passes of ``parallel.runner.CorpusRunner`` over a corpus of PCM16
WAV files, as the command-line tool runs them.

Traffic parameters (``traffic/<name>.json``, ``"kind": "corpus"``):
``files`` clips whose lengths are clip(lognormal(ln ``median_s``,
``sigma``), ``min_s``, ``max_s``) seconds at the config's sample rate,
drawn once from ``lengths_seed`` (every run extracts the same set of
lengths); the run's seed orders them and makes their samples, N(0,
``std``) clipped to +-1, quantised to int16.  ``runner`` holds the
runner's keyword arguments.  Set-up writes the files into the run's
temporary directory and runs one warm pass; each pass of the window writes
its features into a folder of its own.  The window ends at the end of the
first pass that finishes after ``--seconds``.  ``check_files`` answers,
drawn from the seed over the window's passes and files, with the longest
file of the last pass, are compared with the reference, and so is every
pass's corpus moments; every file of every pass must be there with its
frame count.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchkit import compare
from reference import pcm16, plain, speechpy_ref

BLOCK_FRAMES = 1 << 18  # frames of one reference block


def lengths(traffic: dict, rate: int) -> list:
    """The clips' lengths in samples, in the profile's own order."""
    rng = np.random.default_rng(int(traffic["lengths_seed"]))
    secs = np.clip(rng.lognormal(np.log(float(traffic["median_s"])), float(traffic["sigma"]),
                                 int(traffic["files"])),
                   float(traffic["min_s"]), float(traffic["max_s"]))
    return [int(s * rate) for s in secs]


def clips(traffic: dict, rate: int, seed: int, device) -> tuple:
    """(lengths in the run's order, their int16 samples in one host array),
    made on ``device`` from ``seed``."""
    lens = lengths(traffic, rate)
    order = np.random.default_rng(seed).permutation(len(lens))
    lens = [lens[i] for i in order]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.empty(sum(lens), device=device).normal_(0.0, float(traffic["std"]), generator=gen)
    pcm = (x.clamp_(-1.0, 1.0) * 32767.0).round_().to(torch.int16).cpu().numpy()
    return lens, pcm


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.rate = int(ctx.config["feature_config"]["sample_rate"])
        self.tmp = None
        self.passes: list = []  # (out folder, moments, meter) of each window pass

    # ----------------------------------------------------------- set-up --
    def setup(self) -> None:
        ctx = self.ctx
        self.tmp = Path(tempfile.mkdtemp(prefix="bench_corpus_"))
        self.lens, pcm = clips(ctx.traffic, self.rate, ctx.seed, ctx.device)
        ctx.mark("inputs")
        wav = self.tmp / "wav"
        wav.mkdir()
        self.paths, pos = [], 0
        for i, n in enumerate(self.lens):
            p = wav / f"utt{i:05d}.wav"
            pcm16.write(p, pcm[pos:pos + n], self.rate)
            self.paths.append(str(p))
            pos += n
        del pcm
        os.sync()  # the corpus on disk before any pass reads it: no writeback in the window
        ctx.mark("files")
        self.audio_s = sum(self.lens) / self.rate
        self._pass("warm")  # builds the native codec, captures the steps' graphs
        ctx.mark("warm")

    def _pass(self, tag: str):
        from mfcc_rust_tpu_torch.config import FeatureConfig
        from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner

        out = self.tmp / tag
        runner = CorpusRunner(self.paths, FeatureConfig(**self.ctx.config["feature_config"]),
                              feature=self.ctx.config["runner_feature"], out_dir=str(out),
                              device=self.ctx.device, **self.ctx.traffic["runner"])
        t0 = time.perf_counter()
        moments = runner.run()
        runner.meter.scopes["pass"] = time.perf_counter() - t0
        return out, moments, runner.meter

    # ----------------------------------------------------------- window --
    def window(self, seconds: float) -> dict:
        self.passes = []
        t0 = time.perf_counter()
        while True:
            self.passes.append(self._pass(f"pass{len(self.passes)}"))
            if time.perf_counter() - t0 >= seconds:
                break
        self.ctx.synchronize()
        wall = time.perf_counter() - t0
        return {"audio_s": len(self.passes) * self.audio_s, "wall_s": wall,
                "attempted": len(self.passes) * len(self.paths), "units": len(self.passes),
                "pass_s": [m.scopes["pass"] for _, _, m in self.passes]}

    def scopes(self) -> dict:
        """The runner's ``Meter`` scopes summed over the window's passes."""
        total: dict = {}
        for _, _, meter in self.passes:
            for k, v in meter.scopes.items():
                total[k] = total.get(k, 0.0) + v
        return total

    # ------------------------------------------------------------ trace --
    def slice(self, host: bool = False) -> int:
        """The traced slice: one pass, in a ``bench.pass`` span."""
        from torch.profiler import record_function

        from benchkit.trace import PASS

        with record_function(PASS):
            out, _, _ = self._pass("traced_host" if host else "traced")
        shutil.rmtree(out, ignore_errors=True)
        return 1

    def enqueue_us(self):
        return None

    # ----------------------------------------------------------- answers --
    def release(self) -> None:
        pass

    def _features(self, idx: list, precision: str):
        """(reference features of the files ``idx``, in order), computed in
        blocks from the files as the reference decodes them."""
        cfg = self.ctx.config["reference"]["kwargs"]
        sr, fl, fs = cfg["sample_rate"], cfg.get("frame_length", 0.020), \
            cfg.get("frame_stride", 0.01)
        kw = {k: v for k, v in cfg.items()
              if k not in ("sample_rate", "frame_length", "frame_stride")}
        block, size = [], 0
        for i in idx:
            y, rate = pcm16.read(self.paths[i])
            if rate != sr:
                raise ValueError(f"{self.paths[i]}: {rate} Hz, the config says {sr}")
            frames = plain.speechpy_frames(torch.as_tensor(y, device=self.ctx.device), sr, fl, fs)
            block.append(frames)
            size += frames.shape[0]
            if size >= BLOCK_FRAMES or i == idx[-1]:
                feats = plain.speechpy_mfcc_of_frames(torch.cat(block), sr, precision=precision,
                                                      **kw)
                yield from feats.split([f.shape[0] for f in block])
                block, size = [], 0

    def _frames(self, n: int) -> int:
        c = self.ctx.config["reference"]["kwargs"]
        fl = int(round(c["sample_rate"] * c.get("frame_length", 0.020)))
        step = int(round(c["sample_rate"] * c.get("frame_stride", 0.01)))
        return max(speechpy_ref.stack_frames_counts(n, fl, step, False)[0], 0)

    def numbers(self, source: str = "program") -> dict:
        """The numbers that decide ``correct``: the sampled files and every
        pass's moments against the reference (``source="program"``), or the
        control's files and moments in the program's place (``"control"``).
        Every file of every pass must be there with its frame count."""
        ctx, kind = self.ctx, self.ctx.config["compare"]
        n_files = len(self.paths)
        rng = np.random.default_rng(ctx.seed)
        want = int(ctx.traffic["check_files"])
        picks = {(int(p), int(f)) for p, f in zip(rng.integers(0, len(self.passes), want),
                                                    rng.integers(0, n_files, want))}
        picks.add((len(self.passes) - 1, int(np.argmax(self.lens))))
        names = [Path(p).stem + ".npy" for p in self.paths]

        bad = 0  # the control's answers have the reference's frames by construction
        for out, _, _ in (self.passes if source == "program" else ()):
            for name, n in zip(names, self.lens):
                try:
                    shape = np.load(out / name, mmap_mode="r").shape
                except (OSError, ValueError):
                    shape = None
                bad += shape != (self._frames(n), ctx.config["reference"]["kwargs"].get(
                    "num_cepstral", 13))

        # every file's reference features, once: the sampled answers and the moments
        count, total, total_sq = 0, 0.0, 0.0
        ctl = {"count": 0, "total": 0.0, "total_sq": 0.0}
        sampled = {f for _, f in picks}
        ref_of, ctl_of = {}, {}
        for i, feats in enumerate(self._features(list(range(n_files)), "float64")):
            count += feats.shape[0]
            total = total + feats.sum(0)
            total_sq = total_sq + feats.square().sum(0)
            if i in sampled:
                ref_of[i] = feats
        if source == "control":
            for i, feats in enumerate(self._features(list(range(n_files)), "tf32")):
                f64 = feats.double()
                ctl["count"] += f64.shape[0]
                ctl["total"] = ctl["total"] + f64.sum(0)
                ctl["total_sq"] = ctl["total_sq"] + f64.square().sum(0)
                if i in sampled:
                    ctl_of[i] = feats

        worst, failed = 0.0, 0
        for p, f in sorted(picks):
            if source == "control":
                got = ctl_of[f]
            else:
                path = self.passes[p][0] / names[f]
                got = torch.from_numpy(np.load(path)) if path.exists() else torch.empty(0)
            err = compare.answer_err(kind, got, ref_of[f])
            worst = max(worst, err)
            failed += not err <= ctx.limit("files_max_err")

        mean = total / count
        m2 = total_sq - total * mean
        sd = (m2 / count).sqrt()
        if source == "control":
            c_mean = ctl["total"] / ctl["count"]
            runs = [(ctl["count"], c_mean, ctl["total_sq"] - ctl["total"] * c_mean)]
        else:
            runs = [(float(m.count), torch.as_tensor(np.asarray(m.mean, np.float64)),
                     torch.as_tensor(np.asarray(m.m2, np.float64))) for _, m, _ in self.passes]
        count_diff, mean_err, m2_err = 0.0, 0.0, 0.0
        for c, mu, s2 in runs:
            mu, s2 = mu.to(mean.device, torch.float64), s2.to(mean.device, torch.float64)
            count_diff = max(count_diff, abs(c - count))
            mean_err = max(mean_err, float(((mu - mean).abs() / sd).max()))
            m2_err = max(m2_err, float(((s2 - m2).abs() / m2).max()))
        nums = {"files_max_err": worst, "files_bad": float(bad),
                "moments_count_diff": count_diff, "moments_mean_err": mean_err,
                "moments_m2_err": m2_err}
        for k, v in list(nums.items()):
            if not math.isfinite(v):
                nums[k] = math.inf
        return {**nums, "_failed": failed + bad, "_compared": len(picks) + len(self.passes)}

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
