#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mfcc_rust_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Builds the port's kernels from the sources in this checkout (one nvcc per
source, all at once) and drives each of the port's two paths once with every
launch count set to 0, failing unless the path's kernel launched:

* speechpy: ``mfcc_rust_tpu_torch.mfcc`` on a B=48 x 10 s batch at 16 kHz
  (the MFCC-13 default) through kernel K1, ``speechpy_mfcc``;
* librosa: ``mfcc_rust_tpu_torch.mel_spectrogram_librosa`` on B=32 x 10 s at
  22,050 Hz (n_fft 2048, hop 512, 128 slaney mels) through kernel K2,
  ``ct_mel``, then ``log_mel_spectrogram`` and ``mfcc_librosa``;
* speechpy suite: ``resample`` of B=48 x 10 s at 44.1 kHz to 16 kHz, one
  ``extract`` of all five speechpy heads, the vorbis ``mel_spectrogram``,
  then ``cmvnw``, ``cmvn``, ``delta``, ``delta_librosa`` and the derivative
  cube.  These paths have no kernel (their products run on cuBLAS) and must
  launch none; ``FeatureExtractor`` and the ``transforms`` modules then
  must launch K1 or K2, each with the counts zeroed just before;
* streaming: six 60 s sessions of ``models.StreamingFeatures`` and
  ``models.StreamingExtractor`` (``streaming_phase``), each with the counts
  zeroed just before: the carried chunk-GEMM sessions and the streaming
  STFT must launch no kernel, the recompute sessions K1 or K2 once per
  call that emits frames.  Each session is held to its batch function and
  its float64 oracle, ``reset()`` must reproduce it, and each call is timed
  (``"streaming"`` in the record; not in the kernels line);
* corpus: 2,703 WAV files written from seed 0 (LibriSpeech dev-clean's
  count, ``bench.py``'s length profile), then ``parallel.CorpusRunner`` on
  a one-rank CUDA mesh (``corpus_phase``) with the counts zeroed just
  before: K1 must launch once a batch and K2 never; the outputs are held
  to the float64 oracle and the moments to float64 moments over every
  file; then five heads on a float16 wire (no launch), a mixed-rate corpus
  with ``resample=True``, and one step on an NCCL group of world size 1
  (bitwise equal to no group).  Its K1 and K2 counts go to the kernels
  line as ``launches_corpus``;
* cli: ``cli.main`` in this process on the first 512 of those files
  (``cli_phase``): K1 once a batch, K2 never, every output equal to the
  corpus run's; then ``python -m mfcc_rust_tpu_torch`` on 64 files;
* export: ``mfcc``, ``mfe``, the vorbis mel and the librosa mel exported
  at the headline shapes on the card, saved, loaded and held to the eager
  plain path and their float64 oracles, with no kernel launch
  (``export_phase``), and an export made on the CPU loaded onto the card;
* profiling: one ``api.mfcc`` inside ``utils.profiling.trace`` and
  ``annotate`` (``profiling_phase``), whose trace must name the annotation
  and K1's kernel, and the card's ``chip_spec`` and ``speed_of_light``.
  K1's and K2's ``bound_ms`` in the kernels line come from the work model
  of ``utils.profiling`` (``work``, ``bound_seconds``);
* bench: the port's benchmark, ``bench_torch.py`` (``bench_phase``): its
  headline, suite, corpus and scaling lines in this process, then the
  script on its own, whose first line must be the headline.  Every line
  must pass its gate (``bench_torch`` raises otherwise) and the gates must
  catch the suite's plain products run in TF32 (``tf32_control``); the
  kernels' launches over the lines go to the kernels line as
  ``launches_bench``.

Then it holds each kernel to its plain PyTorch version on the card
(max|Δ|/max|ref| <= 1e-4: K1 runs an FFT where its plain version multiplies
by a DFT matrix, and K2 factors the FFT otherwise), K1 at the headline also
to a float64 rfft computation, each path to its float64 oracle in
``tests/golden/`` at the reference's float32 gate, the autograd gradients to
the plain paths', and times each kernel, its plain version and a cuFFT
yardstick (library calls the port never makes) with CUDA events after an L2
flush, and the host time of one launch through each binding.  The suite
holds each ``extract`` head to the separate call, and resampling, SSC, the
vorbis mel and the post-processing to their float64 oracles, and times
each step (``"suite"`` in the record; not in the kernels line).  Each
kernel's entry of the kernels line names the FFT path it took at the
headline (path 1, the register FFT, for both), and the launch plans are
printed.

Any failed check raises, so the exit code is not 0.  Without a CUDA device
it exits 1 before printing any result.  The last lines are the card's
``nvidia-smi`` name and power limit, one ``{"kernels": [...]}`` JSON line,
and ``{"ok": true, "device": {...}}``.  With ``--out DIR`` the full
record (every timing sample) also goes to ``DIR/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH, SECONDS, RATE = 48, 10, 16000
REL_TOL = 1e-4
ORACLE_TOL = 5e-3
STREAM_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def rel_err(a, ref) -> tuple:
    """(max|a - ref| / max|ref|, max|a - ref|) of two tensors."""
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    assert a.shape == ref.shape, (tuple(a.shape), tuple(ref.shape))
    if ref.numel() == 0:
        return 0.0, 0.0
    d = (a - ref).abs().max().item()
    return d / ref.abs().max().item(), d


def cuda_ms(torch, fn, reps: int, flush) -> list:
    """Per-call device times in ms (CUDA events), each call after an L2
    flush: the main path meets a freshly uploaded batch, not a warm cache.
    A ~1 ms device spin after the flush keeps the card busy while the host
    queues the start event, the call and the end event, so the host's own
    launch time does not enter the interval as idle device time."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def host_us(torch, fn, reps: int = 500) -> float:
    """Median host time in microseconds of one call of fn, a launch through
    a kernel's binding (its arguments, the launch plan, the launch), on a
    small input; the device is waited on only after the last call."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        out.append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


L_BATCH, L_RATE = 32, 22050


def mfcc_float64(np, torch, x, cfg):
    """The speechpy MFCC of x (B, T) in float64 on x's device, by rfft:
    frames of fl samples every hop (F = (T - fl) // hop), |X|^2 / n, the
    filterbank, f32-eps zero handling, log, the DCT, log frame energy in
    column 0 (dc_elimination)."""
    from mfcc_rust_tpu_torch.constants import constant_bundle

    n, hop, fl = cfg.fft_points, cfg.frame_step, cfg.frame_size
    b = constant_bundle(cfg)
    fb = torch.as_tensor(b["fbank"].T, dtype=torch.float64, device=x.device)
    dct = torch.as_tensor(b["dct"], dtype=torch.float64, device=x.device)
    eps = float(np.finfo(np.float32).eps)
    fr = x.double().unfold(-1, fl, hop)[:, :(x.shape[-1] - fl) // hop]
    spec = torch.fft.rfft(fr, n=n)
    mel = (spec.abs() ** 2 / n) @ fb
    out = torch.log(torch.where(mel == 0, eps, mel)) @ dct
    if cfg.dc_elimination:
        en = (n * (fr * fr).sum(-1) + spec[..., 0].real ** 2 + spec[..., n // 2].real ** 2) / (2 * n)
        out[..., 0] = torch.log(torch.where(en == 0, eps, en))
    return out


def librosa_phase(np, torch, P, k1, k2, flush, chip) -> tuple:
    """The librosa path and kernel K2: main path, checks, times.  Returns
    (K2's entry of the kernels line, the record)."""
    from mfcc_rust_tpu_torch import api as PA
    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch.config import fp32_matmul
    from mfcc_rust_tpu_torch.constants import constant_bundle
    from mfcc_rust_tpu_torch.utils import profiling as prof
    from tests.golden import librosa_ref

    dev = torch.device("cuda")
    rec = {}
    rng = np.random.default_rng(0)
    t_true = SECONDS * L_RATE
    audio = rng.normal(0.0, 0.1, (L_BATCH, t_true)).astype(np.float32)

    # ------------------------------------------------------ main path, once --
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    t0 = time.perf_counter()
    mel = P.mel_spectrogram_librosa(audio, L_RATE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = k2.ct_mel.launches
    assert k1.mfcc_fused.launches == 0, "the librosa path launched speechpy_mfcc"
    assert mel.is_cuda and tuple(mel.shape) == (L_BATCH, 128, 431), tuple(mel.shape)
    assert bool(torch.isfinite(mel).all()), "non-finite mel"
    if launches < 1:
        raise AssertionError("the librosa main path did not launch the ct_mel kernel")
    log(f"librosa main path: mel_spectrogram_librosa({L_BATCH} x {t_true}) -> "
        f"{tuple(mel.shape)} in {first_s:.3f} s (first call); {k2.KERNEL} launches: {launches}")
    before = k2.ct_mel.launches
    lm = P.log_mel_spectrogram(audio, L_RATE)
    mf = P.mfcc_librosa(audio, L_RATE, n_mfcc=20)
    torch.cuda.synchronize()
    assert k2.ct_mel.launches == before + 2, "log-mel / mfcc_librosa missed the kernel"
    assert tuple(lm.shape) == (L_BATCH, 128, 431) and tuple(mf.shape) == (L_BATCH, 20, 431)
    assert bool(torch.isfinite(lm).all() and torch.isfinite(mf).all())
    log(f"log_mel_spectrogram -> {tuple(lm.shape)}, mfcc_librosa(n_mfcc=20) -> "
        f"{tuple(mf.shape)}, one launch each")

    # -------------------------- K2 against its plain version, main shape --
    cfg = P.librosa_config(L_RATE)
    x_main, cfg_main, count = PA._prep_librosa(audio, cfg, True, None)
    plan = k2.launch_plan(cfg_main, L_BATCH, 1 + (x_main.shape[1] - 2048) // 512)
    log(f"K2 launch plan at {tuple(x_main.shape)}: {plan}")
    assert plan["path"] == 1, "the librosa headline must take K2's register FFT (path 1)"
    rec["plan"] = plan
    out_k = k2.ct_mel(x_main, cfg_main)
    out_p = k2.ct_mel_plain(x_main, cfg_main)
    torch.cuda.synchronize()
    main_rel, main_abs = rel_err(out_k, out_p)
    log(f"K2 vs plain at {tuple(x_main.shape)} (F = {out_k.shape[1]}, {count} kept): "
        f"rel {main_rel:.3e} abs {main_abs:.3e}")
    assert main_rel <= REL_TOL, main_rel
    assert rel_err(mel, out_k[:, :count].transpose(1, 2))[0] == 0.0, \
        "main path differs from the kernel"
    rec["main_path"] = {"shape": [L_BATCH, t_true], "bucket": list(x_main.shape),
                        "frames": out_k.shape[1], "kept": count, "launches": launches,
                        "first_call_s": first_s, "rel": main_rel, "abs": main_abs}

    small = [
        ("1024/256", P.librosa_config(16000, n_fft=1024, hop_length=256), (2, 16000)),
        ("512/160/80 16 kHz", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
         (2, 16000)),
        ("512/130/64", P.librosa_config(16000, n_fft=512, hop_length=130, n_mels=64),
         (2, 16000)),
        ("2048/768", P.librosa_config(16000, n_fft=2048, hop_length=768), (2, 16000)),
        ("2048/100", P.librosa_config(22050, hop_length=100), (2, 16000)),
        ("2048/333, odd hop", P.librosa_config(22050, hop_length=333), (2, 16001)),
        ("256/64", P.librosa_config(8000, n_fft=256, n_mels=40), (2, 8000)),
        ("768/192, path 2", P.librosa_config(16000, n_fft=768, n_mels=64), (2, 16000)),
        ("4096/1024, path 2", P.librosa_config(44100, n_fft=4096), (2, 30000)),
        ("T no multiple of 4", cfg, (3, 16003)),
        ("center=False", cfg.replace(center=False), (2, 22050)),
        ("1-D", cfg, (22050,)),
        ("3-D", cfg, (2, 3, 8000)),
        ("100 samples, centred", cfg, (100,)),
        ("100 samples, uncentred", cfg.replace(center=False), (100,)),
    ]
    rec["small"] = {}
    for name, scfg, shape in small:
        xs = torch.from_numpy(rng.normal(0.0, 0.1, shape).astype(np.float32)).to(dev)
        before = k2.ct_mel.launches
        got = PF.mel_spectrogram_librosa(xs, scfg)
        ref = PF.mel_spectrogram_librosa(xs, scfg.replace(pallas="off"))
        torch.cuda.synchronize()
        r1, a1 = rel_err(got, ref)
        assert k2.ct_mel.launches - before == (1 if got.shape[-1] else 0), name
        assert r1 <= REL_TOL, (name, r1)
        if name == "100 samples, centred":
            assert got.shape == (128, 1), tuple(got.shape)
        if name == "100 samples, uncentred":
            assert got.shape == (128, 0), tuple(got.shape)
        path = k2.path_for(scfg)
        rec["small"][name] = {"rel": r1, "abs": a1, "shape": list(got.shape), "path": path}
        log(f"K2 vs plain path, {name} {shape}, path {path}: rel {r1:.3e} -> {tuple(got.shape)}")

    xs = torch.from_numpy(rng.normal(0.0, 0.1, (2, 22050)).astype(np.float32)).to(dev)
    a = PF.mfcc_librosa(xs, cfg).cpu().numpy()
    b = PF.mfcc_librosa(xs, cfg.replace(pallas="off")).cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    rec["mfcc_librosa_abs"] = float(np.abs(a - b).max())
    log(f"mfcc_librosa through K2 vs plain: max abs {rec['mfcc_librosa_abs']:.3e} "
        "(gate rtol 1e-3, atol 1e-4)")

    # ------------------------------------------- main path vs the oracle ----
    t = np.arange(L_RATE) / L_RATE
    clip = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.normal(size=t.shape))
    gold = librosa_ref.melspectrogram(clip, L_RATE, 2048, 512)
    got = P.mel_spectrogram_librosa(clip.astype(np.float32), L_RATE).cpu().numpy()
    np.testing.assert_allclose(got, gold, rtol=5e-3, atol=1e-4 * gold.max())
    rec["oracle_rel"] = float(np.abs(got - gold).max() / np.abs(gold).max())
    log(f"api.mel_spectrogram_librosa vs float64 librosa oracle: rel {rec['oracle_rel']:.3e} "
        "(gate rtol 5e-3, atol 1e-4 max)")

    # --------------------------------------------------------- autograd -----
    xg = torch.from_numpy(rng.normal(0.0, 0.1, (2, 22050)).astype(np.float32)).to(dev)
    ga = xg.clone().requires_grad_(True)
    before = k2.ct_mel.launches
    PF.mel_spectrogram_librosa(ga, cfg).sqrt().sum().backward()
    assert k2.ct_mel.launches == before + 1
    gb = xg.clone().requires_grad_(True)
    PF.mel_spectrogram_librosa(gb, cfg.replace(pallas="off")).sqrt().sum().backward()
    rec["grad_rel"], _ = rel_err(ga.grad, gb.grad)
    log(f"grad through K2 vs the plain path: rel {rec['grad_rel']:.3e}")
    assert rec["grad_rel"] <= REL_TOL, rec["grad_rel"]

    # ----------------------------------------------------------- timing -----
    def yardstick(x, c):
        """Three library calls that the port never makes: cuFFT STFT
        (periodic hann, uncentred), |X|^2, the dense filterbank product."""
        fb = torch.as_tensor(constant_bundle(c)["fbank"], dtype=torch.float32, device=dev)
        win = torch.as_tensor(constant_bundle(c)["window"], dtype=torch.float32, device=dev)

        def run():
            with fp32_matmul():
                st = torch.stft(x, c.fft_points, c.frame_step, window=win, center=False,
                                return_complex=True)
                return torch.matmul(fb, st.abs() ** 2)
        return run

    timing = {}
    for label, c, batch, rate in (("2048/512", cfg, L_BATCH, L_RATE),
                                  ("512/160/80", P.librosa_config(
                                      16000, n_fft=512, hop_length=160, n_mels=80), 48, 16000)):
        au = rng.normal(0.0, 0.1, (batch, SECONDS * rate)).astype(np.float32)
        xb, cb, _ = PA._prep_librosa(au, c, True, None)
        plan_t = k2.launch_plan(cb, batch, 1 + (xb.shape[1] - c.fft_points) // c.frame_step)
        log(f"K2 launch plan, {label} at {tuple(xb.shape)}: {plan_t}")
        _, _, wp, _, km = k2._kernel_constants(cb)
        a = (c.fft_points, c.frame_step, km, wp.size, c.num_filters)
        assert plan_t["path"] == 1 and plan_t["warps"] == k2.fft_warps(*a), (label, plan_t)
        assert plan_t["smem_bytes"] == k2.fft_smem_bytes(*a, plan_t["warps"]), (label, plan_t)
        yard = yardstick(xb, cb)
        y_rel, _ = rel_err(yard().transpose(1, 2), k2.ct_mel(xb, cb))
        assert y_rel <= REL_TOL, ("yardstick disagrees", label, y_rel)
        runs = {"kernel": lambda: k2.ct_mel(xb, cb), "plain": lambda: k2.ct_mel_plain(xb, cb),
                "yardstick": yard}
        times = {k: [] for k in runs}
        for order in (("plain", "kernel", "yardstick"), ("yardstick", "kernel", "plain")):
            for k in order:
                times[k] += cuda_ms(torch, runs[k], 10, flush)
        med = {k: statistics.median(v) for k, v in times.items()}
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            P.mel_spectrogram_librosa(au, rate, n_fft=c.fft_points, hop_length=c.frame_step,
                                      n_mels=c.num_filters)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
        w = prof.work(cb, "mel_spectrogram_librosa", xb.shape[0], xb.shape[1])
        assert w["lowering"] == "k2", w["lowering"]
        flops, nbytes, least = w["flops"], w["bytes"], w["least_flops"]
        v4_flops, _ = prof.k2_work_stockham(cb, xb.shape[0], xb.shape[1])
        bound_s, bound_by = prof.bound_seconds(least, nbytes, chip)
        t_bytes = nbytes / (chip["hbm_gbs"] * 1e9)
        timing[label] = {
            "shape": list(xb.shape), "times_ms": times, "median_ms": med,
            "api_ms": statistics.median(host) * 1e3, "api_ms_all": [h * 1e3 for h in host],
            "flops": flops, "bound_flops": least, "bytes": nbytes,
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by, "yardstick_rel": y_rel,
            "plan": plan_t, "v4_flops": v4_flops,
        }
        log(f"K2 times, {label} at {tuple(xb.shape)}, median of {len(times['kernel'])}: "
            + ", ".join(f"{k} {med[k]:.4f} ms" for k in runs)
            + f"; api from host numpy {timing[label]['api_ms']:.3f} ms")
        log(f"K2 work, {label}: {least / 1e9:.3f} GFLOP (the least count known), "
            f"{nbytes / 1e6:.3f} MB; bound {timing[label]['bound_ms']:.4f} ms "
            f"({timing[label]['bound_by']}), {least / med['kernel'] / 1e9:.3f} TFLOP/s of it "
            f"achieved; audio-s/s kernel {batch * SECONDS / med['kernel'] * 1e3:.1f}")
        peak = chip["fp32_tflops"] * 1e12
        log(f"K2 design counts, {label}: path {plan_t['path']}'s {flops / 1e9:.3f} GFLOP "
            f"({1e3 * max(flops / peak, t_bytes):.4f} ms), v4's (path 2's) "
            f"{v4_flops / 1e9:.3f} GFLOP ({1e3 * max(v4_flops / peak, t_bytes):.4f} ms)")
    rec["timing"] = timing
    # host cost of a launch through the binding, path 1 and path 2
    rec["host_launch_us"] = {}
    stream = torch.cuda.current_stream().cuda_stream
    for label, c in (("2048/512, path 1", cfg),
                     ("768/192, path 2", P.librosa_config(16000, n_fft=768, n_mels=64))):
        xh = k2._center(torch.zeros((2, 22050), device=dev), c).contiguous()
        oh = torch.empty((2, 1 + (xh.shape[1] - c.fft_points) // c.frame_step, c.num_filters),
                         device=dev)
        lib2 = k2._lib()
        assert k2._launch(lib2, xh, c, oh, stream) == 0, label
        rec["host_launch_us"][label] = host_us(torch, lambda: k2._launch(lib2, xh, c, oh, stream))
        log(f"K2 host time of a launch through the binding, {label} at {tuple(xh.shape)}: "
            f"median {rec['host_launch_us'][label]:.2f} us")
    rec["clocks"] = smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    log(f"clocks.sm, power.draw, power.limit, temperature: {rec['clocks']}")
    head = timing["2048/512"]
    entry = {
        "name": k2.KERNEL, "route": "cuda",
        "source": "mfcc_rust_tpu_torch/ops/cuda/ct_mel.cu",
        "replaces": "mfcc_rust_tpu/ops/pallas/ct_mel.py:319",
        "launches": launches, "max_abs_err": main_abs,
        "ms": head["median_ms"]["kernel"], "plain_ms": head["median_ms"]["plain"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["median_ms"]["yardstick"], "path": plan["path"],
    }
    return entry, rec


SUITE_HEADS = ("mfcc", "lmfe", "mfe", "ssc", "energy")
SUITE_RATE_IN = 44100


def resample_segment_ok(np, resample_ref, x_row, y_row, up: int, down: int, s0: int,
                        n: int, margin: int = 32) -> float:
    """Hold one resampled row to the float64 oracle on an n-sample segment
    starting at s0 (a multiple of ``down``, so the segment's output m is the
    row's output s0*up/down + m), away from the segment's cut edges (the
    filter reaches ~half/up input samples; ``margin`` outputs cover it).
    The whole row would cost the literal oracle a 70M-point convolution.
    Returns max|Δ| over the compared outputs."""
    ref = resample_ref.resample_poly_ref(x_row[s0:s0 + n], up, down)
    o0 = s0 * up // down
    lo = 0 if s0 == 0 else margin
    hi = len(ref) - margin
    got = y_row[o0 + lo:o0 + hi]
    np.testing.assert_allclose(got, ref[lo:hi], rtol=2e-4, atol=2e-5)
    return float(np.abs(got - ref[lo:hi]).max())


def suite_phase(np, torch, P, k1, k2, flush) -> dict:
    """The speechpy suite: a 44.1 kHz corpus brought to the MFCC-13 front end
    at full width.  Resample (48, 441,000) to 16 kHz, one ``extract`` of all
    five heads, the vorbis mel spectrogram, then sliding CMVN, CMVN and
    deltas on the MFCCs; each held to the port's separate calls and to the
    float64 oracles.  These paths have no kernel of their own (their
    products run on cuBLAS): they are driven with both launch counts at 0
    and must leave them there.  Then ``FeatureExtractor`` and the
    ``transforms`` modules, each with the counts zeroed just before, must
    launch K1 or K2.  Returns the record (times in ms, CUDA events)."""
    import torch.nn.functional as tF

    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch import transforms as T
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
    from tests.golden import dfn_ref, resample_ref, speechpy_ref

    dev = torch.device("cuda")
    rec = {}
    rng = np.random.default_rng(0)
    audio44 = rng.normal(0.0, 0.1, (BATCH, SECONDS * SUITE_RATE_IN)).astype(np.float32)
    x44 = torch.from_numpy(audio44).to(dev)
    torch.cuda.synchronize()

    def rel(a, ref):
        return rel_err(a, ref if isinstance(ref, torch.Tensor) else torch.from_numpy(ref))[0]

    # ------------------------------------------ the suite's main path, once --
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    t0 = time.perf_counter()
    y = P.resample(x44, SUITE_RATE_IN, RATE)
    ex = P.extract(y, RATE, which=SUITE_HEADS)
    mel = P.mel_spectrogram(y, RATE)
    mf = ex["mfcc"]
    post = {"cmvnw": P.cmvnw(mf, 301, True), "cmvn": P.cmvn(mf),
            "delta": P.delta(mf), "delta_librosa": P.delta_librosa(mf.transpose(1, 2)),
            "derivative": P.extract_derivative_feature(mf)}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    assert launches == (0, 0), ("the suite's paths launched a kernel", launches)
    f_true = (RATE * SECONDS - 320) // 160
    assert tuple(y.shape) == (BATCH, RATE * SECONDS) and y.is_cuda, tuple(y.shape)
    assert tuple(mf.shape) == (BATCH, f_true, 13), tuple(mf.shape)
    assert tuple(mel.shape) == (BATCH, 40, -(-RATE * SECONDS // 320)), tuple(mel.shape)
    assert tuple(post["derivative"].shape) == (BATCH, f_true, 13, 3)
    for name, t in [("resample", y), ("mel", mel)] + list(post.items()) + \
            [(k, v if k != "mfe" else v[0]) for k, v in ex.items()]:
        assert bool(torch.isfinite(t).all()), f"non-finite {name}"
    log(f"suite main path: resample {tuple(x44.shape)} 44.1 -> 16 kHz {tuple(y.shape)}, "
        f"extract {SUITE_HEADS} -> mfcc {tuple(mf.shape)}, mel_spectrogram {tuple(mel.shape)}, "
        f"cmvnw/cmvn/delta/delta_librosa/derivatives in {first_s:.3f} s (first call); "
        f"launches K1, K2: {launches}")

    # 1. resample: two rows against the float64 oracle (segments, see above)
    y_np = y.cpu().numpy()
    rec["resample_abs"] = [
        resample_segment_ok(np, resample_ref, audio44[0].astype(np.float64), y_np[0],
                            160, 441, 0, 2205),
        resample_segment_ok(np, resample_ref, audio44[-1].astype(np.float64), y_np[-1],
                            160, 441, 441 * (audio44.shape[1] // 882), 2205),
    ]
    log(f"resample rows 0 and {BATCH - 1} vs float64 oracle (rtol 2e-4, atol 2e-5): "
        f"max abs {rec['resample_abs']}")

    # 2. extract: each head vs the separate call on the same tensor (plain)
    cfg = P.speechpy_config(RATE)
    off = cfg.replace(pallas="off")
    yb = tF.pad(y, (0, bucket_length(y.shape[1]) - y.shape[1]))
    k = f_true
    sep_mfe = PF.mfe(yb, cfg)
    separate = {"mfcc": PF.mfcc(yb, off), "lmfe": PF.lmfe(yb, cfg), "mfe": sep_mfe[0],
                "energy": sep_mfe[1], "ssc": PF.ssc(yb, cfg)}
    rec["extract_rel"] = {}
    for name, ref in separate.items():
        got = ex[name] if name != "mfe" else ex["mfe"][0]
        rec["extract_rel"][name] = rel(got, ref[:, :k])
        assert rec["extract_rel"][name] <= 1e-5, (name, rec["extract_rel"][name])
    assert rel(ex["mfe"][1], sep_mfe[1][:, :k]) <= 1e-5
    k1_mfcc = P.mfcc(y, RATE)
    rec["extract_mfcc_vs_k1"] = rel(mf, k1_mfcc)
    assert rec["extract_mfcc_vs_k1"] <= ORACLE_TOL, rec["extract_mfcc_vs_k1"]
    y0 = y_np[0].astype(np.float64)
    rec["ssc_oracle_rel"] = rel(ex["ssc"][0], speechpy_ref.ssc(y0, RATE))
    assert rec["ssc_oracle_rel"] <= ORACLE_TOL, rec["ssc_oracle_rel"]
    log(f"extract heads vs separate plain calls: {rec['extract_rel']} (limit 1e-5); mfcc head "
        f"vs K1's mfcc {rec['extract_mfcc_vs_k1']:.3e}, ssc row 0 vs float64 oracle "
        f"{rec['ssc_oracle_rel']:.3e} (limit {ORACLE_TOL})")

    # 3. the vorbis mel spectrogram: two rows against the stateful oracle
    rec["mel_oracle_rel"] = [rel(mel[i], dfn_ref.mel_spectrogram1(y_np[i].astype(np.float64),
                                                                 RATE)) for i in (0, BATCH - 1)]
    assert max(rec["mel_oracle_rel"]) <= ORACLE_TOL, rec["mel_oracle_rel"]
    log(f"mel_spectrogram rows 0, {BATCH - 1} vs float64 oracle: {rec['mel_oracle_rel']}")

    # 4. post-processing: one utterance against the speechpy oracle
    i = BATCH // 2
    u = mf[i].double().cpu().numpy()
    rec["post_oracle_rel"] = {
        "cmvnw": rel(post["cmvnw"][i], speechpy_ref.cmvnw(u, 301, True)),
        "cmvn": rel(post["cmvn"][i], speechpy_ref.cmvn(u)),
        "derivative": rel(post["derivative"][i], speechpy_ref.extract_derivative_feature(u)),
    }
    assert max(rec["post_oracle_rel"].values()) <= ORACLE_TOL, rec["post_oracle_rel"]
    log(f"post-processing, utterance {i} vs float64 speechpy oracle: {rec['post_oracle_rel']}")

    # 5. the modules that run the kernels, each with the counts zeroed
    def counted(fn):
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, (k1.mfcc_fused.launches, k2.ct_mel.launches)

    fe_out, fe_n = counted(lambda: P.FeatureExtractor(device="cuda")(y))
    assert fe_n == (1, 0), ("FeatureExtractor launches", fe_n)
    assert rel_err(fe_out, k1_mfcc)[0] <= REL_TOL  # unbucketed: the same frames
    sp_out, sp_n = counted(lambda: T.SpeechpyMFCC(RATE)(y))
    assert sp_n == (1, 0) and rel_err(sp_out, k1_mfcc)[0] <= REL_TOL, ("SpeechpyMFCC", sp_n)
    lib_audio = torch.from_numpy(rng.normal(0.0, 0.1, (L_BATCH, SECONDS * L_RATE))
                                 .astype(np.float32)).to(dev)
    ms_out, ms_n = counted(lambda: T.MelSpectrogram()(lib_audio))
    assert ms_n == (0, 1), ("MelSpectrogram", ms_n)
    assert tuple(ms_out.shape) == (L_BATCH, 128, 1 + SECONDS * L_RATE // 512)
    assert bool(torch.isfinite(ms_out).all())
    rec["module_launches"] = {"FeatureExtractor": fe_n, "SpeechpyMFCC": sp_n,
                              "MelSpectrogram": ms_n}
    log(f"launches (K1, K2): FeatureExtractor {fe_n}, transforms.SpeechpyMFCC {sp_n}, "
        f"transforms.MelSpectrogram on {tuple(lib_audio.shape)} {ms_n}")

    # 6. times, CUDA events after an L2 flush, median of 20
    vcfg = P.vorbis_config(RATE)
    runs = {
        "resample": lambda: P.resample(x44, SUITE_RATE_IN, RATE),
        "extract": lambda: PF.extract(yb, cfg, SUITE_HEADS),
        "separate": lambda: (PF.mfcc(yb, off), PF.lmfe(yb, cfg), PF.mfe(yb, cfg),
                             PF.ssc(yb, cfg)),
        "separate_k1": lambda: (PF.mfcc(yb, cfg), PF.lmfe(yb, cfg), PF.mfe(yb, cfg),
                                PF.ssc(yb, cfg)),
        "mfcc_k1": lambda: PF.mfcc(yb, cfg),
        "mel_spectrogram": lambda: PF.mel_spectrogram(yb, vcfg),
        "cmvnw": lambda: P.cmvnw(mf, 301, True),
        "delta": lambda: P.delta(mf),
    }
    times = {name: cuda_ms(torch, fn, 20, flush) for name, fn in runs.items()}
    med = {name: statistics.median(v) for name, v in times.items()}
    # host time of one call (no device wait): the post-processing is a few
    # dozen small PyTorch ops, whose dispatch may outlast their device work
    rec["host_ms"] = {name: host_us(torch, runs[name], 50) / 1e3
                      for name in ("cmvnw", "delta", "mel_spectrogram", "extract")}
    log(f"suite host time of one call, median of 50: {rec['host_ms']}")
    audio_s = BATCH * SECONDS
    rec.update({"shape_44k": list(x44.shape), "bucket": list(yb.shape), "first_call_s": first_s,
                "times_ms": times, "median_ms": med,
                "audio_s_per_s": {k: audio_s / v * 1e3 for k, v in med.items()},
                "launches": list(launches)})
    for name in runs:
        log(f"suite time, {name}: {med[name]:.4f} ms, "
            f"{rec['audio_s_per_s'][name]:.1f} audio-s/s")
    log(f"extract / separate (plain mfcc): {med['extract'] / med['separate']:.3f}; "
        f"vorbis mel / K1 mfcc: {med['mel_spectrogram'] / med['mfcc_k1']:.3f}")
    return rec


STREAM_SECONDS = 60


def feed_session(torch, sess, chunks, finalize: bool = False):
    """Feed the host chunks to a streaming session, one ``process()`` call
    at a time, each followed by a device sync so the frames are in hand.
    Returns (rows, or the (mel, energy) pair of ``mfe``; host ms of each
    call; calls that emitted frames)."""
    outs, times, emitting = [], [], 0
    for c in chunks:
        t0 = time.perf_counter()
        o = sess.process(c)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        emitting += (o[0] if isinstance(o, tuple) else o).shape[0] > 0
        outs.append(o)
    if finalize:
        outs.append(sess.finalize())
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(p) for p in zip(*outs)), times, emitting
    return torch.cat(outs), times, emitting


def call_device_ms(torch, sess, chunks, spin: int = 5_000_000) -> tuple:
    """Device time in ms of one ``process()`` call's work on device-resident
    chunks (CUDA events), each call after a ~2.5 ms device spin so the
    host's enqueue of the call's ops does not count as device time.
    Returns (device ms of each call, host ms of each enqueue): an enqueue
    longer than the spin would leave idle device time in the span."""
    for c in chunks[:20]:
        sess.process(c)
    torch.cuda.synchronize()
    dev, host = [], []
    for c in chunks[20:]:
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        sess.process(c)
        e.record()
        host.append((time.perf_counter() - t0) * 1e3)
        e.synchronize()
        dev.append(s.elapsed_time(e))
    return dev, host


def streaming_phase(np, torch, P, k1, k2) -> dict:
    """Streaming sessions at full width, one 60 s stream each (random normal
    audio, sigma 0.1, seed 0), the configs users run:

    S1 speechpy MFCC-13, 20/10 ms, 160-sample (one hop) chunks: carried
       chunk-GEMM, must launch no kernel;
    S2 the same config, ``mfe``, a seeded ragged schedule of 1-4,000
       samples: carried, no kernel;
    S3 MFCC at 25/10 ms (400/160, hop-misaligned), 1,600-sample chunks:
       the recompute path, K1 once per call that emits frames;
    S4 librosa mel at 22,050 Hz (2048/512, 128 mels, uncentred),
       2,048-sample blocks: carried, no kernel;
    S5 librosa mel at 16 kHz (512/160, 80 mels), 1,600-sample chunks:
       recompute, K2 once per emitting call;
    S6 ``StreamingExtractor`` on the vorbis preset, chunks of 10 hops, then
       ``finalize()``: the streaming STFT and the mel product, no kernel.

    Each session's launch counts are zeroed just before it.  Each is held to
    its batch function on the whole stream on the card (max|d|/max|ref|):
    the carried sessions to the plain batch path (``pallas="off"``), the
    recompute sessions to the batch through the same kernel, within
    STREAM_TOL; and to its float64 oracle at the reference's float32 gate.
    S1 is held to its batch within REL_TOL, the gate of two float32 forms
    of one product: its one-row products round X_0 = sum(x) otherwise than
    the batch's, a few of its 6,000 frames nearly cancel X_0, and the
    first speechpy filter weighs that bin alone, so the log of band 0 makes
    the rounding a relative error of ~4e-5.  The same session in float64
    (its first 10 s) is then held to the float64 batch within 1e-10.
    After ``reset()`` the first 10 s again must give the first frames to
    1e-6.  Times: the host clock around each call and its sync (median,
    p99, the median's share of the chunk's duration, audio-s/s), and for
    S1 and S3 the device time of one call (CUDA events).  Any failed check
    raises after the phase has printed every number."""
    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures
    from tests.golden import dfn_ref, librosa_ref, speechpy_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x16 = rng.normal(0.0, 0.1, STREAM_SECONDS * RATE).astype(np.float32)
    x22 = rng.normal(0.0, 0.1, STREAM_SECONDS * L_RATE).astype(np.float32)
    ragged, total = [], 0
    sched = np.random.default_rng(6)
    while total < x16.size:
        n = int(min(sched.integers(1, 4001), x16.size - total))
        ragged.append(n)
        total += n

    def cut(x, sizes):
        ends = np.cumsum(sizes)
        return [x[e - n:e] for n, e in zip(sizes, ends)]

    sp = P.speechpy_config(RATE)
    sp3 = sp.replace(frame_length=0.025)
    lc4 = P.librosa_config(L_RATE).replace(center=False)
    lc5 = P.librosa_config(RATE, n_fft=512, hop_length=160, n_mels=80).replace(center=False)
    vc = P.vorbis_config(RATE)
    x64, x22_64 = x16.astype(np.float64), x22.astype(np.float64)
    d16 = torch.from_numpy(x16).to(dev)
    d22 = torch.from_numpy(x22).to(dev)
    sessions = [
        # name, session, host stream, chunk sizes, path, (K1, K2) per emitting call
        ("S1", lambda: StreamingFeatures(sp, feature="mfcc"), x16, [160] * 6000,
         "incremental", (0, 0)),
        ("S2", lambda: StreamingFeatures(sp, feature="mfe"), x16, ragged, "incremental", (0, 0)),
        ("S3", lambda: StreamingFeatures(sp3, feature="mfcc"), x16, [1600] * 600,
         "recompute", (1, 0)),
        ("S4", lambda: StreamingFeatures(lc4, feature="mel_librosa"), x22,
         [2048] * (x22.size // 2048) + [x22.size % 2048], "incremental", (0, 0)),
        ("S5", lambda: StreamingFeatures(lc5, feature="mel_librosa"), x16, [1600] * 600,
         "recompute", (0, 1)),
        ("S6", lambda: StreamingExtractor(vc), x16, [10 * vc.stream_hop] * 300, "stft", (0, 0)),
    ]
    batch = {
        "S1": lambda: PF.mfcc(d16, sp.replace(pallas="off")),
        "S2": lambda: PF.mfe(d16, sp),
        "S3": lambda: PF.mfcc(d16, sp3),
        "S4": lambda: PF.mel_spectrogram_librosa(d22, lc4.replace(pallas="off")).T,
        "S5": lambda: PF.mel_spectrogram_librosa(d16, lc5).T,
        "S6": lambda: PF.mel_spectrogram(d16, vc).T,
    }
    oracle = {
        "S1": lambda: speechpy_ref.mfcc(x64, RATE),
        "S2": lambda: speechpy_ref.mfe(x64, RATE),
        "S3": lambda: speechpy_ref.mfcc(x64, RATE, frame_length=0.025),
        "S4": lambda: librosa_ref.melspectrogram(x22_64, L_RATE, 2048, 512,
                                                 center=False).T,
        "S5": lambda: librosa_ref.melspectrogram(x64, RATE, 512, 160, n_mels=80,
                                                 center=False).T,
        "S6": lambda: dfn_ref.mel_spectrogram1(x64, RATE).T,
    }
    fails, rec = [], {}

    def check(ok: bool, what: str):
        if not ok:
            fails.append(what)

    def rel_pair(a, ref) -> float:
        if isinstance(a, tuple):
            return max(rel_err(u, v if isinstance(v, torch.Tensor) else torch.from_numpy(v))[0]
                       for u, v in zip(a, ref))
        return rel_err(a, ref if isinstance(ref, torch.Tensor) else torch.from_numpy(ref))[0]

    for name, make, x, sizes, path, per_call in sessions:
        rate = L_RATE if x is x22 else RATE
        sess = make()
        chunks = cut(x, sizes)
        if path != "stft":
            check((sess._inc is not None) == (path == "incremental"), f"{name}: path")
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        out, times, emitting = feed_session(torch, sess, chunks, finalize=path == "stft")
        launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
        want = tuple(emitting * n for n in per_call)
        check(launches == want, f"{name}: launches {launches}, want {want}")
        ref = batch[name]()
        torch.cuda.synchronize()
        r_batch = rel_pair(out, ref)
        r_oracle = rel_pair(out, oracle[name]())
        tol = REL_TOL if name == "S1" else STREAM_TOL
        check(r_batch <= tol, f"{name}: vs batch {r_batch:.3e}")
        check(r_oracle <= ORACLE_TOL, f"{name}: vs oracle {r_oracle:.3e}")
        # reset: the first 10 s again
        sess.reset()
        n10 = int(np.searchsorted(np.cumsum(sizes), 10 * rate, side="right"))
        again, _, _ = feed_session(torch, sess, chunks[:n10])
        head = tuple(o[:a.shape[0]] for o, a in zip(out, again)) if isinstance(out, tuple) \
            else out[:again.shape[0]]
        r_reset = rel_pair(again, head)
        check(r_reset <= 1e-6 and (again[0] if isinstance(again, tuple) else again).shape[0] > 0,
              f"{name}: reset {r_reset:.3e}")
        rows = (out[0] if isinstance(out, tuple) else out).shape
        dur = np.asarray(sizes[:len(times)], dtype=np.float64) / rate * 1e3
        t = np.asarray(times)
        r = {"path": path, "calls": len(chunks), "rows": list(rows), "emitting_calls": emitting,
             "launches": list(launches), "rel_batch": r_batch, "rel_oracle": r_oracle,
             "rel_reset": r_reset, "median_ms": float(np.median(t)),
             "p99_ms": float(np.percentile(t, 99)), "rt_share": float(np.median(t / dur)),
             "chunk_ms": float(np.median(dur)),
             "audio_s_per_s": STREAM_SECONDS / (t.sum() / 1e3),
             "times_ms": times}
        rec[name] = r
        log(f"streaming {name} ({path}): {len(chunks)} calls of median {r['chunk_ms']:.3f} ms "
            f"audio -> {tuple(rows)}; launches (K1, K2) {launches} over {emitting} emitting "
            f"calls; vs batch {r_batch:.3e} (limit {tol}), vs float64 oracle "
            f"{r_oracle:.3e} (limit {ORACLE_TOL}), reset {r_reset:.3e} (limit 1e-6)")
        log(f"streaming {name} host ms a call: median {r['median_ms']:.4f}, p99 "
            f"{r['p99_ms']:.4f}; median share of the chunk's duration {r['rt_share']:.4f}; "
            f"{r['audio_s_per_s']:.1f} audio-s/s")

    # the carried algorithm against the batch in float64 on the card: S1's
    # first 10 s, where float32 rounding does not reach the comparison
    sp64 = sp.replace(dtype="float64")
    out64, _, _ = feed_session(torch, StreamingFeatures(sp64, feature="mfcc"),
                               cut(x16, [160] * 1000))
    rec["S1"]["rel_batch_float64"] = rel_err(out64, PF.mfcc(d16[:160000].double(), sp64))[0]
    check(rec["S1"]["rel_batch_float64"] <= 1e-10,
          f"S1 float64: vs batch {rec['S1']['rel_batch_float64']:.3e}")
    log(f"streaming S1 in float64, first 10 s, vs the float64 batch on the card: "
        f"{rec['S1']['rel_batch_float64']:.3e} (limit 1e-10)")

    # the launch plans the recompute paths give the kernels at B = 1
    rec["S3"]["plan"] = k1.launch_plan(sp3, 1, 10)
    rec["S5"]["plan"] = k2.launch_plan(lc5, 1, 10)
    log(f"S3 K1 launch plan at (1, {10 * 160 + 400}): {rec['S3']['plan']}")
    log(f"S5 K2 launch plan at (1, {10 * 160 + 352}): {rec['S5']['plan']}")

    # device time of one call's work, device-resident chunks
    for name, make, size in (("S1", lambda: StreamingFeatures(sp, feature="mfcc"), 160),
                             ("S3", lambda: StreamingFeatures(sp3, feature="mfcc"), 1600)):
        chunks = [d16[i:i + size] for i in range(0, 220 * size, size)]
        devt, host = call_device_ms(torch, make(), chunks)
        rec[name]["device_ms"] = devt
        rec[name]["enqueue_ms"] = host
        log(f"streaming {name} device ms of one call's work (CUDA events, median of "
            f"{len(devt)}): {statistics.median(devt):.4f}; host enqueue median "
            f"{statistics.median(host):.4f} ms, max {max(host):.4f} ms (spin ~2.5 ms)")
    rec["clocks"] = smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    log(f"clocks.sm, power.draw, power.limit, temperature: {rec['clocks']}")
    if fails:
        raise AssertionError("streaming phase: " + "; ".join(fails))
    return rec


CORPUS_CLIPS = 2703  # LibriSpeech dev-clean's utterance count
CORPUS_ORACLE_UTTS = 64
CORPUS_B_CLIPS = 512
CORPUS_C_CLIPS = 256
CORPUS_C_RATES = (16000, 22050, 44100)
STEP_SPIN = 30_000_000  # ~15 ms of device spin: longer than a step's enqueue


def corpus_lengths(np, rng, n: int, rate: int) -> list:
    """``bench.py``'s corpus length profile: durations
    clip(lognormal(ln 6 s, 0.6), 1, 35) at ``rate``."""
    secs = np.clip(rng.lognormal(np.log(6.0), 0.6, n), 1.0, 35.0)
    return [int(s * rate) for s in secs]


def write_corpus(np, write_wav, rng, lengths, rates, folder: Path) -> list:
    """One WAV a clip, samples N(0, 0.1) clipped to ±1; returns the paths."""
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, (n, sr) in enumerate(zip(lengths, rates)):
        clip = rng.normal(0.0, 0.1, n).astype(np.float32)
        np.clip(clip, -1.0, 1.0, out=clip)
        p = folder / f"utt{i:05d}.wav"
        write_wav(str(p), clip, sr)
        paths.append(str(p))
    return paths


def dc_term(np, x, fl: int, hop: int, frames: int):
    """Per-frame bound on how far two float32 products of the chunk-GEMM can
    move the log of the first mel band, which weighs the DC bin X_0 alone:
    each computes X_0 = sum of the frame's fl samples within gamma * sum|x|
    (gamma = fl * 2^-24, the bound of a float32 dot product), and
    log(X_0^2) moves by 2 dX_0 / |X_0|; so 4 gamma sum|x| / |X_0|."""
    x = x.astype(np.float64)
    c = np.concatenate([[0.0], np.cumsum(x)])
    a = np.concatenate([[0.0], np.cumsum(np.abs(x))])
    s = np.arange(frames) * hop
    x0 = np.abs(c[s + fl] - c[s])
    ab = a[s + fl] - a[s]
    gamma = fl * 2.0 ** -24
    return 4.0 * gamma * ab / np.maximum(x0, 1e-300)


def corpus_phase(np, torch, P, k1, k2, tmp: Path) -> dict:
    """The corpus path at LibriSpeech dev-clean's size, on one card.

    A corpus of 2,703 WAV files (``bench.py``'s length profile, seed 0:
    durations clip(lognormal(ln 6 s, 0.6), 1, 35) at 16 kHz, samples
    N(0, 0.1)) is written with the port's native ``write_wav`` into
    ``tmp/wav`` (run (a) writes its outputs to ``tmp/a``: the "cli" phase
    reads both), then:

    (a) ``CorpusRunner`` (batch 32, packed f32 outputs, the runner's
        defaults) on a one-rank CUDA mesh, ``"mfcc"``: K1 once a batch,
        with the launch counts zeroed just before.  Gates: every output
        has ``frame_counts_host`` rows x 13; 64 seeded utterances within
        ORACLE_TOL of the float64 speechpy oracle; the returned moments
        equal float64 two-pass moments over every written file (count
        exact, mean and std at rtol 1e-5, atol 1e-6).  The device time of
        one step at B = 32 x the most frequent bucket (CUDA events after a
        spin, median of 20), with its upload and on a device-resident
        buffer, and K1's own time at that shape.
    (b) the five speechpy heads of the first 512 clips, float16 wire: no
        kernel launches; each head within 2^-11 |x| (the wire) + 2^-24 + 1e-5
        of the head's max (two float32 product shapes) of ``api.extract``
        of the clip on the card, plus, for the log heads, the DC-bin term
        of :func:`dc_term`.
    (c) 256 clips, a third each at 16,000, 22,050 and 44,100 Hz,
        ``resample=True``: each output within ORACLE_TOL of
        ``api.resample`` then ``api.mfcc`` of the clip on the card.
    (d) one step over a mesh on an NCCL group of world size 1 equals the
        no-group mesh's bitwise.

    One H100 cannot hold two NCCL ranks: multi-rank meshes are proven on
    the CPU under gloo (tests/test_torch_port_parallel.py).  Any failed gate
    raises after the phase has printed its numbers."""
    import torch.distributed as dist

    from mfcc_rust_tpu_torch import runtime
    from mfcc_rust_tpu_torch.parallel import (extraction_step_packed, frame_counts_host,
                                              make_mesh, pack_signals)
    from mfcc_rust_tpu_torch.parallel.mesh import init_process_group
    from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
    from mfcc_rust_tpu_torch.runtime import read_wav, write_wav
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
    from tests.golden import speechpy_ref

    fails, rec = [], {}

    def check(ok: bool, what: str):
        if not ok:
            fails.append(what)

    if not runtime.native_available():
        raise AssertionError("corpus phase: the native WAV runtime did not build")
    cfg = P.FeatureConfig(sample_rate=RATE)
    hop, fl = cfg.frame_step, cfg.frame_size
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    lengths = corpus_lengths(np, rng, CORPUS_CLIPS, RATE)
    paths = write_corpus(np, write_wav, rng, lengths, [RATE] * CORPUS_CLIPS, tmp / "wav")
    disk = sum(Path(p).stat().st_size for p in paths)
    audio_s = sum(lengths) / RATE
    rec["corpus"] = {"clips": CORPUS_CLIPS, "audio_s": audio_s, "wav_bytes": disk,
                     "build_s": time.perf_counter() - t0}
    log(f"corpus: {CORPUS_CLIPS} clips, {audio_s:.1f} audio-s ({audio_s / 3600:.3f} h), "
        f"{disk / 1e6:.1f} MB of PCM16 WAV, written in {rec['corpus']['build_s']:.2f} s")

    # ----------------------------------------------------------- (a) --
    mesh = make_mesh()
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    runner = CorpusRunner(paths, cfg, mesh, batch_size=32, out_dir=str(tmp / "a"),
                          checkpoint_path=str(tmp / "a.npz"))
    t0 = time.perf_counter()
    moments = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    meter = runner.meter
    batches = int(meter.counters["dispatches"])
    a = {"wall_s": wall, "audio_s_per_s": audio_s / wall, "batches": batches,
         "launches": list(launches), "scopes": dict(meter.scopes),
         "counters": dict(meter.counters),
         "fetch_busy_s": meter.span_union("fetch"),
         "dispatch_busy_s": meter.span_union("dispatch")}
    check(launches == (batches, 0), f"(a): launches {launches}, want ({batches}, 0)")
    counts = frame_counts_host(lengths, cfg, "mfcc")
    outs, bad = [], 0
    for i in range(CORPUS_CLIPS):
        f = np.load(tmp / "a" / f"utt{i:05d}.npy")
        bad += f.shape != (counts[i], cfg.num_cepstral) or not np.isfinite(f).all()
        outs.append(f)
    check(bad == 0, f"(a): {bad} outputs of the wrong shape or not finite")
    allv = np.concatenate(outs).astype(np.float64)
    mean64 = allv.mean(0)
    std64 = np.sqrt(((allv - mean64) ** 2).mean(0))
    m_std = np.sqrt(np.maximum(np.asarray(moments.m2, np.float64)
                               / max(float(moments.count), 1.0), 0.0))
    a["frames"] = int(allv.shape[0])
    a["mean_err"] = float(np.abs(np.asarray(moments.mean) - mean64).max())
    a["std_err"] = float(np.abs(m_std - std64).max())
    check(int(moments.count) == allv.shape[0],
          f"(a): moments count {float(moments.count)} != {allv.shape[0]}")
    check(np.allclose(moments.mean, mean64, rtol=1e-5, atol=1e-6), "(a): moments mean")
    check(np.allclose(m_std, std64, rtol=1e-5, atol=1e-6), "(a): moments std")
    pick = np.random.default_rng(1).choice(CORPUS_CLIPS, CORPUS_ORACLE_UTTS, replace=False)
    worst = 0.0
    for i in pick:
        dec, _ = read_wav(paths[i])
        gold = speechpy_ref.mfcc(dec.astype(np.float64), RATE)
        worst = max(worst, rel_err(torch.from_numpy(outs[i]), torch.from_numpy(gold))[0])
    a["oracle_rel"] = worst
    check(worst <= ORACLE_TOL, f"(a): vs oracle {worst:.3e}")
    del allv, outs
    sc = ", ".join(f"{k} {v:.4f}" for k, v in sorted(meter.scopes.items()))
    log(f"corpus (a) mfcc: {CORPUS_CLIPS} files in {wall:.3f} s = {a['audio_s_per_s']:.1f} "
        f"audio-s/s end to end; {batches} batches, K1 launches {launches[0]}, K2 "
        f"{launches[1]}; {a['frames']} frames")
    log(f"corpus (a) scopes (host s): {sc}; fetch-span union {a['fetch_busy_s']:.4f} s, "
        f"dispatch-span union {a['dispatch_busy_s']:.4f} s")
    log(f"corpus (a) bytes: H2D {meter.counters.get('h2d_bytes', 0) / 1e6:.3f} MB, D2H "
        f"{meter.counters.get('d2h_bytes', 0) / 1e6:.3f} MB; fetch groups "
        f"{int(meter.counters.get('fetch_groups', 0))}")
    log(f"corpus (a) gates: moments vs float64 over every file: count "
        f"{int(moments.count)}, max|d mean| {a['mean_err']:.3e}, max|d std| "
        f"{a['std_err']:.3e} (rtol 1e-5, atol 1e-6); {CORPUS_ORACLE_UTTS} utterances vs "
        f"float64 oracle {worst:.3e} (limit {ORACLE_TOL})")

    # one step at B = 32 x the most frequent bucket
    keys = [bucket_length(n) for n in lengths]
    key = max(set(keys), key=keys.count)
    idx = [i for i, k in enumerate(keys) if k == key][:32]
    # the runner's step length: the bucket of the batch's longest clip,
    # rounded up to whole hops
    bucket = -(-bucket_length(max(lengths[i] for i in idx)) // hop) * hop
    clips = [read_wav(paths[i])[0] for i in idx]
    flat, offs, lens = pack_signals(clips, 32, pcm16_exact=True)
    fc = frame_counts_host(lens, cfg, "mfcc")
    flat_d = torch.from_numpy(flat).to(mesh.device)
    x_ext = torch.from_numpy(np.random.default_rng(3).normal(
        0.0, 0.1, (32, bucket + fl)).astype(np.float32)).to(mesh.device)
    step_audio = float(lens.sum()) / RATE
    runs = {"step": lambda: extraction_step_packed(flat, offs, lens, bucket, cfg, mesh,
                                                   "mfcc", frame_counts=fc),
            "step_resident": lambda: extraction_step_packed(flat_d, offs, lens, bucket, cfg,
                                                            mesh, "mfcc", frame_counts=fc),
            "k1": lambda: k1.mfcc_fused(x_ext, cfg)}
    times = {k: [] for k in runs}
    enqueue = {k: [] for k in runs}
    for _ in range(2):
        for k, fn in runs.items():
            fn()
        torch.cuda.synchronize()
    for _ in range(20):
        for k, fn in runs.items():
            torch.cuda._sleep(STEP_SPIN)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            s.record()
            fn()
            e.record()
            enqueue[k].append((time.perf_counter() - h0) * 1e3)
            e.synchronize()
            times[k].append(s.elapsed_time(e))
    med = {k: statistics.median(v) for k, v in times.items()}
    a["step"] = {"bucket": bucket, "clips_in_bucket": keys.count(key),
                 "audio_s": step_audio, "median_ms": med, "times_ms": times,
                 "enqueue_ms": enqueue}
    log(f"corpus (a) one step at (32, {bucket}) (the most frequent bucket, "
        f"{keys.count(key)} clips; {step_audio:.1f} audio-s), CUDA events after a "
        f"~15 ms spin, median of 20: {med['step']:.4f} ms with its upload, "
        f"{med['step_resident']:.4f} ms on a device-resident buffer, K1 alone "
        f"{med['k1']:.4f} ms; {step_audio / med['step'] * 1e3:.1f} audio-s/s on the device; "
        "host enqueue median / max: " + ", ".join(
            f"{k} {statistics.median(v):.4f} / {max(v):.4f} ms" for k, v in enqueue.items()))
    rec["a"] = a

    # ----------------------------------------------------------- (b) --
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    sub = paths[:CORPUS_B_CLIPS]
    t0 = time.perf_counter()
    CorpusRunner(sub, cfg, mesh, feature=SUITE_HEADS, batch_size=32,
                 out_dir=str(tmp / "b"), wire_dtype="float16").run()
    torch.cuda.synchronize()
    b = {"wall_s": time.perf_counter() - t0,
         "launches": [k1.mfcc_fused.launches, k2.ct_mel.launches]}
    check(b["launches"] == [0, 0], f"(b): launches {b['launches']}, want none")
    ratio = {h: 0.0 for h in SUITE_HEADS}
    dc_rows = 0
    for i, p in enumerate(sub):
        z = np.load(tmp / "b" / f"utt{i:05d}.npz")
        dec, _ = read_wav(p)
        ex = P.extract(dec, RATE, which=SUITE_HEADS)
        k = int(counts[i])
        dterm = dc_term(np, dec, fl, hop, k)
        for h in SUITE_HEADS:
            ref = (ex[h][0] if h == "mfe" else ex[h]).double().cpu().numpy()
            got = z[h].astype(np.float64)
            if got.shape != ref.shape or z[h].dtype != np.float16:
                ratio[h] = float("inf")
                continue
            bound = 2.0 ** -11 * np.abs(ref) + 2.0 ** -24 + 1e-5 * np.abs(ref).max()
            if h in ("mfcc", "lmfe"):
                base = bound
                bound = bound + dterm.reshape((-1,) + (1,) * (ref.ndim - 1))
                dc_rows += int((np.abs(got - ref) > base).any(axis=-1).sum())
            ratio[h] = max(ratio[h], float((np.abs(got - ref) / bound).max()))
    b["worst_ratio"] = ratio
    b["rows_needing_dc_term"] = dc_rows
    check(max(ratio.values()) <= 1.0, f"(b): heads vs api.extract {ratio}")
    log(f"corpus (b) five heads, float16 wire, {CORPUS_B_CLIPS} clips in {b['wall_s']:.3f} s; "
        f"launches (K1, K2) {tuple(b['launches'])}; max |d| / bound vs api.extract: "
        + ", ".join(f"{h} {r:.3f}" for h, r in ratio.items())
        + f" (limit 1); rows of mfcc/lmfe past the bound without the DC term: {dc_rows}")
    rec["b"] = b

    # ----------------------------------------------------------- (c) --
    rng_c = np.random.default_rng(2)
    rates = [CORPUS_C_RATES[i % 3] for i in range(CORPUS_C_CLIPS)]
    lc = [int(n * r / RATE) for n, r in
          zip(corpus_lengths(np, rng_c, CORPUS_C_CLIPS, RATE), rates)]
    cpaths = write_corpus(np, write_wav, rng_c, lc, rates, tmp / "wav_c")
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    t0 = time.perf_counter()
    rc = CorpusRunner(cpaths, cfg, mesh, batch_size=32, out_dir=str(tmp / "c"),
                      resample=True)
    rc.run()
    torch.cuda.synchronize()
    c = {"wall_s": time.perf_counter() - t0,
         "launches": [k1.mfcc_fused.launches, k2.ct_mel.launches],
         "dispatches": int(rc.meter.counters["dispatches"])}
    worst = 0.0
    for i, (p, sr) in enumerate(zip(cpaths, rates)):
        dec, _ = read_wav(p)
        ref = P.mfcc(P.resample(dec, sr, RATE), RATE)
        got = torch.from_numpy(np.load(tmp / "c" / f"utt{i:05d}.npy"))
        if tuple(got.shape) != tuple(ref.shape):
            worst = float("inf")
            break
        worst = max(worst, rel_err(got, ref)[0])
    c["rel"] = worst
    check(worst <= ORACLE_TOL, f"(c): vs api.resample + api.mfcc {worst:.3e}")
    log(f"corpus (c) resample=True, {CORPUS_C_CLIPS} clips at {CORPUS_C_RATES} Hz in "
        f"{c['wall_s']:.3f} s; {c['dispatches']} dispatches, launches (K1, K2) "
        f"{tuple(c['launches'])}; vs api.resample + api.mfcc {worst:.3e} "
        f"(limit {ORACLE_TOL})")
    rec["c"] = c

    # ----------------------------------------------------------- (d) --
    ref = extraction_step_packed(flat, offs, lens, bucket, cfg, make_mesh(), "mfcc",
                                 frame_counts=fc)
    rank_world = init_process_group(f"file://{tmp / 'pg'}", world_size=1, rank=0,
                                    backend="nccl", timeout=60.0)
    try:
        gmesh = make_mesh()
        got = extraction_step_packed(flat, offs, lens, bucket, cfg, gmesh, "mfcc",
                                     frame_counts=fc)
        same = all(torch.equal(u, v) for u, v in
                   zip(torch.utils._pytree.tree_leaves(got),
                       torch.utils._pytree.tree_leaves(ref)))
        grouped = gmesh.group is not None
    finally:
        dist.destroy_process_group()
    rec["d"] = {"rank_world": list(rank_world), "bitwise": same}
    check(same and grouped and rank_world == (0, 1), "(d): NCCL world 1 != no-group mesh")
    log(f"corpus (d) NCCL group of world 1 (rank, world) {rank_world}: one step at "
        f"(32, {bucket}) bitwise equal to the no-group mesh: {same}")
    rec["clocks"] = smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    log(f"clocks.sm, power.draw, power.limit, temperature: {rec['clocks']}")
    if fails:
        raise AssertionError("corpus phase: " + "; ".join(fails))
    return rec


EXPORT_TOL = 1e-6
CLI_CLIPS = 512
CLI_SUBPROCESS_CLIPS = 64


def export_phase(np, torch, P, k1, k2, flush, tmp: Path) -> dict:
    """The export path on the card (``mfcc_rust_tpu_torch.export``): ``mfcc``,
    ``mfe`` and the vorbis ``mel_spectrogram`` at the speechpy headline
    (48 x 177,664) and ``mel_spectrogram_librosa`` at the librosa one (32 x
    277,632, uncentred as the entry point hands it on), each exported on
    ``cuda``, saved to a ``.pt2`` file in ``tmp``, loaded and called, with
    the launch counts zeroed just before: exports take the plain lowering,
    so K1 and K2 must launch no time.  Each loaded program is held to the
    eager plain path on the same input within EXPORT_TOL (max|d|/max|ref|)
    and to its float64 oracle within ORACLE_TOL (the MFCC by a float64 rfft
    on every row, the others on rows 0 and B-1).  Then ``mfcc`` exported on
    the CPU at (2, 16000) and loaded onto ``cuda`` (its graph's constants
    moved) is held to the eager plain path on the card within 1e-5.  Times:
    each loaded program, the eager plain path and K1 (the speechpy
    features) or K2 (the librosa mel) at the same shape, CUDA events after
    an L2 flush, median of 10."""
    from mfcc_rust_tpu_torch import export as E
    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
    from tests.golden import dfn_ref, librosa_ref, speechpy_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    sp = P.speechpy_config(RATE)
    lc = P.librosa_config(L_RATE).replace(center=False)
    t_sp = bucket_length(SECONDS * RATE)
    t_lib = 277632  # the librosa headline's bucket after its centre pad
    x_sp = torch.from_numpy(rng.normal(0.0, 0.1, (BATCH, t_sp)).astype(np.float32)).to(dev)
    x_lib = torch.from_numpy(rng.normal(0.0, 0.1, (L_BATCH, t_lib)).astype(np.float32)).to(dev)
    rows = (0, BATCH - 1)

    def oracle_rel(feature, out, x):
        xn = x.double().cpu().numpy()
        if feature == "mfcc":
            return rel_err(out, mfcc_float64(np, torch, x, sp))[0]
        if feature == "mfe":
            return max(max(rel_err(o[i], torch.from_numpy(g))[0]
                           for o, g in zip(out, speechpy_ref.mfe(xn[i], RATE))) for i in rows)
        if feature == "mel_spectrogram":
            return max(rel_err(out[i], torch.from_numpy(dfn_ref.mel_spectrogram1(xn[i], RATE)))[0]
                       for i in rows)
        return max(rel_err(out[i], torch.from_numpy(librosa_ref.melspectrogram(
            xn[i], L_RATE, 2048, 512, center=False)))[0] for i in (0, L_BATCH - 1))

    cases = [("mfcc", sp, x_sp, k1.mfcc_fused, lambda: k1.mfcc_fused(x_sp, sp)),
             ("mfe", sp, x_sp, k1.mfcc_fused, lambda: k1.mfcc_fused(x_sp, sp)),
             ("mel_spectrogram", P.vorbis_config(RATE), x_sp, k1.mfcc_fused,
              lambda: k1.mfcc_fused(x_sp, sp)),
             ("mel_spectrogram_librosa", lc, x_lib, k2.ct_mel, lambda: k2.ct_mel(x_lib, lc))]
    fails, rec = [], {}
    for feature, cfg, x, kernel, kernel_call in cases:
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        path = tmp / f"{feature}.pt2"
        t0 = time.perf_counter()
        E.export_pipeline(cfg, feature, tuple(x.shape), path=str(path), device="cuda")
        export_s = time.perf_counter() - t0
        loaded = E.load_pipeline(str(path), device="cuda")
        got = loaded(x)
        eager = getattr(PF, feature)(x, cfg.replace(pallas="off"))
        torch.cuda.synchronize()
        launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
        pairs = list(zip(got, eager)) if isinstance(got, tuple) else [(got, eager)]
        r_eager = max(rel_err(a, b)[0] for a, b in pairs)
        r_oracle = oracle_rel(feature, got, x)
        times = {"loaded": cuda_ms(torch, lambda: loaded(x), 10, flush),
                 "eager_plain": cuda_ms(torch, lambda: getattr(PF, feature)(
                     x, cfg.replace(pallas="off")), 10, flush),
                 kernel.__name__: cuda_ms(torch, kernel_call, 10, flush)}
        med = {k: statistics.median(v) for k, v in times.items()}
        rec[feature] = {"shape": list(x.shape), "export_s": export_s,
                        "pt2_bytes": path.stat().st_size, "launches": list(launches),
                        "rel_eager": r_eager, "rel_oracle": r_oracle, "times_ms": times,
                        "median_ms": med}
        if launches != (0, 0):
            fails.append(f"{feature}: launches {launches}")
        if not (r_eager <= EXPORT_TOL and r_oracle <= ORACLE_TOL):
            fails.append(f"{feature}: vs eager {r_eager:.3e}, vs oracle {r_oracle:.3e}")
        log(f"export {feature} at {tuple(x.shape)}: exported in {export_s:.3f} s, "
            f"{path.stat().st_size / 1e6:.3f} MB .pt2; launches (K1, K2) {launches}; loaded vs "
            f"eager plain {r_eager:.3e} (limit {EXPORT_TOL}), vs float64 oracle {r_oracle:.3e} "
            f"(limit {ORACLE_TOL}); median ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))

    # exported on the CPU, loaded onto the card
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    x_small = rng.normal(0.0, 0.1, (2, 16000)).astype(np.float32)
    path = tmp / "mfcc_cpu.pt2"
    E.export_pipeline(sp, "mfcc", (2, 16000), path=str(path), device="cpu")
    got = E.load_pipeline(str(path), device="cuda")(x_small)
    ref = PF.mfcc(torch.from_numpy(x_small).to(dev), sp.replace(pallas="off"))
    torch.cuda.synchronize()
    r_moved = rel_err(got, ref)[0]
    moved_launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    rec["cpu_to_cuda"] = {"device": str(got.device), "rel": r_moved,
                          "launches": list(moved_launches)}
    if not (got.is_cuda and r_moved <= 1e-5 and moved_launches == (0, 0)):
        fails.append(f"cpu export on cuda: {got.device}, {r_moved:.3e}, {moved_launches}")
    log(f"export mfcc on the CPU at (2, 16000), loaded onto {got.device}: vs the eager plain path "
        f"on the card {r_moved:.3e} (limit 1e-5); launches (K1, K2) {moved_launches}")
    if fails:
        raise AssertionError("export phase: " + "; ".join(fails))
    return rec


def cli_phase(np, torch, P, k1, k2, tmp: Path) -> dict:
    """The command line on the card (``mfcc_rust_tpu_torch.cli``), on the
    corpus phase's WAV files (``tmp/wav``): ``cli.main`` in this process on
    the first 512 with ``--feature mfcc --out-dir --cmvn-out --quiet``, the
    launch counts zeroed just before.  K1 must launch once a dispatched
    batch (the report's ``counters.dispatches``; its ``batches`` counts
    every metered scope, as the JAX package's does) and K2 never; each
    ``.npy`` must equal run (a)'s output for that file (``tmp/a``) within
    1e-6 (max|d|/max|ref|), the npz must hold count, mean, m2 and std, and
    the report must count 512 utterances.  Then ``python -m
    mfcc_rust_tpu_torch`` in a subprocess on the first 64 files must exit 0
    with a last line that parses and counts 64 utterances.  Prints the
    end-to-end audio-s/s (host clock around ``main``) and the host scopes."""
    import contextlib
    import io

    from mfcc_rust_tpu_torch import cli
    from mfcc_rust_tpu_torch.runtime import read_wav

    paths = sorted(str(p) for p in (tmp / "wav").glob("utt*.wav"))
    sub = paths[:CLI_CLIPS]
    audio_s = sum(read_wav(p)[0].shape[0] for p in sub) / RATE
    out_dir, cmvn = tmp / "cli", tmp / "cli_cmvn.npz"
    fails = []
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main([*sub, "--feature", "mfcc", "--out-dir", str(out_dir),
                       "--cmvn-out", str(cmvn), "--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    report = json.loads(stdout.getvalue().strip().splitlines()[-1])
    dispatches = int(report["counters"]["dispatches"])
    if rc != 0 or launches != (dispatches, 0) or report["utterances"] != CLI_CLIPS:
        fails.append(f"rc {rc}, launches {launches}, dispatches {dispatches}, "
                     f"utterances {report['utterances']}")
    worst = 0.0
    for p in sub:
        name = Path(p).stem + ".npy"
        a, b = np.load(out_dir / name), np.load(tmp / "a" / name)
        worst = max(worst, float("inf") if a.shape != b.shape else
                    rel_err(torch.from_numpy(a), torch.from_numpy(b))[0])
    keys = sorted(np.load(cmvn).files)
    if worst > 1e-6 or keys != ["count", "m2", "mean", "std"]:
        fails.append(f"outputs vs run (a) {worst:.3e}, npz keys {keys}")
    log(f"cli main, --feature mfcc on {CLI_CLIPS} files ({audio_s:.1f} audio-s) in {wall:.3f} s "
        f"= {audio_s / wall:.1f} audio-s/s end to end; rc {rc}; {dispatches} batches, launches "
        f"(K1, K2) {launches}; outputs vs corpus run (a) {worst:.3e} (limit 1e-6); npz {keys}")
    log(f"cli host scopes (s): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                             sorted(report["scopes"].items())))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mfcc_rust_tpu_torch",
                          *paths[:CLI_SUBPROCESS_CLIPS], "--out-dir", str(tmp / "cli_m"),
                          "--quiet"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    try:
        sub_report = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        sub_report = {}
    if res.returncode != 0 or sub_report.get("utterances") != CLI_SUBPROCESS_CLIPS:
        fails.append(f"python -m: rc {res.returncode}, {res.stderr[-2000:]}")
    log(f"python -m mfcc_rust_tpu_torch on {CLI_SUBPROCESS_CLIPS} files: rc {res.returncode} in "
        f"{sub_s:.3f} s (process included); utterances {sub_report.get('utterances')}, "
        f"corpus_frames {sub_report.get('corpus_frames')}")
    if fails:
        raise AssertionError("cli phase: " + "; ".join(fails))
    return {"files": CLI_CLIPS, "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "launches": list(launches), "report": report,
            "rel_vs_run_a": worst, "subprocess": {"rc": res.returncode, "wall_s": sub_s,
                                                  "report": sub_report}}


def profiling_phase(np, torch, P, k1, k2, tmp: Path, measured: dict) -> dict:
    """``utils.profiling`` on the card: one ``api.mfcc`` at the speechpy
    headline inside ``trace`` and ``annotate("mfcc")``, the counts zeroed
    just before (K1 must launch once); the trace written must name the
    annotation and K1's kernel (``mfcc_fft_kernel``).  Prints
    ``chip_spec()`` and ``speed_of_light`` of the two headlines, with the
    kernels' measured audio-s/s (``measured``) as a share of it."""
    from mfcc_rust_tpu_torch.utils import profiling as prof

    audio = np.random.default_rng(7).normal(0.0, 0.1, (BATCH, SECONDS * RATE)).astype(np.float32)
    P.mfcc(audio, RATE)
    torch.cuda.synchronize()
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    with prof.trace(str(tmp / "trace")) as log_dir:
        with prof.annotate("mfcc"):
            P.mfcc(audio, RATE)
            torch.cuda.synchronize()
    launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    files = sorted(Path(log_dir).rglob("*.json"))
    text = "".join(f.read_text() for f in files)
    events = [e for f in files for e in json.loads(f.read_text()).get("traceEvents", [])]
    named = [e for e in events if e.get("name") == "mfcc"]
    kernels = [e for e in events if "mfcc_fft_kernel" in str(e.get("name", ""))]
    k1_us = sum(float(e.get("dur", 0.0)) for e in kernels)
    spec = prof.chip_spec()
    rec = {"launches": list(launches), "trace_files": [f.name for f in files],
           "trace_bytes": len(text), "annotation_events": len(named),
           "k1_kernel_events": len(kernels), "k1_kernel_us": k1_us, "chip_spec": spec,
           "speed_of_light": {}}
    log(f"profiling: trace of api.mfcc({BATCH} x {SECONDS * RATE}) in {log_dir}: "
        f"{len(files)} file(s), {len(text) / 1e6:.3f} MB; events named 'mfcc': {len(named)}; "
        f"mfcc_fft_kernel events: {len(kernels)}, {k1_us:.1f} us on the device; launches "
        f"(K1, K2) {launches}")
    log(f"chip_spec(): {spec}")
    for label, cfg, feature in (("speechpy", P.speechpy_config(RATE), "mfcc"),
                                ("librosa", P.librosa_config(L_RATE), "mel_spectrogram_librosa")):
        sol = prof.speed_of_light(cfg, feature)
        share = measured[label] / sol["speed_of_light_audio_s_per_s"]
        rec["speed_of_light"][label] = dict(sol, measured_audio_s_per_s=measured[label],
                                            share=share)
        log(f"speed_of_light {label} ({sol['lowering']}, {sol['chip']}): compute "
            f"{sol['compute_bound_audio_s_per_s']:.1f}, bandwidth "
            f"{sol['bandwidth_bound_audio_s_per_s']:.1f}, bound "
            f"{sol['speed_of_light_audio_s_per_s']:.1f} audio-s/s; the kernel's measured "
            f"{measured[label]:.1f} audio-s/s is {share:.4f} of it")
    if launches != (1, 0) or not named or not kernels:
        raise AssertionError(f"profiling phase: launches {launches}, 'mfcc' events "
                             f"{len(named)}, mfcc_fft_kernel events {len(kernels)}")
    return rec


# suite lines whose function runs float32 products on cuBLAS, besides a kernel
TF32_LINES = ("librosa_off", "vorbis", "multi", "librosa_mfcc")


def tf32_control(np, torch, bench, seeds: int = 8) -> dict:
    """What each line of :data:`TF32_LINES` reads against its float64 oracle
    (``bench_torch.gate_err`` on two rows of the line's length, N(0, 0.1)
    from each of ``seeds`` seeds) with its products in IEEE FP32, as the
    port runs them, and with every float32 product on cuBLAS in TF32, also
    inside ``config.fp32_matmul``, which asks for IEEE.  The line's gate
    must pass the first on every seed and catch the second on every seed."""
    import contextlib

    @contextlib.contextmanager
    def tf32_products():
        m = torch.backends.cuda.matmul
        cls, prev = type(m), m.fp32_precision
        setattr_ = cls.__setattr__
        cls.__setattr__ = lambda self, k, v: setattr_(
            self, k, "tf32" if k == "fp32_precision" else v)
        m.fp32_precision = "tf32"
        try:
            yield
        finally:
            cls.__setattr__ = setattr_
            m.fp32_precision = prev

    rec = {}
    for key in TF32_LINES:
        cfg, feature, shape, _ = bench.LINES[key]
        fn = bench._call(feature, cfg)
        ieee, tf32 = [], []
        for seed in range(seeds):
            x = np.random.default_rng(seed).normal(0, 0.1, (2, shape[-1])).astype(np.float32)
            xt = torch.from_numpy(x).cuda()
            ieee.append(bench.gate_err(feature, cfg, x, fn(xt)))
            with tf32_products():
                tf32.append(bench.gate_err(feature, cfg, x, fn(xt)))
        limit = bench.LIMIT.get(key, bench.GATE)
        rec[key] = {"ieee": ieee, "tf32": tf32, "limit": limit}
        log(f"bench gate control {key} over {seeds} seeds: IEEE {min(ieee):.3e}-"
            f"{max(ieee):.3e}, TF32 {min(tf32):.3e}-{max(tf32):.3e}, limit {limit:g}")
        assert max(ieee) <= limit < min(tf32), (key, rec[key])
    return rec


def bench_phase(np, torch, k1, k2) -> dict:
    """The port's benchmark, ``bench_torch.py``: its ``main``, ``suite``,
    ``corpus`` and ``scaling`` in this process (timers at a 100 ms
    differential), then ``python3 bench_torch.py`` as a subprocess, whose
    first line must be the headline and whose exit code must be 0.
    ``bench_torch`` raises where a line misses its gate or a kernel did not
    launch once a call; here every line must be JSON with a finite value
    (> 0 for a rate, >= 0 for an A/B error; a ratio may take either sign:
    the host-overhead fraction is negative where the runner's scopes
    overlap), and every line of ``main``, ``suite``, ``corpus`` and the
    one-card ``scaling`` must have printed.  Then :func:`tf32_control`."""
    import bench_torch as bench

    t0 = time.perf_counter()
    lines = (bench.main(0, target_ms=100.0) + bench.suite(0, target_ms=100.0)
             + bench.corpus(seed=0) + bench.scaling(0))
    in_process_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    script_s = time.perf_counter() - t0
    script = [json.loads(s) for s in res.stdout.splitlines() if s.startswith("{")]
    fails = []
    if res.returncode != 0 or not script or script[0]["metric"] != bench.M["headline"]:
        fails.append(f"bench_torch.py: rc {res.returncode}, first line "
                     f"{script[0]['metric'] if script else None}; {res.stderr[-2000:]}")
    for rec in lines + script:
        v = rec["value"]
        if not (math.isfinite(v) and {"rel": v >= 0, "ratio": True}.get(rec["unit"], v > 0)):
            fails.append(f"{rec['metric']}: value {v}")
    names = {**bench.M, **bench.NEW}.values()
    want = {n for n in names if "{}" not in n and not n.startswith("HARNESS")}
    want |= {bench.NEW["wire"].format(w) for w in ("f32 wire", "f16 wire")}
    missing = want - {rec["metric"] for rec in lines}
    if missing:
        fails.append(f"lines not printed: {sorted(missing)}")
    launches = {k: sum(rec.get("launches", {}).get(k, 0) for rec in lines)
                for k in (k1.KERNEL, k2.KERNEL)}
    log(f"bench: {len(lines)} lines in process in {in_process_s:.1f} s, launches {launches}; "
        f"bench_torch.py {len(script)} lines, rc {res.returncode}, in {script_s:.1f} s")
    if fails:
        raise AssertionError("bench phase: " + "; ".join(fails))
    return {"lines": lines, "script": script, "launches": launches,
            "in_process_s": in_process_s, "script_s": script_s,
            "tf32_control": tf32_control(np, torch, bench)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, help="directory for chip_smoke.json")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mfcc_rust_tpu_torch as P
    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch.config import fp32_matmul
    from mfcc_rust_tpu_torch.constants import constant_bundle
    from mfcc_rust_tpu_torch.ops import framing
    from mfcc_rust_tpu_torch.ops.cuda import build
    from mfcc_rust_tpu_torch.ops.cuda import ct_mel as k2
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as k1
    from mfcc_rust_tpu_torch.utils import profiling as prof
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
    from tests.golden import speechpy_ref

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    chip = prof.chip_spec()
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; peaks {chip}")

    # ---------------------------------------------------------------- build --
    t0 = time.perf_counter()
    logs = build.build([k1.KERNEL, k2.KERNEL])
    record["build_s"] = time.perf_counter() - t0
    log(f"build: {k1.KERNEL}, {k2.KERNEL} in {record['build_s']:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "entry function")):
                log(f"  ptxas {name}: {line.strip()}")
    lib = k1._lib()
    lib2 = k2._lib()
    for mc in (P.librosa_config(22050), P.librosa_config(16000, n_fft=512, hop_length=160,
                                                         n_mels=80), P.librosa_config(16000, n_fft=768),
               P.librosa_config(22050, hop_length=333), P.librosa_config(8000, n_fft=256, n_mels=40)):
        _, _, wp, _, km = k2._kernel_constants(mc)
        nnz = wp.size
        g = k2.frames_per_block(mc.fft_points, nnz)
        assert lib2.ct_mel_smem_bytes(mc.fft_points, g, nnz) == \
            k2.smem_bytes(mc.fft_points, g, nnz), "ct_mel smem mirror"
        for warps in (1, 8):
            a = (mc.fft_points, mc.frame_step, km, nnz, mc.num_filters)
            assert lib2.ct_mel_fft_smem_bytes(*a, warps) == k2.fft_smem_bytes(*a, warps), \
                ("ct_mel path-1 smem mirror", a, warps)
    for n in range(2, 4098, 2):
        for hop in (n // 4 or 1, 333, 4000):
            a = (n, hop, n // 2 + 1, n + 2, 128)
            assert lib2.ct_mel_path(*a) == k2.fft_path(*a), ("ct_mel path mirror", a)
    cfg = P.speechpy_config(RATE)
    hop, fl = cfg.frame_step, cfg.frame_size
    for n in range(2, 4098, 2):
        assert lib.mfcc_fft_path(n) == k1.fft_path(n), ("fft path mirror", n)
    for mc in (cfg, cfg.replace(frame_length=0.025), cfg.replace(fft_points=1024),
               cfg.replace(fft_points=400, frame_length=0.025), cfg.replace(fft_points=256),
               cfg.replace(fft_points=2048, fft_impl="matmul")):
        _, wp, _, _, km = k1._kernel_constants(mc)
        for warps in (1, 8):
            a = (mc.fft_points, mc.frame_step, mc.frame_size, km, wp.size, mc.num_filters, warps)
            assert lib.mfcc_fft_smem_bytes(*a) == k1.smem_bytes(*a), ("smem mirror", a)

    # ------------------------------------------------------ main path, once --
    rng = np.random.default_rng(0)
    t_true = SECONDS * RATE
    audio = rng.normal(0.0, 0.1, (BATCH, t_true)).astype(np.float32)
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    t0 = time.perf_counter()
    feats = P.mfcc(audio, RATE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = k1.mfcc_fused.launches
    assert k2.ct_mel.launches == 0, "the speechpy path launched ct_mel"
    n_frames = (t_true - fl) // hop
    assert feats.is_cuda and feats.shape == (BATCH, n_frames, 13), tuple(feats.shape)
    assert bool(torch.isfinite(feats).all()), "non-finite MFCC"
    if launches < 1:
        raise AssertionError("the main path did not launch the speechpy_mfcc kernel")
    log(f"main path: mfcc({BATCH} x {t_true}) -> {tuple(feats.shape)} in {first_s:.3f} s "
        f"(first call); {k1.KERNEL} launches: {launches}")
    t_main = bucket_length(t_true)  # the length the main path hands the kernel
    f_main = (t_main - fl) // hop
    plan = k1.launch_plan(cfg, BATCH, f_main)
    log(f"K1 launch plan at ({BATCH}, {t_main}): {plan}")
    assert plan["path"] == 1, "the headline must take the register-resident FFT"

    # ------------------------------------- K1 against its plain version -----
    x = torch.from_numpy(audio).to(dev)
    x_main = torch.nn.functional.pad(x, (0, t_main - t_true))
    out_k = k1.mfcc_fused(x_main, cfg)
    out_p = k1.mfcc_fused_plain(x_main, cfg)
    torch.cuda.synchronize()
    headline_rel, headline_abs = rel_err(out_k, out_p)
    log(f"K1 vs plain at ({BATCH}, {t_main}): rel {headline_rel:.3e} abs {headline_abs:.3e}")
    assert headline_rel <= REL_TOL, headline_rel
    ref64 = mfcc_float64(np, torch, x_main, cfg)
    k_rel64, _ = rel_err(out_k, ref64)
    p_rel64, _ = rel_err(out_p, ref64)
    c_rel64, _ = rel_err(PF.mfcc(x_main, cfg.replace(pallas="off")), ref64)
    log(f"vs float64 rfft at ({BATCH}, {t_main}): K1 rel {k_rel64:.3e}, plain {p_rel64:.3e}, "
        f"chunk-GEMM path {c_rel64:.3e}")
    assert k_rel64 <= REL_TOL, k_rel64
    assert rel_err(feats, out_k[:, :n_frames])[0] == 0.0, "main path differs from the kernel"

    small = [
        ("25/10 r=3", cfg.replace(frame_length=0.025), (2, 16000)),
        ("10/10 r=1", cfg.replace(frame_length=0.01), (2, 16000)),
        ("dc_elimination=False", cfg.replace(dc_elimination=False), (2, 16000)),
        ("preemphasis 0.97", cfg.replace(preemphasis_cof=0.97), (2, 16000)),
        ("fft 1024", cfg.replace(fft_points=1024), (2, 16000)),
        ("fft 400, path 2", cfg.replace(fft_points=400, frame_length=0.025), (2, 16000)),
        ("fft 256", cfg.replace(fft_points=256, frame_length=0.016), (2, 16000)),
        ("T no multiple of 4 or hop", cfg, (3, 16001)),
        ("batched 3-D", cfg, (2, 3, 8000)),
        ("T < fl", cfg, (300,)),
    ]
    record["small"] = {}
    for name, scfg, shape in small:
        xs = torch.from_numpy(rng.normal(0.0, 0.1, shape).astype(np.float32)).to(dev)
        before = k1.mfcc_fused.launches
        got = PF.mfcc(xs, scfg)
        xp = framing.preemphasis(xs, 1, scfg.preemphasis_cof) if scfg.preemphasis_cof else xs
        ref = k1.mfcc_fused_plain(xp, scfg)
        chunk = PF.mfcc(xs, scfg.replace(pallas="off"))
        torch.cuda.synchronize()
        r1, a1 = rel_err(got, ref)
        r2, _ = rel_err(got, chunk)
        want = 0 if got.shape[-2] == 0 else 1
        assert k1.mfcc_fused.launches - before == want, name
        assert r1 <= REL_TOL and r2 <= REL_TOL, (name, r1, r2)
        if name == "T < fl":
            assert got.shape == (0, 13), tuple(got.shape)
        record["small"][name] = {"rel": r1, "abs": a1, "rel_vs_chunk_gemm": r2,
                                 "shape": list(got.shape), "path": k1.fft_path(scfg.fft_points)}
        log(f"K1 vs plain, {name} {shape}, path {k1.fft_path(scfg.fft_points)}: rel {r1:.3e} "
            f"(vs chunk-GEMM path {r2:.3e}) -> {tuple(got.shape)}")

    # ------------------------------------------- main path vs the oracle ----
    sig = rng.normal(0.0, 0.1, RATE)
    gold = speechpy_ref.mfcc(sig, RATE)
    got = P.mfcc(sig.astype(np.float32), RATE)
    oracle_rel, _ = rel_err(got, torch.from_numpy(gold))
    log(f"api.mfcc vs float64 speechpy oracle: rel {oracle_rel:.3e} (limit {ORACLE_TOL})")
    assert oracle_rel <= ORACLE_TOL, oracle_rel

    # --------------------------------------------------------- autograd -----
    xg = torch.from_numpy(rng.normal(0.0, 0.1, (2, 16000)).astype(np.float32)).to(dev)
    a = xg.clone().requires_grad_(True)
    before = k1.mfcc_fused.launches
    PF.mfcc(a, cfg).sum().backward()
    assert k1.mfcc_fused.launches == before + 1
    b = xg.clone().requires_grad_(True)
    PF.mfcc(b, cfg.replace(pallas="off")).sum().backward()
    grad_rel, _ = rel_err(a.grad, b.grad)
    log(f"grad through the kernel vs the plain path: rel {grad_rel:.3e}")
    assert grad_rel <= REL_TOL, grad_rel

    # ----------------------------------------------------------- timing -----
    flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    flush = lambda: flush_buf.zero_()
    off = cfg.replace(pallas="off")
    fb_t = torch.as_tensor(constant_bundle(cfg)["fbank"].T, dtype=torch.float32, device=dev)
    dct_t = torch.as_tensor(constant_bundle(cfg)["dct"], dtype=torch.float32, device=dev)

    eps = float(np.finfo(np.float32).eps)

    def library():
        """cuFFT yardstick the port never calls: rfft of the unfolded frames,
        |X|^2 / N, the dense filterbank, zero handling, log, the DCT (no
        energy column)."""
        with fp32_matmul():
            spec = torch.fft.rfft(x_main.unfold(-1, fl, hop)[:, :f_main], n=cfg.fft_points)
            mel = spec.abs() ** 2 / cfg.fft_points @ fb_t
            return torch.log(torch.where(mel == 0, eps, mel)) @ dct_t

    # cuFFT's DC bin is a float32 sum, so on the headline it sits as far off
    # float64 as the chunk-GEMM path: held to the float32 gate there
    lib_rel, _ = rel_err(library()[..., 1:], ref64[..., 1:])
    log(f"cuFFT yardstick vs float64 (cepstra 1..): rel {lib_rel:.3e} (limit {ORACLE_TOL})")
    assert lib_rel <= ORACLE_TOL, ("yardstick disagrees", lib_rel)
    runs = {"kernel": lambda: k1.mfcc_fused(x_main, cfg),
            "plain": lambda: k1.mfcc_fused_plain(x_main, cfg),
            "chunk_gemm": lambda: PF.mfcc(x_main, off), "library": library}
    times = {k: [] for k in runs}
    for order in (("plain", "kernel", "chunk_gemm", "library"),
                  ("library", "chunk_gemm", "kernel", "plain")):
        for k in order:
            times[k] += cuda_ms(torch, runs[k], 10, flush)
    med = {k: statistics.median(v) for k, v in times.items()}
    spread = {k: (max(v) - min(v)) / statistics.median(v) for k, v in times.items()}
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        P.mfcc(audio, RATE)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    api_s = statistics.median(host)
    xh = torch.zeros((2, 16000), device=dev)
    oh = torch.empty((2, (16000 - fl) // hop, cfg.num_cepstral), device=dev)
    host_launch = host_us(torch, lambda: k1._launch(lib, xh, cfg, oh))
    log(f"K1 host time of a launch through the binding at (2, 16000): median {host_launch:.2f} us")
    clocks = smi("clocks.sm,power.draw,power.limit,temperature.gpu")

    work = prof.work(cfg, "mfcc", BATCH, t_main)
    assert work["lowering"] == "k1", work["lowering"]
    flops, nbytes = work["flops"], work["bytes"]
    bound_s, bound_by = prof.bound_seconds(flops, nbytes, chip)
    bound_ms = 1e3 * bound_s
    audio_s = BATCH * SECONDS
    log(f"times at ({BATCH}, {t_main}), median of {len(times['kernel'])} (rel spread): "
        + ", ".join(f"{k} {med[k]:.4f} ms ({spread[k]:.3f})" for k in runs))
    log(f"K1 work: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; bound {bound_ms:.4f} ms "
        f"({bound_by}), "
        f"{flops / med['kernel'] / 1e9:.3f} TFLOP/s achieved")
    log(f"audio-s/s: kernel {audio_s / med['kernel'] * 1e3:.1f}, "
        f"chunk-GEMM path {audio_s / med['chunk_gemm'] * 1e3:.1f}, "
        f"cuFFT yardstick {audio_s / med['library'] * 1e3:.1f}, "
        f"api.mfcc from host numpy {audio_s / api_s:.1f} ({api_s * 1e3:.3f} ms)")
    log(f"clocks.sm, power.draw, power.limit, temperature: {clocks}")

    k2_entry, record["librosa"] = librosa_phase(np, torch, P, k1, k2, flush, chip)
    record["suite"] = suite_phase(np, torch, P, k1, k2, flush)
    record["streaming"] = streaming_phase(np, torch, P, k1, k2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name:
        tmp = Path(tmp_name)
        record["corpus"] = corpus_phase(np, torch, P, k1, k2, tmp)
        record["cli"] = cli_phase(np, torch, P, k1, k2, tmp)
        record["export"] = export_phase(np, torch, P, k1, k2, flush, tmp)
        measured = {"speechpy": audio_s / med["kernel"] * 1e3,
                    "librosa": L_BATCH * SECONDS / k2_entry["ms"] * 1e3}
        record["profiling"] = profiling_phase(np, torch, P, k1, k2, tmp, measured)
    record["bench"] = bench_phase(np, torch, k1, k2)
    kernels = [{
        "name": k1.KERNEL, "route": "cuda",
        "source": "mfcc_rust_tpu_torch/ops/cuda/speechpy_mfcc.cu",
        "replaces": "mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py:155",
        "launches": launches, "max_abs_err": headline_abs,
        "ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": med["library"], "path": plan["path"],
        "launches_corpus": record["corpus"]["a"]["launches"][0],
        "launches_bench": record["bench"]["launches"][k1.KERNEL],
    }, dict(k2_entry, launches_corpus=record["corpus"]["a"]["launches"][1],
            launches_bench=record["bench"]["launches"][k2.KERNEL])]
    record.update({
        "main_path": {"shape": [BATCH, t_true], "bucket": t_main, "launches": launches,
                      "first_call_s": first_s, "api_ms": api_s * 1e3, "api_ms_all": [h * 1e3 for h in host]},
        "headline": {"rel": headline_rel, "abs": headline_abs, "library_rel": lib_rel,
                     "rel_float64": {"kernel": k_rel64, "plain": p_rel64, "chunk_gemm": c_rel64}},
        "plan": plan,
        "oracle_rel": oracle_rel, "grad_rel": grad_rel, "host_launch_us": host_launch,
        "times_ms": times, "median_ms": med, "flops": flops, "bytes": nbytes,
        "clocks": clocks, "kernels": kernels,
    })
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
