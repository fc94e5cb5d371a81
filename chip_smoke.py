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
  ``ct_mel``, then ``log_mel_spectrogram`` and ``mfcc_librosa``; K2's entry
  in the kernels line times the main path's launch (the unpadded rows, K2
  staging the centre pad), its ``padded_ms`` the graphed path's launch on
  the padded, bucketed copy;
* speechpy suite: ``resample`` of B=48 x 10 s at 44.1 kHz to 16 kHz, one
  ``extract`` of all five speechpy heads, the vorbis ``mel_spectrogram``,
  then ``cmvnw``, ``cmvn``, ``delta``, ``delta_librosa`` and the derivative
  cube.  These paths run their products on cuBLAS and must launch neither
  K1 nor K2; ``FeatureExtractor`` and the ``transforms`` modules then
  must launch K1 or K2, each with the counts zeroed just before;
* streaming: six 60 s sessions of ``models.StreamingFeatures`` and
  ``models.StreamingExtractor`` (``streaming_phase``), each run eagerly
  and replayed from the session's own CUDA graphs, in turns, each run with
  the counts zeroed just before: the carried chunk-GEMM sessions and the
  streaming STFT must launch no kernel, the recompute sessions K1 or K2
  once per call that emits frames, inside their graphs when replayed.
  Each run is held to its batch function and its float64 oracle, the
  replays to the eager run, every recompute launch to its kernel's plain
  version; ``reset()`` must reproduce a session, two interleaved sessions
  must not share a carry, captures are bounded by the JAX package's
  buckets, and each call is timed (``"streaming"`` in the record; the
  replayed launches go to the kernels line as ``launches_streaming``);
* corpus: 2,703 WAV files written from seed 0 (LibriSpeech dev-clean's
  count, ``bench.py``'s length profile), then ``parallel.CorpusRunner`` on
  a one-rank CUDA mesh (``corpus_phase``), each run once eagerly and once
  replaying the steps' CUDA graphs (``parallel.data.steps``), in turns,
  with the counts zeroed just before each: K1 must launch once a batch
  and K2 never; the outputs are held to the float64 oracle and the
  moments to float64 moments over every file, the replayed runs to the
  eager ones and to a run with K1's plain version; then five heads on a
  float16 wire (no launch), a mixed-rate corpus with ``resample=True``,
  and one step on an NCCL group of world size 1 (captured, replayed,
  bitwise equal to no group).  The first replayed run's K1 and K2 counts
  go to the kernels line as ``launches_corpus``;
* cli: ``cli.main`` in this process on the first 512 of those files
  (``cli_phase``), eager and replayed: K1 once a batch, K2 never, every
  output equal to the corpus run's; then ``python -m mfcc_rust_tpu_torch``
  on 64 files;
* export: ``mfcc``, ``mfe``, the vorbis mel and the librosa mel exported
  at the headline shapes on the card, saved, loaded and held to the eager
  plain path and their float64 oracles, with no kernel launch
  (``export_phase``), and an export made on the CPU loaded onto the card;
* profiling: one ``api.mfcc`` inside ``utils.profiling.trace`` and
  ``annotate`` (``profiling_phase``), whose trace must name the annotation
  and K1's kernel, and the card's ``chip_spec`` and ``speed_of_light``.
  K1's and K2's ``bound_ms`` in the kernels line come from the work model
  of ``utils.profiling`` (``work``, ``bound_seconds``);
* entry: ``entry.entry()``'s forward step on its zero batch and on a seeded
  (8, 16000) batch, K1 once a call, each held to K1's plain version and
  the float64 oracle; ``entry.dryrun_multichip(1)`` in this process, K1
  once a dispatched single-feature ``"mfcc"`` step and runner batch; then
  each ``examples_torch/*.py`` run in this process with ``--device cuda``
  and with ``--device cpu``, their lines compared, each with its own K1
  and K2 launch counts; every launch of the dry run and of the examples
  on the card is held to its kernel's plain version (``entry_phase``).
  Its counts go to the kernels line as ``launches_entry`` and
  ``launches_examples``;
* bench: the port's benchmark, ``bench_torch.py`` (``bench_phase``): its
  headline, suite, corpus and scaling lines in this process, then the
  script on its own, whose first line must be the headline.  Every line
  must pass its gate (``bench_torch`` raises otherwise) and the gates must
  catch the suite's plain products run in TF32 (``tf32_control``); the
  kernels' launches over the lines go to the kernels line as
  ``launches_bench``;
* edge sums: the kernel ``speechpy_edges`` (X_0 and X_{N/2} of each
  speechpy frame in float64, on the chunk-GEMM path of ``mfe``, ``lmfe``,
  ``ssc`` and ``extract``; ``edges_phase``) against its plain version on
  the suite cell's (64, 177,664) bucket, its launches read from replayed
  ``extract`` calls at (64, 160,000) with the count zeroed just before,
  timed against the plain version; its own entry in the kernels line;
* speechpy heads: the kernel ``speechpy_heads`` (the mel, SSC, log-mel,
  MFCC and frame energy of each frame of the chunk-GEMM product in one
  pass, ``extract``'s heads; ``heads_phase``) against its plain version on
  the same bucket, its five errors, its time, bound and share of HBM
  against the plain version's, its launches read from replayed ``extract``
  calls as the edge sums' are; its own entry in the kernels line;
* whisper: Whisper's log-mel front end (``whisper_phase``) at the Whisper
  cell's (64, 480,000), 128 mels: K2's launch plan at n_fft 400 (path 3)
  and its kernel's ptxas lines, K2 alone and the finish kernel
  ``whisper_logmel`` alone, each against its plain version and timed
  beside it with its share of HBM, K2 on path 1 at the librosa cells'
  batches in the same turns, the centre pad and the whole
  ``api.log_mel_spectrogram_whisper`` call timed, its launches (K2 once on
  path 3, staging the centre pad itself, the finish's two kernels, the
  direct path) and its errors against the plain path and the float64
  reference; at the three cells' batches the centred launch that stages
  the reflect pad timed beside the pad and an uncentred launch, equal to
  it bit for bit and within 1e-4 of the plain version; the finish's own
  entry in the kernels line;
* nemo: NeMo FastConformer's log-mel front end (``nemo_phase``) at the NeMo
  cell's 64 ragged rows (lognormal ~6 s, up to 35 s, the lengths on the
  card), 128 mels: the prologue kernel, K2 on path 1 at 512/160/128 and the
  finish kernels alone, each against its plain twin and timed beside it
  with its share of HBM, the new kernels' ptxas lines, the whole
  ``api.log_mel_spectrogram_nemo`` call timed under
  ``set_sync_debug_mode("error")``, its launches (the prologue, K2 once on
  path 1, the finish's two) and its errors against the plain path and the
  float64 reference; the NeMo kernels' own entry in the kernels line;
* compiled: the CUDA-graph replay layer (``utils/graphs.py``,
  ``compiled_phase``): every ``api`` feature entry point and every
  pipeline class and ``FeatureExtractor`` at 48 x 10 s, 16 kHz, or 32 x
  10 s, 22,050 Hz, each call with the counts zeroed just before: one
  capture, then replays (``api.mfcc``, one launch of K1 in place, and
  ``api.mel_spectrogram_librosa``, one launch of K2 in place, neither);
  launches a call equal to the eager call's;
  replays within 1e-6 of eager, and on the K1/K2 paths within 1e-4 of the
  plain kernels and within the float64 oracles; host µs to enqueue and
  device ms a call, eager and replayed; capture ms; the bytes the graphs
  hold; the enqueue profile of the librosa and ``extract`` lines; a
  capture that fails must raise.  The replayed calls' launches go to the
  kernels line as ``launches_compiled``.

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
import contextlib
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
REPLAY_TOL = 1e-6


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
    from mfcc_rust_tpu_torch.ops.framing import center_pad
    from mfcc_rust_tpu_torch.utils import profiling as prof
    from tests.golden import librosa_ref

    dev = torch.device("cuda")
    rec = {}

    def padded(x, c):
        """(the centre-padded, bucketed batch of ``x`` that ``api``'s graph
        computes on, its uncentred config)."""
        write, shape, cu, _ = PA._writer(torch.from_numpy(x), c, True, dev)
        return write(torch.empty(shape, device=dev)), cu

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
    (x_main, cfg_main), count = padded(audio, cfg), PA._librosa_frames(cfg, t_true)
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
    # the main path's own launch: K2 on the unpadded rows, staging the pad
    x_true = torch.from_numpy(audio).to(dev)
    r0 = k2.reflect_launches.launches
    out_s = k2.ct_mel(x_true, cfg)
    assert k2.reflect_launches.launches == r0 + 1, "K2 did not stage the centre pad"
    assert rel_err(mel, out_s.transpose(1, 2))[0] == 0.0, "main path differs from the kernel"
    staged_rel, staged_abs = rel_err(out_s, k2.ct_mel_plain(x_true, cfg))
    log(f"K2 staging the centre pad at {tuple(x_true.shape)} vs plain: rel {staged_rel:.3e} "
        f"abs {staged_abs:.3e}")
    assert staged_rel <= REL_TOL, staged_rel
    del out_s, x_true
    rec["main_path"] = {"shape": [L_BATCH, t_true], "bucket": list(x_main.shape),
                        "frames": out_k.shape[1], "kept": count, "launches": launches,
                        "first_call_s": first_s, "rel": main_rel, "abs": main_abs,
                        "staged_rel": staged_rel, "staged_abs": staged_abs}

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
        (periodic hann, centred in reflect mode as ``c`` says), |X|^2, the
        dense filterbank product."""
        fb = torch.as_tensor(constant_bundle(c)["fbank"], dtype=torch.float32, device=dev)
        win = torch.as_tensor(constant_bundle(c)["window"], dtype=torch.float32, device=dev)

        def run():
            with fp32_matmul():
                st = torch.stft(x, c.fft_points, c.frame_step, window=win, center=c.center,
                                pad_mode="reflect", return_complex=True)
                return torch.matmul(fb, st.abs() ** 2)
        return run

    timing = {}
    for label, c, batch, rate in (("2048/512", cfg, L_BATCH, L_RATE),
                                  ("512/160/80", P.librosa_config(
                                      16000, n_fft=512, hop_length=160, n_mels=80), 48, 16000)):
        au = rng.normal(0.0, 0.1, (batch, SECONDS * rate)).astype(np.float32)
        xu, (xb, cb) = torch.from_numpy(au).to(dev), padded(au, c)
        plan_t = k2.launch_plan(cb, batch, 1 + (xb.shape[1] - c.fft_points) // c.frame_step)
        log(f"K2 launch plan, {label} at {tuple(xb.shape)}: {plan_t}")
        _, _, wp, _, km = k2._kernel_constants(cb)
        a = (c.fft_points, c.frame_step, km, wp.size, c.num_filters)
        assert plan_t["path"] == 1 and plan_t["warps"] == k2.fft_warps(*a), (label, plan_t)
        assert plan_t["smem_bytes"] == k2.fft_smem_bytes(*a, plan_t["warps"]), (label, plan_t)
        # "kernel": the main path's launch on the unpadded rows, K2 staging
        # the centre pad; "padded": the graphed path's, on its padded and
        # bucketed copy
        yard = yardstick(xu, c)
        y_rel, _ = rel_err(yard().transpose(1, 2), k2.ct_mel(xu, c))
        assert y_rel <= REL_TOL, ("yardstick disagrees", label, y_rel)
        runs = {"kernel": lambda: k2.ct_mel(xu, c), "padded": lambda: k2.ct_mel(xb, cb),
                "plain": lambda: k2.ct_mel_plain(xu, c), "yardstick": yard}
        times = {k: [] for k in runs}
        for order in (("plain", "padded", "kernel", "yardstick"),
                      ("yardstick", "kernel", "padded", "plain")):
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
        w = prof.work(c, "mel_spectrogram_librosa", batch, au.shape[1])
        assert w["lowering"] == "k2", w["lowering"]
        # the work model counts the centre-padded rows read; the staged
        # launch reads the unpadded ones, once
        half = c.fft_points // 2
        flops, least = w["flops"], w["least_flops"]
        nbytes = w["bytes"] - 4.0 * batch * 2 * half
        v4_flops, _ = prof.k2_work_stockham(c.replace(center=False), batch,
                                            au.shape[1] + 2 * half)
        bound_s, bound_by = prof.bound_seconds(least, nbytes, chip)
        t_bytes = nbytes / (chip["hbm_gbs"] * 1e9)
        timing[label] = {
            "shape": list(xu.shape), "padded_shape": list(xb.shape), "times_ms": times,
            "median_ms": med,
            "api_ms": statistics.median(host) * 1e3, "api_ms_all": [h * 1e3 for h in host],
            "flops": flops, "bound_flops": least, "bytes": nbytes,
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by, "yardstick_rel": y_rel,
            "plan": plan_t, "v4_flops": v4_flops,
        }
        log(f"K2 times, {label} at {tuple(xu.shape)} (padded: {tuple(xb.shape)}), "
            f"median of {len(times['kernel'])}: "
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
        xh = center_pad(torch.zeros((2, 22050), device=dev), c).contiguous()
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
        "launches": launches, "max_abs_err": rec["main_path"]["staged_abs"],
        "ms": head["median_ms"]["kernel"], "padded_ms": head["median_ms"]["padded"],
        "plain_ms": head["median_ms"]["plain"],
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
    float64 oracles.  These paths run their products on cuBLAS (the edge
    sums of ``extract`` are ``edges_phase``'s): they are driven with K1's
    and K2's launch counts at 0 and must leave them there.  Then ``FeatureExtractor`` and the
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


EDGE_ROWS, EDGE_BUCKET = 64, 177_664  # the suite cell's batch and its bucket
HEADS = ("mfe", "lmfe", "ssc", "mfcc")  # the suite cell's heads


def replayed_extract_launches(torch, P, x, counter, replays: int = 3) -> int:
    """The launches that ``counter`` (a kernel's wrapper, its ``.launches``)
    counts over ``replays`` calls of ``api.extract`` of the suite's heads on
    the card tensor ``x``, replayed from the CUDA graph of the call before
    them, the count set to 0 just before: asserted one a replay.  Every
    replay's heads equal the first call's within ``REPLAY_TOL``."""
    first = P.extract(x, RATE, which=HEADS)  # the capture (or a replay of a held graph)
    counter.launches = 0
    for _ in range(replays):
        out = P.extract(x, RATE, which=HEADS)
    torch.cuda.synchronize()
    launches = counter.launches
    assert launches == replays, (f"replayed extract: {counter.__name__} launches", launches)
    for h in HEADS:
        a, b = (out[h][0], first[h][0]) if h == "mfe" else (out[h], first[h])
        assert rel_err(a, b)[0] <= REPLAY_TOL, f"replayed extract's {h} off its first call"
    log(f"api.extract {HEADS} at {tuple(x.shape)} replayed {replays} times: "
        f"{counter.__name__} launches {launches}")
    return launches


def edges_phase(np, torch, P, PF, flush, chip) -> dict:
    """The speechpy edge sums (``ops/cuda/speechpy_edges.cu``: X_0 and
    X_{N/2} of each frame, summed in float64, written into the chunk-GEMM
    product of ``mfe`` / ``lmfe`` / ``ssc`` / ``extract``).  The wrapper
    against its plain version (``features._exact_edges_plain``) on
    (64, 177,664) card tensors, the suite cell's bucket: its three columns
    within one float32 rounding of the plain ones (each rounds a float64
    sum once), every other column untouched.  Its launches are read from
    ``api.extract`` of the four heads at (64, 160,000), replayed from the
    call's CUDA graph, with the count set to 0 just before: one a replay.
    Kernel and plain version timed with CUDA events after an L2 flush;
    ``bound_ms`` from the work of one call at this shape (a product and
    two adds a sample of each frame; the input read once, three floats a
    frame written).  Returns the kernels line's entry."""
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ke
    from mfcc_rust_tpu_torch.utils import profiling as prof

    dev = torch.device("cuda")
    cfg = P.speechpy_config(RATE)
    fl, hop = cfg.frame_size, cfg.frame_step
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(0.0, 0.1, (EDGE_ROWS, EDGE_BUCKET)).astype(np.float32)).to(dev)
    n = (EDGE_BUCKET - fl) // hop
    c = PF._speechpy_tensors(cfg, dev, torch.float32)
    ch, y = PF._chunk_gemm(x, c["wall"], n, hop)
    want = PF._exact_edges_plain(ch, y.clone(), cfg, n)
    before = ke.edge_sums.launches
    got = ke.edge_sums(x, y.clone(), cfg, n)
    torch.cuda.synchronize()
    assert ke.edge_sums.launches == before + 1, "edge_sums did not count its launch"
    k = PF.constant_bundle(cfg)["fbank_kmax"]
    cols = [0, 2 * k, 2 * k + 1]
    d = (got[..., cols].double() - want[..., cols].double()).abs()
    ulp = want[..., cols].double().abs() * 2.0 ** -23
    assert bool((d <= ulp).all()), ("edge sums off the plain float64 sums", d.max().item())
    rest = [j for j in range(y.shape[-1]) if j not in cols]
    assert torch.equal(got[..., rest], y[..., rest]), "edge_sums wrote outside its columns"
    abs_err = d.max().item()
    rel, _ = rel_err(got[..., cols], want[..., cols])
    log(f"edge sums at ({EDGE_ROWS}, {EDGE_BUCKET}), {n} frames: vs plain float64 sums "
        f"max |d| {abs_err:.3e} (rel {rel:.3e}; each within one float32 rounding)")

    launches = replayed_extract_launches(torch, P, x[:, :RATE * SECONDS].contiguous(),
                                         ke.edge_sums)

    runs = {"kernel": lambda: ke.edge_sums(x, y, cfg, n),
            "plain": lambda: PF._exact_edges_plain(ch, y, cfg, n)}
    times = {name: [] for name in runs}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for name in order:
            times[name] += cuda_ms(torch, runs[name], 10, flush)
    med = {name: statistics.median(v) for name, v in times.items()}
    frames = EDGE_ROWS * n
    flops, nbytes = 3 * fl * frames, 4 * EDGE_ROWS * EDGE_BUCKET + 4 * 3 * frames
    bound_s, bound_by = prof.bound_seconds(flops, nbytes, chip)
    log(f"edge sums: kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms, bound "
        f"{1e3 * bound_s:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    return {"name": ke.KERNEL, "route": "cuda",
            "source": "mfcc_rust_tpu_torch/ops/cuda/speechpy_edges.cu", "replaces": None,
            "launches": launches, "max_abs_err": abs_err, "ms": med["kernel"],
            "plain_ms": med["plain"], "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
            "times_ms": times}


def feed_session(torch, sess, chunks, finalize: bool = False):
    """Feed the host chunks to a streaming session, one ``process()`` call
    at a time, each followed by a device sync so the frames are in hand.
    Returns (rows, or the (mel, energy) pair of ``mfe``; host ms of each
    call; rows each call emitted)."""
    outs, times, rows = [], [], []
    for c in chunks:
        t0 = time.perf_counter()
        o = sess.process(c)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rows.append((o[0] if isinstance(o, tuple) else o).shape[0])
        outs.append(o)
    if finalize:
        outs.append(sess.finalize())
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(p) for p in zip(*outs)), times, rows
    return torch.cat(outs), times, rows


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

    Each session runs in turns: eagerly (``utils.graphs.disabled()``), then
    replayed from its own graph cache (its first calls capture), the same
    replayed session again after ``reset()`` (it must capture nothing), and
    the eager one again after ``reset()``.  Every run passes the gates
    above and launches (K1, K2) as eager does; each is held to the first
    eager run within COMPILED_TOL (bitwise expected: the same pieces through
    the same products), with the same rows a call.  Captures: each key
    once, at most the four carried step sizes, the emission buckets the
    recompute calls used, the extractor's chunk lengths.  S3's and S5's
    every launch is then held to its kernel's plain version
    (:func:`held_to_plain`, eager: a capture cannot read back).  After
    ``reset()`` the replayed session's first 10 s again must give the first
    frames to 1e-6, and two S1 sessions replayed call by call on two
    signals must each equal its own run.  Times: the host clock around each
    call and its sync (median, p99, the median's share of the chunk's
    duration, audio-s/s) for every run, for S1 and S3 the device time of
    one call (CUDA events) eager and replayed in turns, each session's
    capture ms and the bytes its graphs hold (pool, static inputs, state).
    The launches of the replayed runs after reset go to the kernels line
    as ``launches_streaming``.  Any failed check raises after the phase
    has printed every number."""
    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures
    from mfcc_rust_tpu_torch.utils import graphs
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

    def bitwise(a, ref) -> bool:
        pairs = zip(a, ref) if isinstance(a, tuple) else [(a, ref)]
        return all(u.shape == v.shape and bool((u == v).all()) for u, v in pairs)

    def session_cache(sess):
        """The session's own graph cache (the carried front end's, or its own)."""
        inc = getattr(sess, "_inc", None)
        return inc._graphs if inc is not None else sess._graphs

    def drive(sess, chunks, replay: bool, finalize: bool = False):
        """:func:`feed_session` with every launch count zeroed just before,
        eagerly (``graphs.disabled()``) or replayed; adds the (K1, K2)
        launches of the run."""
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        with contextlib.nullcontext() if replay else graphs.disabled():
            out, times, rows = feed_session(torch, sess, chunks, finalize=finalize)
        return out, times, rows, (k1.mfcc_fused.launches, k2.ct_mel.launches)

    def host_times(times, sizes, rate) -> dict:
        dur = np.asarray(sizes[:len(times)], dtype=np.float64) / rate * 1e3
        t = np.asarray(times)
        return {"median_ms": float(np.median(t)), "p99_ms": float(np.percentile(t, 99)),
                "rt_share": float(np.median(t / dur)), "chunk_ms": float(np.median(dur)),
                "audio_s_per_s": sum(sizes[:len(times)]) / rate / (t.sum() / 1e3),
                "times_ms": times}

    def emit_bucket(n: int) -> int:
        return next((b for b in StreamingFeatures.EMIT_BUCKETS if b >= n), n)

    card = smi("name,power.limit")
    rec["card"] = card
    log(f"streaming on {card}")
    launches_replayed = [0, 0]
    for name, make, x, sizes, path, per_call in sessions:
        rate = L_RATE if x is x22 else RATE
        stft = path == "stft"
        chunks = cut(x, sizes)
        ref_batch, ref_oracle = batch[name](), oracle[name]()
        torch.cuda.synchronize()
        eager_sess, replay_sess = make(), make()
        if not stft:
            check((replay_sess._inc is not None) == (path == "incremental"), f"{name}: path")
        cache = session_cache(replay_sess)
        tol = REL_TOL if name == "S1" else STREAM_TOL
        r = {"path": path, "calls": len(chunks), "runs": {}}
        first = first_rows = None
        # in turns: eager, replayed (its first calls capture), the replayed
        # session again after reset() (replays only), the eager one again
        for label, sess, replay in (("eager", eager_sess, False),
                                    ("replayed", replay_sess, True),
                                    ("replayed after reset", replay_sess, True),
                                    ("eager after reset", eager_sess, False)):
            if label.endswith("reset"):
                sess.reset()
            c0, p0 = cache.captures, cache.replays
            out, times, rows, launches = drive(sess, chunks, replay, finalize=stft)
            if first is None:
                first, first_rows = out, rows
            emitting = sum(n > 0 for n in rows)
            want = tuple(emitting * n for n in per_call)
            run = dict(host_times(times, sizes, rate), launches=list(launches),
                       emitting_calls=emitting,
                       rows=list((out[0] if isinstance(out, tuple) else out).shape),
                       rel_batch=rel_pair(out, ref_batch), rel_oracle=rel_pair(out, ref_oracle),
                       rel_eager=rel_pair(out, first), bitwise_eager=bitwise(out, first),
                       captures=cache.captures - c0, replays=cache.replays - p0)
            r["runs"][label] = run
            check(launches == want, f"{name} {label}: launches {launches}, want {want}")
            check(run["rel_batch"] <= tol, f"{name} {label}: vs batch {run['rel_batch']:.3e}")
            check(run["rel_oracle"] <= ORACLE_TOL,
                  f"{name} {label}: vs oracle {run['rel_oracle']:.3e}")
            check(run["rel_eager"] <= COMPILED_TOL,
                  f"{name} {label}: vs eager {run['rel_eager']:.3e}")
            check(rows == first_rows, f"{name} {label}: rows a call differ from eager's")
            if label == "replayed after reset":
                check(run["captures"] == 0, f"{name}: captured again after reset()")
                launches_replayed = [a + b for a, b in zip(launches_replayed, launches)]
            elif not replay:
                check(run["captures"] == run["replays"] == 0, f"{name} {label}: used a graph")
            log(f"streaming {name} ({path}) {label}: {len(chunks)} calls of median "
                f"{run['chunk_ms']:.3f} ms audio -> {tuple(run['rows'])}; launches (K1, K2) "
                f"{launches} over {emitting} emitting calls (want {want}); vs batch "
                f"{run['rel_batch']:.3e} (limit {tol}), vs float64 oracle "
                f"{run['rel_oracle']:.3e} (limit {ORACLE_TOL}), vs eager {run['rel_eager']:.3e} "
                f"bitwise {run['bitwise_eager']} (limit {COMPILED_TOL}); captures "
                f"{run['captures']}, replays {run['replays']}; host ms a call: median "
                f"{run['median_ms']:.4f}, p99 {run['p99_ms']:.4f}; median share of the "
                f"chunk's duration {run['rt_share']:.4f}; {run['audio_s_per_s']:.1f} audio-s/s")
        if name == "S1":
            s1_eager = first
        check(session_cache(eager_sess).captures == 0, f"{name}: the eager session captured")
        # captures: each key once; the carried step at most its four sizes,
        # the recompute path the emission buckets its calls used, the
        # extractor its chunk lengths
        keys = {k[1] for k in cache._graphs}
        bound = {"incremental": 4,
                 "recompute": len({emit_bucket(n) for n in first_rows if n > 0}),
                 "stft": len({c.size for c in chunks})}[path]
        check(cache.captures == len(cache) == len(keys) and cache.captures <= bound,
              f"{name}: captures {cache.captures}, graphs {len(cache)}, bound {bound}")
        st = cache.stats()
        r.update(captures=cache.captures, capture_bound=bound, keys=sorted(map(list, keys)),
                 capture_ms=[1e3 * t for t in st["capture_s"]], graph_bytes=st["bytes"],
                 pool_bytes=st["pool_bytes"], static_bytes=st["static_bytes"],
                 state_bytes=st["state_bytes"])
        log(f"streaming {name} graphs: {cache.captures} captures (bound {bound}) of keys "
            f"{sorted(keys)}; capture ms {[round(t, 3) for t in r['capture_ms']]}; the "
            f"session's graphs hold {st['bytes']} B (pool {st['pool_bytes']}, static inputs "
            f"{st['static_bytes']}, state {st['state_bytes']})")
        # every K1 / K2 launch of the recompute sessions against its plain
        # version (eager: a capture cannot read back; the replays equal
        # the eager rows above)
        if any(per_call):
            with held_to_plain(k1, k2) as readings:
                out_p, _, rows_p = feed_session(torch, make(), chunks)
            worst = worst_reading(readings)
            key = "k1" if per_call[0] else "k2"
            r["held_to_plain"] = worst
            r["rel_held_run"] = rel_pair(out_p, first)
            emitting = sum(n > 0 for n in rows_p)
            check(worst[key][0] == emitting and worst[key][1] <= REL_TOL
                  and r["rel_held_run"] <= COMPILED_TOL,
                  f"{name}: held to plain {worst}, vs eager {r['rel_held_run']:.3e}")
            log(f"streaming {name}: every launch held to its plain version: {worst} "
                f"(launches checked, worst max|d|/max|ref|; limit {REL_TOL}) over {emitting} "
                f"emitting calls; that run vs eager {r['rel_held_run']:.3e}")
        # reset with replay on: the first 10 s again
        replay_sess.reset()
        n10 = int(np.searchsorted(np.cumsum(sizes), 10 * rate, side="right"))
        again, _, _ = feed_session(torch, replay_sess, chunks[:n10])
        head = tuple(o[:a.shape[0]] for o, a in zip(first, again)) \
            if isinstance(first, tuple) else first[:again.shape[0]]
        r["rel_reset"] = rel_pair(again, head)
        check(r["rel_reset"] <= 1e-6 and (again[0] if isinstance(again, tuple) else again)
              .shape[0] > 0, f"{name}: reset {r['rel_reset']:.3e}")
        log(f"streaming {name}: replayed after reset(), the first 10 s vs the first rows "
            f"{r['rel_reset']:.3e} (limit 1e-6)")
        rec[name] = r

    # two S1 sessions replayed call by call on two signals: each equals its
    # own run alone (the first 10 s of S1's eager rows, and a run of its own)
    y16 = np.random.default_rng(7).normal(0.0, 0.1, 10 * RATE).astype(np.float32)
    ca, cb = cut(x16, [160] * 1000), cut(y16, [160] * 1000)
    alone_b, _, _ = feed_session(torch, StreamingFeatures(sp, feature="mfcc"), cb)
    a, b = StreamingFeatures(sp, feature="mfcc"), StreamingFeatures(sp, feature="mfcc")
    outs = ([], [])
    for u, v in zip(ca, cb):
        outs[0].append(a.process(u))
        outs[1].append(b.process(v))
    got_a, got_b = torch.cat(outs[0]), torch.cat(outs[1])
    torch.cuda.synchronize()
    inter = {"rel_a": rel_err(got_a, s1_eager[:got_a.shape[0]])[0],
             "rel_b": rel_err(got_b, alone_b)[0],
             "replays": [session_cache(a).replays, session_cache(b).replays]}
    rec["interleaved"] = inter
    check(max(inter["rel_a"], inter["rel_b"]) <= COMPILED_TOL and min(inter["replays"]) > 0,
          f"interleaved S1 sessions: {inter}")
    log(f"streaming S1, two sessions replayed call by call on two signals: each vs its own "
        f"run {inter['rel_a']:.3e}, {inter['rel_b']:.3e} (limit {COMPILED_TOL}); replays "
        f"{inter['replays']}")

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

    # the launch plans the recompute paths give the kernels at B = 1 (the
    # 16-frame bucket of 10 new frames)
    rec["S3"]["plan"] = k1.launch_plan(sp3, 1, 16)
    rec["S5"]["plan"] = k2.launch_plan(lc5, 1, 16)
    log(f"S3 K1 launch plan at (1, {16 * 160 + 400}): {rec['S3']['plan']}")
    log(f"S5 K2 launch plan at (1, {16 * 160 + 352}): {rec['S5']['plan']}")

    # device time of one call's work, device-resident chunks, in turns
    for name, make, size in (("S1", lambda: StreamingFeatures(sp, feature="mfcc"), 160),
                             ("S3", lambda: StreamingFeatures(sp3, feature="mfcc"), 1600)):
        chunks = [d16[i:i + size] for i in range(0, 220 * size, size)]
        for mode in ("eager", "replayed", "replayed", "eager"):
            with contextlib.nullcontext() if mode == "replayed" else graphs.disabled():
                devt, host = call_device_ms(torch, make(), chunks)
            rec[name].setdefault(f"device_ms_{mode}", []).append(devt)
            rec[name].setdefault(f"enqueue_ms_{mode}", []).append(host)
            log(f"streaming {name} {mode}: device ms of one call's work (CUDA events, median "
                f"of {len(devt)}): {statistics.median(devt):.4f}; host enqueue median "
                f"{statistics.median(host):.4f} ms, max {max(host):.4f} ms (spin ~2.5 ms)")
    # where the host's time goes in one call, eager and replayed (cProfile)
    for name, make, size in (("S1", lambda: StreamingFeatures(sp, feature="mfcc"), 160),
                             ("S3", lambda: StreamingFeatures(sp3, feature="mfcc"), 1600)):
        chunks = [d16[i:i + size] for i in range(0, 220 * size, size)]
        for mode in ("eager", "replayed"):
            with contextlib.nullcontext() if mode == "replayed" else graphs.disabled():
                prof = enqueue_profile(torch, make().process, chunks)
            rec[name][f"profile_{mode}"] = prof
            log(f"streaming {name} {mode}: host us a call under cProfile ({PROFILE_CALLS} "
                f"calls): total {prof['total_us']}, torch ops (builtins) {prof['builtin_us']}, "
                f"Python {prof['python_us']}, CUDAGraph.replay {prof['replay_us']}; most own "
                f"time: {prof['top_own_us']}")
    # the parts of one S1 call, host us (median of 500 back to back; the
    # device waited on after each only where "synced"; the graph launched
    # on the caller's stream, or on the cache's inside its two waits)
    chunks = [d16[i:i + 160] for i in range(0, 600 * 160, 160)]
    sess, eager_sess = (StreamingFeatures(sp, feature="mfcc") for _ in range(2))
    for c in chunks[:20]:
        sess.process(c)
    g = next(iter(session_cache(sess)._graphs.values()))
    pos = [0]

    def call(s):
        pos[0] += 1
        return s.process(chunks[pos[0] % len(chunks)])

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    def on_cache_stream(fn):  # inside the waits that order the cache's stream
        def run():
            with session_cache(sess)._on_cache_stream(g.static.device):
                fn()
        return run

    parts = {"synchronize alone": host_us(torch, torch.cuda.synchronize),
             "graph launch": host_us(torch, g.graph.replay),
             "graph launch, synced": host_us(torch, synced(g.graph.replay)),
             "cache-stream waits alone": host_us(torch, on_cache_stream(lambda: None)),
             "graph launch on the cache stream": host_us(torch, on_cache_stream(g.graph.replay)),
             "process() replayed": host_us(torch, lambda: call(sess)),
             "process() replayed, synced": host_us(torch, synced(lambda: call(sess)))}
    with graphs.disabled():
        parts["process() eager"] = host_us(torch, lambda: call(eager_sess))
        parts["process() eager, synced"] = host_us(torch, synced(lambda: call(eager_sess)))
    rec["S1"]["call_parts_us"] = parts
    log(f"streaming S1, host us of one call's parts (median of 500): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    rec["launches"] = launches_replayed
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
# run (a) after its first (eager) pass: replayed once to capture every key,
# then eager and replayed in turns with every key held
CORPUS_TURNS = (("a_r", True), ("a_e2", False), ("a_r2", True), ("a_r3", True),
                ("a_e3", False))
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


def corpus_run(torch, k1, k2, make, replay: bool) -> tuple:
    """(runner, moments, record) of one corpus run, eager (inside
    ``utils.graphs.disabled()``) or replayed from the steps' graphs
    (``parallel.data.steps``), with the launch counts zeroed just before:
    wall (synchronised), launches, batches, host scopes, and the graphs
    captured in the run (count, recording ms) and held after it (bytes)."""
    from mfcc_rust_tpu_torch.parallel import data as pdata
    from mfcc_rust_tpu_torch.utils import graphs

    steps = pdata.steps
    c0, s0 = steps.captures, steps.capture_seconds
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    t0 = time.perf_counter()
    with contextlib.nullcontext() if replay else graphs.disabled():
        runner = make()
        moments = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    meter, st = runner.meter, steps.stats()
    rec = {"mode": "replayed" if replay else "eager", "wall_s": wall,
           "launches": [k1.mfcc_fused.launches, k2.ct_mel.launches],
           "batches": int(meter.counters["dispatches"]), "scopes": dict(meter.scopes),
           "dispatch_s": meter.scopes.get("dispatch", 0.0),
           "dispatch_busy_s": meter.span_union("dispatch"),
           "captures": steps.captures - c0, "capture_ms": (steps.capture_seconds - s0) * 1e3,
           "graphs": st["graphs"], "bytes_held": st["bytes"], "pool_bytes": st["pool_bytes"],
           "static_bytes": st["static_bytes"]}
    return runner, moments, rec


def run_line(label: str, r: dict) -> str:
    return (f"{label} {r['mode']}: {r['wall_s']:.3f} s, dispatch scope {r['dispatch_s']:.4f} s; "
            f"launches (K1, K2) {tuple(r['launches'])} in {r['batches']} batches; "
            f"captures {r['captures']} ({r['capture_ms']:.1f} ms recording); graphs held "
            f"{r['graphs']}, {r['bytes_held']} B (pool {r['pool_bytes']}, static inputs "
            f"{r['static_bytes']})")


def outputs_against(np, torch, ref_dir: Path, got_dir: Path, names) -> tuple:
    """(files not bitwise equal, worst max|d|/max|ref| of a file, of every
    array of an ``.npz``) of ``got_dir``'s outputs against ``ref_dir``'s."""
    differ, worst = 0, 0.0
    for name in names:
        a, b = np.load(ref_dir / name), np.load(got_dir / name)
        pairs = [(a[k], b[k]) for k in a.files] if name.endswith(".npz") else [(a, b)]
        for x, y in pairs:
            if x.shape != y.shape or x.dtype != y.dtype:
                return len(names), float("inf")
            if not np.array_equal(x, y):
                differ += 1
                worst = max(worst, rel_err(torch.from_numpy(y.astype(np.float64)),
                                           torch.from_numpy(x.astype(np.float64)))[0])
    return differ, worst


def moments_rel(np, got, ref) -> float:
    """Worst max|d|/max|ref| over the count, mean and m2 of two moments."""
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                     / max(np.abs(np.asarray(b, np.float64)).max(), 1e-300))
               for a, b in zip(got, ref))


def staged_writer(np, torch, shipped):
    """A variant of ``parallel.data._write`` for the step's A/B: a host
    array goes into the static input through one pinned staging buffer per
    (dtype, device), reused, grown when too small, and ordered by an event:
    the host waits for the last copy out of it before it writes it again.
    The shipped fill pins a fresh copy each call (``pin_memory()``, from
    PyTorch's caching host allocator); both copy the samples once on the
    host.  Tensors and 2-D blocks take the shipped path."""
    bufs = {}

    def write(dst, v):
        if isinstance(v, torch.Tensor) or not dst.is_cuda or dst.ndim != 1:
            return shipped(dst, v)
        m = min(v.shape[0], dst.shape[0])
        buf, done = bufs.get((dst.dtype, dst.device), (None, None))
        if buf is None or buf.shape[0] < m:
            buf, done = torch.empty(m, dtype=dst.dtype, pin_memory=True), torch.cuda.Event()
            bufs[(dst.dtype, dst.device)] = (buf, done)
        else:
            done.synchronize()
        np.copyto(buf.numpy()[:m], v[:m])
        dst[:m].copy_(buf[:m], non_blocking=True)
        done.record()

    return write


def corpus_phase(np, torch, P, k1, k2, tmp: Path) -> dict:
    """The corpus path at LibriSpeech dev-clean's size, on one card.

    A corpus of 2,703 WAV files (``bench.py``'s length profile, seed 0:
    durations clip(lognormal(ln 6 s, 0.6), 1, 35) at 16 kHz, samples
    N(0, 0.1)) is written with the port's native ``write_wav`` into
    ``tmp/wav`` (run (a)'s eager run writes its outputs to ``tmp/a``: the
    "cli" phase reads both).  Each run goes once eagerly
    (``utils.graphs.disabled()``) and once replayed from the steps' CUDA
    graphs (``parallel.data.steps``), in turns, with the launch counts
    zeroed just before each (:func:`corpus_run`); the replayed outputs and
    moments must equal the eager ones (bitwise, or within REPLAY_TOL of
    max|ref|: the same ops on the same values, only the static flat buffer
    longer than the batch's, whose tail is masked).

    (a) ``CorpusRunner`` (batch 32, packed f32 outputs, the runner's
        defaults) on a one-rank CUDA mesh, ``"mfcc"``: eager, replayed
        (capturing each (batch, bucket) key), then eager and replayed in
        turns (CORPUS_TURNS; every key held: no capture); then once with
        K1's plain version in its place (``bench_torch._plain_twins``).
        (b) and (c) run eager, replayed (capturing), replayed (every key
        held), eager again.  K1 once a batch in
        each run but the plain one.  Gates on the eager run: every output
        has ``frame_counts_host`` rows x 13; 64 seeded utterances within
        ORACLE_TOL of the float64 speechpy oracle; the returned moments
        equal float64 two-pass moments over every written file (count
        exact, mean and std at rtol 1e-5, atol 1e-6).  Every replayed
        output within REL_TOL of the plain run's.  One step at B = 32 x
        the most frequent bucket, eager and replayed, with the flat buffer
        from the host and device-resident: device ms (CUDA events after a
        spin, median of 20) and host ms to enqueue, K1's own time at that
        shape, and the replayed step with a reused pinned staging buffer
        (:func:`staged_writer`); the replayed step held to the eager one (REPLAY_TOL), to K1's
        plain version and to the ``pallas="off"`` lowering (the chunk-GEMM,
        which sums the DC bin in float32, within REL_TOL on this step); the
        host profile of the device-resident step, eager and replayed
        (:func:`enqueue_profile`); the host µs of ``data._pack_leaves`` on
        that step's fetch group.
    (b) the five speechpy heads of the first 512 clips, float16 wire: no
        kernel launches; each head within 2^-11 |x| (the wire) + 2^-24 + 1e-5
        of the head's max (two float32 product shapes) of ``api.extract``
        of the clip on the card, plus, for the log heads, the DC-bin term
        of :func:`dc_term`.
    (c) 256 clips, a third each at 16,000, 22,050 and 44,100 Hz,
        ``resample=True``: each output within ORACLE_TOL of
        ``api.resample`` then ``api.mfcc`` of the clip on the card.
    (d) one step over a mesh on an NCCL group of world size 1 (its
        all-reduces inside the capture), its capture and a replay, equals
        the no-group mesh's eager step bitwise.

    One H100 cannot hold two NCCL ranks: multi-rank meshes are proven on
    the CPU under gloo (tests/test_torch_port_parallel.py).  Any failed gate
    raises after the phase has printed its numbers."""
    import torch.distributed as dist

    import bench_torch
    from mfcc_rust_tpu_torch import runtime
    from mfcc_rust_tpu_torch.parallel import data as pdata
    from mfcc_rust_tpu_torch.parallel import (extraction_step_packed, fetch_outputs,
                                              frame_counts_host, make_mesh, pack_signals)
    from mfcc_rust_tpu_torch.parallel.mesh import init_process_group
    from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
    from mfcc_rust_tpu_torch.runtime import read_wav, write_wav
    from mfcc_rust_tpu_torch.utils import graphs
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
    from tests.golden import speechpy_ref

    fails, rec = [], {"card": smi("name,power.limit")}

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
        f"{disk / 1e6:.1f} MB of PCM16 WAV, written in {rec['corpus']['build_s']:.2f} s; "
        f"card {rec['card']}")
    names = [f"utt{i:05d}.npy" for i in range(CORPUS_CLIPS)]

    def replay_gate(tag: str, r: dict, ref: dict, ref_dir: Path, got_dir: Path, files,
                    moments=None, ref_moments=None):
        differ, worst = outputs_against(np, torch, ref_dir, got_dir, files)
        r["files_not_bitwise"], r["worst_rel_vs_eager"] = differ, worst
        check(worst <= REPLAY_TOL, f"{tag}: replayed vs eager {worst:.3e} ({differ} files)")
        check(r["launches"] == ref["launches"],
              f"{tag}: replayed launches {r['launches']} != eager {ref['launches']}")
        if moments is not None:
            r["moments_rel_vs_eager"] = max(
                moments_rel(np, a, b) for a, b in
                zip(moments.values() if isinstance(moments, dict) else [moments],
                    ref_moments.values() if isinstance(ref_moments, dict) else [ref_moments]))
            check(r["moments_rel_vs_eager"] <= REPLAY_TOL,
                  f"{tag}: moments vs eager {r['moments_rel_vs_eager']:.3e}")
        log(run_line(f"corpus {tag}", r) + f"; outputs vs eager: {differ} of {len(files)} files "
            f"not bitwise, worst {worst:.3e} (limit {REPLAY_TOL})")

    def after_eager(tag: str, out: str, make, ref: dict, ref_moments, files) -> dict:
        """After a run's eager pass: replayed (capturing), replayed (every
        key held), eager again; each replayed pass held to the eager one."""
        turns = {}
        for suffix, replay in (("_r", True), ("_r2", True), ("_e2", False)):
            _, mom, r = corpus_run(torch, k1, k2, make(out + suffix), replay)
            replay_gate(f"{tag} {out}{suffix}", r, ref, tmp / out, tmp / (out + suffix), files,
                        mom, ref_moments)
            turns[out + suffix] = r
        check(turns[out + "_r2"]["captures"] == 0,
              f"{tag}: {turns[out + '_r2']['captures']} captures with every key held")
        return turns

    # ----------------------------------------------------------- (a) --
    mesh = make_mesh()
    pdata.steps.clear()

    def runner_a(out: str, **kw):
        return lambda: CorpusRunner(paths, cfg, mesh, batch_size=32, out_dir=str(tmp / out),
                                    checkpoint_path=str(tmp / f"{out}.npz"), **kw)

    runner, moments, a = corpus_run(torch, k1, k2, runner_a("a"), replay=False)
    meter = runner.meter
    batches = a["batches"]
    a["audio_s_per_s"] = audio_s / a["wall_s"]
    a["counters"] = dict(meter.counters)
    a["fetch_busy_s"] = meter.span_union("fetch")
    check(tuple(a["launches"]) == (batches, 0), f"(a): launches {a['launches']}, want "
                                                f"({batches}, 0)")
    counts = frame_counts_host(lengths, cfg, "mfcc")
    outs, bad = [], 0
    for i in range(CORPUS_CLIPS):
        f = np.load(tmp / "a" / names[i])
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
    log(f"corpus (a) mfcc: {CORPUS_CLIPS} files in {a['wall_s']:.3f} s = "
        f"{a['audio_s_per_s']:.1f} audio-s/s end to end (eager); {batches} batches, K1 launches "
        f"{a['launches'][0]}, K2 {a['launches'][1]}; {a['frames']} frames")
    log(f"corpus (a) scopes (host s, eager): {sc}; fetch-span union {a['fetch_busy_s']:.4f} s, "
        f"dispatch-span union {a['dispatch_busy_s']:.4f} s")
    log(f"corpus (a) bytes: H2D {meter.counters.get('h2d_bytes', 0) / 1e6:.3f} MB, D2H "
        f"{meter.counters.get('d2h_bytes', 0) / 1e6:.3f} MB; fetch groups "
        f"{int(meter.counters.get('fetch_groups', 0))}")
    log(f"corpus (a) gates: moments vs float64 over every file: count "
        f"{int(moments.count)}, max|d mean| {a['mean_err']:.3e}, max|d std| "
        f"{a['std_err']:.3e} (rtol 1e-5, atol 1e-6); {CORPUS_ORACLE_UTTS} utterances vs "
        f"float64 oracle {worst:.3e} (limit {ORACLE_TOL})")
    log(run_line("corpus (a)", a))
    # replayed, capturing every key; then in turns, every key held
    turns = {}
    for out, replay in CORPUS_TURNS:
        _, mom, r = corpus_run(torch, k1, k2, runner_a(out), replay)
        replay_gate(f"(a) {out}", r, a, tmp / "a", tmp / out, names, mom, moments)
        turns[out] = r
    held = [r["captures"] for k, r in turns.items() if k != "a_r" and r["mode"] == "replayed"]
    check(turns["a_r"]["captures"] > 0 and not any(held),
          f"(a): captures {turns['a_r']['captures']}, then {held}")
    steady = {m: [r for k, r in turns.items() if k != "a_r" and r["mode"] == m]
              for m in ("eager", "replayed")}
    log("corpus (a) in turns after the first two runs (eager / replayed): wall s "
        + " / ".join(", ".join(f"{r['wall_s']:.3f}" for r in steady[m]) for m in steady)
        + "; dispatch scope s " + " / ".join(
            ", ".join(f"{r['dispatch_s']:.4f}" for r in steady[m]) for m in steady))
    with bench_torch._plain_twins():
        _, _, plain = corpus_run(torch, k1, k2, runner_a("a_p"), replay=False)
    _, plain["worst_rel_replayed_vs_plain"] = outputs_against(np, torch, tmp / "a_p",
                                                              tmp / "a_r", names)
    check(tuple(plain["launches"]) == (0, 0), f"(a) plain: launches {plain['launches']}")
    check(plain["worst_rel_replayed_vs_plain"] <= REL_TOL,
          f"(a): replayed vs K1's plain version {plain['worst_rel_replayed_vs_plain']:.3e}")
    log(f"corpus (a) with K1's plain version (eager): {plain['wall_s']:.3f} s, launches (K1, "
        f"K2) {tuple(plain['launches'])}; every replayed output vs it: worst "
        f"{plain['worst_rel_replayed_vs_plain']:.3e} (limit {REL_TOL}, a file's max|d|/max|ref|)")
    a["turns"], a["plain"] = turns, plain

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

    def step(f, c=cfg):
        return lambda: extraction_step_packed(f, offs, lens, bucket, c, mesh, "mfcc",
                                              frame_counts=fc)

    def eagerly(fn):
        def call():
            with graphs.disabled():
                return fn()
        return call

    def staged(fn):
        def call():
            saved, pdata._write = pdata._write, staged_write
            try:
                return fn()
            finally:
                pdata._write = saved
        return call

    staged_write = staged_writer(np, torch, pdata._write)
    runs = {"step": eagerly(step(flat)), "step_resident": eagerly(step(flat_d)),
            "step_replayed": step(flat), "step_resident_replayed": step(flat_d),
            "step_replayed_staged": staged(step(flat)),
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
    host = {k: statistics.median(v) for k, v in enqueue.items()}
    k0 = k1.mfcc_fused.launches
    got = runs["step_replayed"]()
    ref = runs["step"]()
    k1_step = k1.mfcc_fused.launches - k0
    with bench_torch._plain_twins():
        plain_ref = step(flat)()
    with graphs.disabled():
        off_ref = step(flat, cfg.replace(pallas="off"))()
    leaf = lambda out: torch.utils._pytree.tree_leaves(out)
    vs = {name: max(rel_err(u, v)[0] for u, v in zip(leaf(got), leaf(r)))
          for name, r in (("eager", ref), ("plain", plain_ref), ("pallas_off", off_ref))}
    vs["bitwise_eager"] = all(torch.equal(u, v) for u, v in zip(leaf(got), leaf(ref)))
    check(k1_step == 2, f"(a) step: K1 launches {k1_step} for one replayed and one eager step")
    check(vs["eager"] <= REPLAY_TOL, f"(a) step: replayed vs eager {vs['eager']:.3e}")
    check(vs["plain"] <= REL_TOL, f"(a) step: replayed vs K1's plain version {vs['plain']:.3e}")
    check(vs["pallas_off"] <= REL_TOL, f"(a) step: replayed vs pallas='off' {vs['pallas_off']:.3e}")
    # _pack_leaves: the runner's one concatenation a fetch group (1 step)
    group = leaf([got])
    pack_us = []
    for _ in range(200):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        pdata._pack_leaves(group)
        pack_us.append((time.perf_counter() - h0) * 1e6)
    fetch_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        fetch_outputs([got])
        fetch_ms.append((time.perf_counter() - h0) * 1e3)
    # where the host's time goes in one step, eager and replayed (cProfile)
    prof = {k: enqueue_profile(torch, lambda _, fn=runs[k]: fn(), [None])
            for k in ("step_resident", "step_resident_replayed")}
    for k, pr in prof.items():
        log(f"corpus (a) host profile of {k} (us a call over {PROFILE_CALLS}): total "
            f"{pr['total_us']}, torch ops (builtins) {pr['builtin_us']}, Python "
            f"{pr['python_us']}, CUDAGraph.replay {pr['replay_us']}; most own time: "
            f"{pr['top_own_us']}")
    a["step"] = {"bucket": bucket, "clips_in_bucket": keys.count(key), "profile": prof,
                 "audio_s": step_audio, "median_ms": med, "times_ms": times,
                 "enqueue_ms": enqueue, "enqueue_median_ms": host, "vs": vs,
                 "pack_leaves_us": pack_us, "pack_leaves_median_us": statistics.median(pack_us),
                 "fetch_ms": fetch_ms, "fetch_median_ms": statistics.median(fetch_ms),
                 "group_leaves": len(group)}
    log(f"corpus (a) one step at (32, {bucket}) (the most frequent bucket, "
        f"{keys.count(key)} clips; {step_audio:.1f} audio-s), CUDA events after a "
        f"~15 ms spin, median of 20 (device ms / host ms to enqueue): " + ", ".join(
            f"{k} {med[k]:.4f} / {host[k]:.4f}" for k in runs)
        + f"; K1 alone {med['k1']:.4f} ms; {step_audio / med['step_replayed'] * 1e3:.1f} "
        f"audio-s/s on the device replayed; card {rec['card']}")
    log(f"corpus (a) step replayed vs eager {vs['eager']:.3e} (bitwise {vs['bitwise_eager']}; "
        f"limit {REPLAY_TOL}), vs K1's plain version {vs['plain']:.3e} (limit {REL_TOL}), vs the "
        f"pallas='off' chunk-GEMM {vs['pallas_off']:.3e} (limit {REL_TOL}); K1 "
        f"launches {k1_step} for one replayed and one eager step")
    log(f"corpus (a) fetch group of one step ({len(group)} leaves): _pack_leaves host us median "
        f"{a['step']['pack_leaves_median_us']:.1f} (max {max(pack_us):.1f}); fetch_outputs "
        f"{a['step']['fetch_median_ms']:.4f} ms a group (synchronised)")
    rec["a"] = a

    # ----------------------------------------------------------- (b) --
    sub = paths[:CORPUS_B_CLIPS]
    runner_b = lambda out: lambda: CorpusRunner(sub, cfg, mesh, feature=SUITE_HEADS,
                                                batch_size=32, out_dir=str(tmp / out),
                                                wire_dtype="float16")
    _, mom_b, b = corpus_run(torch, k1, k2, runner_b("b"), replay=False)
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
    log(f"corpus (b) five heads, float16 wire, {CORPUS_B_CLIPS} clips in {b['wall_s']:.3f} s "
        f"(eager); launches (K1, K2) {tuple(b['launches'])}; max |d| / bound vs api.extract: "
        + ", ".join(f"{h} {r:.3f}" for h, r in ratio.items())
        + f" (limit 1); rows of mfcc/lmfe past the bound without the DC term: {dc_rows}")
    log(run_line("corpus (b)", b))
    b["turns"] = after_eager("(b)", "b", runner_b, b, mom_b,
                             [f"utt{i:05d}.npz" for i in range(len(sub))])
    rec["b"] = b

    # ----------------------------------------------------------- (c) --
    rng_c = np.random.default_rng(2)
    rates = [CORPUS_C_RATES[i % 3] for i in range(CORPUS_C_CLIPS)]
    lc = [int(n * r / RATE) for n, r in
          zip(corpus_lengths(np, rng_c, CORPUS_C_CLIPS, RATE), rates)]
    cpaths = write_corpus(np, write_wav, rng_c, lc, rates, tmp / "wav_c")
    runner_c = lambda out: lambda: CorpusRunner(cpaths, cfg, mesh, batch_size=32,
                                                out_dir=str(tmp / out), resample=True)
    _, mom_c, c = corpus_run(torch, k1, k2, runner_c("c"), replay=False)
    c["dispatches"] = c["batches"]
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
        f"{c['wall_s']:.3f} s (eager); {c['dispatches']} dispatches, launches (K1, K2) "
        f"{tuple(c['launches'])}; vs api.resample + api.mfcc {worst:.3e} "
        f"(limit {ORACLE_TOL})")
    c["turns"] = after_eager("(c)", "c", runner_c, c, mom_c,
                             [f"utt{i:05d}.npy" for i in range(CORPUS_C_CLIPS)])
    rec["c"] = c

    # ----------------------------------------------------------- (d) --
    with graphs.disabled():
        ref = extraction_step_packed(flat, offs, lens, bucket, cfg, make_mesh(), "mfcc",
                                     frame_counts=fc)
    rank_world = init_process_group(f"file://{tmp / 'pg'}", world_size=1, rank=0,
                                    backend="nccl", timeout=60.0)
    c0, r0 = pdata.steps.captures, pdata.steps.replays
    try:
        gmesh = make_mesh()
        gots = [extraction_step_packed(flat, offs, lens, bucket, cfg, gmesh, "mfcc",
                                       frame_counts=fc) for _ in range(3)]
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for got in gots for u, v in zip(leaf(got), leaf(ref)))
        grouped = gmesh.group is not None
        graphed = (pdata.steps.captures - c0, pdata.steps.replays - r0)
    finally:
        dist.destroy_process_group()
        pdata.steps.clear()  # no graph outlives the group it calls
    rec["d"] = {"rank_world": list(rank_world), "bitwise": same,
                "captures_replays": list(graphed)}
    check(same and grouped and rank_world == (0, 1) and graphed == (1, 2),
          f"(d): NCCL world 1 != no-group mesh, or (captures, replays) {graphed}")
    log(f"corpus (d) NCCL group of world 1 (rank, world) {rank_world}: three steps at "
        f"(32, {bucket}) through one graph ((captures, replays) {graphed}), each bitwise equal "
        f"to the no-group mesh's eager step: {same}")
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
    the first 512 with ``--feature mfcc --out-dir --cmvn-out --quiet``,
    in turns eagerly (``utils.graphs.disabled()``), replaying the steps'
    graphs (capturing, then with every key held: no capture) and eagerly
    again, the launch counts zeroed just before each.  K1
    must launch once a dispatched batch (the report's
    ``counters.dispatches``; its ``batches`` counts every metered scope, as
    the JAX package's does) and K2 never; each ``.npy`` must equal run
    (a)'s output for that file (``tmp/a``) within 1e-6 (max|d|/max|ref|),
    the npz must hold count, mean, m2 and std, and the report must count
    512 utterances.  Then ``python -m mfcc_rust_tpu_torch`` in a subprocess
    on the first 64 files must exit 0 with a last line that parses and
    counts 64 utterances.  Prints the end-to-end audio-s/s (host clock
    around ``main``), the host scopes and the graphs captured."""
    import contextlib
    import io

    from mfcc_rust_tpu_torch import cli
    from mfcc_rust_tpu_torch.parallel import data as pdata
    from mfcc_rust_tpu_torch.runtime import read_wav
    from mfcc_rust_tpu_torch.utils import graphs

    paths = sorted(str(p) for p in (tmp / "wav").glob("utt*.wav"))
    sub = paths[:CLI_CLIPS]
    audio_s = sum(read_wav(p)[0].shape[0] for p in sub) / RATE
    fails, runs = [], {}
    for mode in ("eager", "replayed", "replayed_held", "eager_again"):
        out_dir, cmvn = tmp / f"cli_{mode}", tmp / f"cli_cmvn_{mode}.npz"
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        c0, s0 = pdata.steps.captures, pdata.steps.capture_seconds
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), \
                (graphs.disabled() if mode.startswith("eager") else contextlib.nullcontext()):
            rc = cli.main([*sub, "--feature", "mfcc", "--out-dir", str(out_dir),
                           "--cmvn-out", str(cmvn), "--quiet"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
        report = json.loads(stdout.getvalue().strip().splitlines()[-1])
        dispatches = int(report["counters"]["dispatches"])
        if rc != 0 or launches != (dispatches, 0) or report["utterances"] != CLI_CLIPS:
            fails.append(f"{mode}: rc {rc}, launches {launches}, dispatches {dispatches}, "
                         f"utterances {report['utterances']}")
        worst = 0.0
        for p in sub:
            name = Path(p).stem + ".npy"
            a, b = np.load(out_dir / name), np.load(tmp / "a" / name)
            worst = max(worst, float("inf") if a.shape != b.shape else
                        rel_err(torch.from_numpy(a), torch.from_numpy(b))[0])
        keys = sorted(np.load(cmvn).files)
        if worst > 1e-6 or keys != ["count", "m2", "mean", "std"]:
            fails.append(f"{mode}: outputs vs run (a) {worst:.3e}, npz keys {keys}")
        runs[mode] = {"wall_s": wall, "audio_s_per_s": audio_s / wall, "launches": list(launches),
                      "report": report, "rel_vs_run_a": worst,
                      "captures": pdata.steps.captures - c0,
                      "capture_ms": (pdata.steps.capture_seconds - s0) * 1e3}
        log(f"cli main {mode}, --feature mfcc on {CLI_CLIPS} files ({audio_s:.1f} audio-s) in "
            f"{wall:.3f} s = {audio_s / wall:.1f} audio-s/s end to end; rc {rc}; {dispatches} "
            f"batches, launches (K1, K2) {launches}; captures {runs[mode]['captures']} "
            f"({runs[mode]['capture_ms']:.1f} ms recording); outputs vs corpus run (a) "
            f"{worst:.3e} (limit 1e-6); npz {keys}")
        log(f"cli host scopes (s, {mode}): " + ", ".join(f"{k} {v:.4f}" for k, v in
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
    if runs["replayed_held"]["captures"]:
        fails.append(f"{runs['replayed_held']['captures']} captures with every key held")
    if fails:
        raise AssertionError("cli phase: " + "; ".join(fails))
    return {"files": CLI_CLIPS, "audio_s": audio_s, **runs["replayed"], "runs": runs,
            "subprocess": {"rc": res.returncode, "wall_s": sub_s, "report": sub_report}}


def profiling_phase(np, torch, P, k1, k2, tmp: Path, measured: dict) -> dict:
    """``utils.profiling`` on the card: one ``api.mfcc`` at the speechpy
    headline inside ``trace`` and ``annotate("mfcc")``, the counts zeroed
    just before (K1 must launch once, in place: no capture before or
    inside); the trace written must name the annotation, the ``api.direct``
    span and K1's kernel (``mfcc_fft_kernel``).  Prints
    ``chip_spec()`` and ``speed_of_light`` of the two headlines, with the
    kernels' measured audio-s/s (``measured``) as a share of it."""
    from mfcc_rust_tpu_torch.utils import profiling as prof

    from mfcc_rust_tpu_torch.utils import graphs

    audio = np.random.default_rng(7).normal(0.0, 0.1, (BATCH, SECONDS * RATE)).astype(np.float32)
    c0 = graphs.cache.captures
    P.mfcc(audio, RATE)
    torch.cuda.synchronize()
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    with prof.trace(str(tmp / "trace")) as log_dir:
        with prof.annotate("mfcc"):
            P.mfcc(audio, RATE)
            torch.cuda.synchronize()
    launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    captures = graphs.cache.captures - c0
    files = sorted(Path(log_dir).rglob("*.json"))
    text = "".join(f.read_text() for f in files)
    events = [e for f in files for e in json.loads(f.read_text()).get("traceEvents", [])]
    named = [e for e in events if e.get("name") == "mfcc"]
    direct = [e for e in events if e.get("name") == "api.direct"]
    kernels = [e for e in events if "mfcc_fft_kernel" in str(e.get("name", ""))]
    k1_us = sum(float(e.get("dur", 0.0)) for e in kernels)
    spec = prof.chip_spec()
    rec = {"launches": list(launches), "captures": captures,
           "trace_files": [f.name for f in files], "trace_bytes": len(text),
           "annotation_events": len(named), "direct_span_events": len(direct),
           "k1_kernel_events": len(kernels), "k1_kernel_us": k1_us, "chip_spec": spec,
           "speed_of_light": {}}
    log(f"profiling: trace of api.mfcc({BATCH} x {SECONDS * RATE}) in {log_dir}: "
        f"{len(files)} file(s), {len(text) / 1e6:.3f} MB; events named 'mfcc': {len(named)}, "
        f"'api.direct': {len(direct)}; mfcc_fft_kernel events: {len(kernels)}, {k1_us:.1f} us "
        f"on the device; launches (K1, K2) {launches}; captures {captures}")
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
    if launches != (1, 0) or captures or not named or not direct or not kernels:
        raise AssertionError(f"profiling phase: launches {launches}, captures {captures}, "
                             f"'mfcc' events {len(named)}, 'api.direct' events {len(direct)}, "
                             f"mfcc_fft_kernel events {len(kernels)}")
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


EXAMPLES = ("basic_features", "corpus_extraction", "export_inference", "streaming",
            "torch_pipeline")
# (K1, K2) launches of one run of each example on the card: basic_features'
# mfcc, its librosa mel and two librosa MFCCs; the corpus example's five
# "mfcc" batches (its resume and its four-head run launch none); the
# export example's library call that its artifact is held to (the export,
# its load and its graph run the plain lowering); no kernel in the
# streaming session; torch_pipeline's
# functional mfcc, eight MFCC dataset items and one MelSpectrogram batch
EXAMPLE_LAUNCHES = {"basic_features": (1, 3), "corpus_extraction": (5, 0),
                    "export_inference": (1, 0), "streaming": (0, 0), "torch_pipeline": (1, 9)}
# lines whose numbers differ between devices or packages: held to 1e-4 of
# max(1, max|ref|); lines that differ from run to run: their label alone
EXAMPLE_NUMERIC = ("cmvn mean ~0", "max difference", "corpus mean[:4]")
EXAMPLE_RUN_TO_RUN = ("throughput", "features in", "exported")
# the dry run's single-feature "mfcc" steps that reach K1 on the card
# (padded, packed int16, packed outputs at 20/10, 25/10), each one launch
DRYRUN_K1_STEPS = ("padded", "packed", "packed_outputs", "25/10")


def run_example(name: str, device: str) -> tuple:
    """(seconds, printed lines) of ``examples_torch/<name>.py --device
    <device>`` run in this process."""
    import io
    import runpy

    path = ROOT / "examples_torch" / f"{name}.py"
    argv, sys.argv = sys.argv, [str(path), "--device", device]
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    return time.perf_counter() - t0, out.getvalue().splitlines()


def example_lines_differ(lines: list, ref_lines: list) -> list:
    """The (line, reference line) pairs of an example's run that do not
    match a reference run: the same example on another device, or the JAX
    package's example.  Lines must be equal text, except numeric lines
    (:data:`EXAMPLE_NUMERIC`, to 1e-4 of max(1, max|ref|)), run-to-run
    lines (their label), the corpus runner's batch lines (equal without
    their throughput) and the export's graph line (a product op and no
    FFT: the port's names ``matmul`` in its graph, the JAX example
    ``dot_general`` in its StableHLO)."""
    import ast
    import re

    def numbers(text):
        return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?", text)]

    bad = [] if len(lines) == len(ref_lines) else [("line count", len(lines), len(ref_lines))]
    for a, b in zip(lines, ref_lines):
        label, _, rest = b.partition(": ")
        alabel, _, arest = a.partition(": ")
        if label in ("graph ops", "stablehlo ops"):
            ok = alabel == "graph ops" and \
                arest.split("|")[1:] == rest.split("|")[1:] == [" fft-free: True"]
        elif alabel != label:
            ok = False
        elif label in EXAMPLE_RUN_TO_RUN:
            ok = True
        elif label == "  batch":
            x, y = ast.literal_eval(arest.strip()), ast.literal_eval(rest.strip())
            x.pop("throughput", None), y.pop("throughput", None)
            ok = x == y
        elif label in EXAMPLE_NUMERIC:
            x, y = numbers(arest), numbers(rest)
            ok = len(x) == len(y) > 0 and max(abs(p - q) for p, q in zip(x, y)) \
                <= 1e-4 * max(1.0, max(abs(q) for q in y))
        else:
            ok = a == b
        if not ok:
            bad.append((a, b))
    return bad


@contextlib.contextmanager
def held_to_plain(k1, k2):
    """Inside, every launch of K1 (``mfcc_fused``) or K2 (``ct_mel``) is
    followed by the kernel's plain PyTorch version on the same arguments;
    yields {"k1": [...], "k2": [...]}, max|Δ|/max|ref| of each launch.
    The wrappers count their launches on their module's name, which is the
    checker inside, so the counts go on as before and the plain calls add
    none.  Inside, every call runs eagerly (``utils.graphs.disabled()``: a
    capture cannot read a result back); the compiled phase holds the
    replays to the plain versions."""
    from mfcc_rust_tpu_torch.utils import graphs

    readings = {"k1": [], "k2": []}
    saved = []

    def checked(mod, name, plain, key):
        kernel = getattr(mod, name)

        def call(*args, **kw):
            before = call.launches
            out = kernel(*args, **kw)
            if call.launches != before:
                readings[key].append(rel_err(out, plain(*args, **kw))[0])
            return out

        call.launches = kernel.launches
        saved.append((mod, name, kernel, call))
        setattr(mod, name, call)

    checked(k1, "mfcc_fused", k1.mfcc_fused_plain, "k1")
    checked(k2, "ct_mel", k2.ct_mel_plain, "k2")
    try:
        with graphs.disabled():
            yield readings
    finally:
        for mod, name, kernel, call in saved:
            kernel.launches = call.launches
            setattr(mod, name, kernel)


def worst_reading(readings: dict) -> dict:
    """{kernel: [launches checked, worst max|Δ|/max|ref|]} of
    :func:`held_to_plain`'s readings."""
    return {k: [len(v), max(v, default=0.0)] for k, v in readings.items()}


def entry_phase(np, torch, PF, k1, k2) -> dict:
    """The port's entry module and examples on the card.

    ``entry.entry()``: its ``fn`` on its own zero batch and on a seeded
    N(0, 0.1) batch of that shape, the counts zeroed just before each call:
    K1 must launch exactly once and K2 never, the output must be within
    1e-4 of K1's plain version and within 5e-3 of the float64 speechpy
    oracle, row by row.  ``entry.dryrun_multichip(1)`` in this process (the
    one-rank world): K1 must launch once for each step of
    :data:`DRYRUN_K1_STEPS` plus once a dispatched runner batch, K2 never.
    Then each ``examples_torch/*.py`` in this process with ``--device cuda``
    (the counts zeroed just before) and ``--device cpu``: each must return,
    print the CPU run's lines (:func:`example_lines_differ`) and launch
    :data:`EXAMPLE_LAUNCHES`.  The dry run and each card run of an example
    hold every kernel launch to its plain version (:func:`held_to_plain`,
    1e-4).  Raises after the phase has printed every number."""
    from mfcc_rust_tpu_torch import entry as E
    from mfcc_rust_tpu_torch.config import FeatureConfig
    from tests.golden import speechpy_ref

    fails = []
    t_phase = time.perf_counter()
    fn, (x0,) = E.entry()
    cfg = FeatureConfig(sample_rate=16000)
    seeded = np.random.default_rng(10).normal(0.0, 0.1, tuple(x0.shape))
    calls = {}
    for name, x in (("zeros", x0), ("seeded", torch.from_numpy(seeded.astype(np.float32))
                                    .to(x0.device))):
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        t0 = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
        plain_rel, plain_abs = rel_err(out, k1.mfcc_fused_plain(x, cfg))
        xs = x.double().cpu().numpy()
        gold = torch.from_numpy(np.stack([speechpy_ref.mfcc(row, 16000) for row in xs]))
        oracle_rel, _ = rel_err(out, gold)
        calls[name] = {"launches": list(launches), "rel_plain": plain_rel, "abs_plain": plain_abs,
                       "rel_oracle": oracle_rel, "host_s": host_s, "shape": list(out.shape)}
        log(f"entry fn on {name} {tuple(x.shape)} -> {tuple(out.shape)} in {host_s * 1e3:.3f} ms "
            f"(host clock, synchronised); launches (K1, K2) {launches}; vs K1 plain rel "
            f"{plain_rel:.3e} (limit {REL_TOL}); vs float64 oracle rel {oracle_rel:.3e} "
            f"(limit {ORACLE_TOL})")
        if (launches != (1, 0) or plain_rel > REL_TOL or oracle_rel > ORACLE_TOL
                or tuple(out.shape) != (8, 98, 13) or not bool(torch.isfinite(out).all())):
            fails.append(f"entry fn on {name}: {calls[name]}")

    steps = {"padded": cfg, "packed": cfg, "packed_outputs": cfg,
             "25/10": cfg.replace(frame_length=0.025)}
    lowering = {k: PF.speechpy_lowering(c, "mfcc", "cuda", torch.float32)
                for k, c in steps.items()}
    k1.mfcc_fused.launches = k2.ct_mel.launches = 0
    t0 = time.perf_counter()
    with held_to_plain(k1, k2) as readings:
        report = E.dryrun_multichip(1)
        torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    dry = (k1.mfcc_fused.launches, k2.ct_mel.launches)
    dry_plain = worst_reading(readings)
    want = len(DRYRUN_K1_STEPS) + report["runner_dispatches"]
    log(f"dryrun_multichip(1) in {dry_s:.3f} s (each launch held to its plain version): "
        f"{report}; launches (K1, K2) {dry}; K1 expected {want} = steps {DRYRUN_K1_STEPS} + "
        f"{report['runner_dispatches']} runner batches; lowering of the steps {lowering}; "
        f"vs plain [launches checked, worst rel] {dry_plain} (limit {REL_TOL})")
    if dry != (want, 0) or dry_plain["k1"] != [want, dry_plain["k1"][1]] \
            or dry_plain["k1"][1] > REL_TOL:
        fails.append(f"dryrun launches {dry}, expected ({want}, 0); vs plain {dry_plain}")

    examples = {}
    for name in EXAMPLES:
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        with held_to_plain(k1, k2) as readings:
            cuda_s, cuda_lines = run_example(name, "cuda")
            torch.cuda.synchronize()
        launches = (k1.mfcc_fused.launches, k2.ct_mel.launches)
        plain = worst_reading(readings)
        cpu_s, cpu_lines = run_example(name, "cpu")
        bad = example_lines_differ(cuda_lines, cpu_lines)
        examples[name] = {"launches": list(launches), "cuda_s": cuda_s, "cpu_s": cpu_s,
                          "plain": plain, "lines": cuda_lines, "differ": [list(b) for b in bad]}
        log(f"example {name}: {len(cuda_lines)} lines in {cuda_s:.3f} s on cuda (each launch "
            f"held to its plain version), {cpu_s:.3f} s on cpu; launches (K1, K2) {launches}, "
            f"expected {EXAMPLE_LAUNCHES[name]}; vs plain [launches checked, worst rel] {plain} "
            f"(limit {REL_TOL}); lines differing from the cpu run: {bad}")
        if bad or launches != EXAMPLE_LAUNCHES[name] \
                or (plain["k1"][0], plain["k2"][0]) != launches \
                or max(plain["k1"][1], plain["k2"][1]) > REL_TOL:
            fails.append(f"example {name}: launches {launches}, vs plain {plain}, "
                         f"differing lines {bad}")
    phase_s = time.perf_counter() - t_phase
    log(f"entry phase: {phase_s:.3f} s")
    if fails:
        raise AssertionError("entry phase: " + "; ".join(fails))
    return {"calls": calls, "dryrun": {"report": report, "launches": list(dry),
                                       "lowering": lowering, "plain": dry_plain,
                                       "seconds": dry_s},
            "examples": examples, "seconds": phase_s,
            "launches_entry": [calls["zeros"]["launches"][0] + calls["seeded"]["launches"][0]
                               + dry[0], dry[1]],
            "launches_examples": [sum(e["launches"][i] for e in examples.values())
                                  for i in (0, 1)]}


# ------------------------------------------------------------ compiled --
COMPILED_TOL = 1e-6  # a replay against the eager call, max|Δ|/max|ref|
# the paths that launch one kernel on the caller's signal, K1 (api._k1_alone)
# or K2, which stages the centre pad (api._k2_alone): no graph
DIRECT_PATHS = ("api.mfcc", "api.mel_spectrogram_librosa")
PROFILE_CALLS, PROFILE_CHUNK = 1000, 8
PROFILE_SPIN = 40_000_000  # ~20 ms of device spin ahead of each chunk of calls
LOOP_CALLS = 100  # calls of a path back to back, synced once: the wall time a call


def loop_ms(torch, fn, xs) -> float:
    """Wall ms a call of ``fn`` over :data:`LOOP_CALLS` calls back to back,
    synchronized once at the end (after one untimed call): what a loop that
    keeps the device busy pays, host and device overlapped."""
    fn(xs[-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LOOP_CALLS):
        out = fn(xs[i % len(xs)])
    torch.cuda.synchronize()
    del out
    return 1e3 * (time.perf_counter() - t0) / LOOP_CALLS


def _leaves(out) -> list:
    """The tensors of a result: a tensor, a tuple of them, or a dict of
    either, in order."""
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _leaves(v)]
    return [out]


def _compare(got, ref) -> tuple:
    """(worst max|Δ|/max|ref| over the leaves, every leaf bitwise equal)."""
    pairs = list(zip(_leaves(got), _leaves(ref)))
    return (max(rel_err(a, b)[0] for a, b in pairs),
            all(a.shape == b.shape and bool((a == b).all()) for a, b in pairs))


def compiled_paths(P, bench):
    """Every entry point of the compiled-call layer (those of
    :data:`DIRECT_PATHS` launch K1, or K2, in place, the
    others replay a CUDA graph), at the two full-width shapes: (name, function of a device
    batch, family, (K1, K2) launches of one call, oracle of one row or
    None, the oracle's rule).  The speechpy
    family takes 48 x 10 s at 16 kHz (the headline), the librosa family 32 x
    10 s at 22,050 Hz (2048/512/128): the nine ``api`` sites, then
    ``Pipeline.forward`` of each pipeline class and ``FeatureExtractor``."""
    from tests.golden import librosa_ref

    sp, lb = P.speechpy_config(RATE), P.librosa_config(L_RATE)
    o_mfcc = lambda row: bench.oracle("mfcc", sp, row)
    o_mel = lambda row: bench.oracle("mel_spectrogram_librosa", lb, row)
    o_log = lambda row: librosa_ref.power_to_db(o_mel(row))
    o_lmfcc = lambda row: bench.oracle("mfcc_librosa", lb, row)
    return [
        ("api.mfcc", lambda x: P.mfcc(x, RATE), "speechpy", (1, 0), o_mfcc, "max"),
        ("api.mfe", lambda x: P.mfe(x, RATE), "speechpy", (0, 0), None, None),
        ("api.lmfe", lambda x: P.lmfe(x, RATE), "speechpy", (0, 0), None, None),
        ("api.ssc", lambda x: P.ssc(x, RATE), "speechpy", (0, 0), None, None),
        ("api.extract", lambda x: P.extract(x, RATE, which=SUITE_HEADS), "speechpy", (0, 0),
         None, None),
        ("api.mel_spectrogram", lambda x: P.mel_spectrogram(x, RATE), "speechpy", (0, 0),
         None, None),
        ("api.mel_spectrogram_librosa", lambda x: P.mel_spectrogram_librosa(x, L_RATE),
         "librosa", (0, 1), o_mel, "librosa"),
        ("api.log_mel_spectrogram", lambda x: P.log_mel_spectrogram(x, L_RATE), "librosa",
         (0, 1), o_log, "max"),
        ("api.mfcc_librosa", lambda x: P.mfcc_librosa(x, L_RATE), "librosa", (0, 1), o_lmfcc,
         "max"),
        ("MFCCPipeline", P.MFCCPipeline(sp), "speechpy", (1, 0), o_mfcc, "max"),
        ("MFEPipeline", P.MFEPipeline(sp), "speechpy", (0, 0), None, None),
        ("LogMFEPipeline", P.LogMFEPipeline(sp), "speechpy", (0, 0), None, None),
        ("SSCPipeline", P.SSCPipeline(sp), "speechpy", (0, 0), None, None),
        ("MelSpectrogramPipeline", P.MelSpectrogramPipeline(sp), "speechpy", (0, 0), None,
         None),
        ("LibrosaMelPipeline", P.LibrosaMelPipeline(lb), "librosa", (0, 1), o_mel, "librosa"),
        ("LibrosaMFCCPipeline", P.LibrosaMFCCPipeline(lb), "librosa", (0, 1), o_lmfcc, "max"),
        ("FeatureExtractor", P.FeatureExtractor(sp), "speechpy", (1, 0), o_mfcc, "max"),
    ]


def enqueue_profile(torch, fn, xs) -> dict:
    """The host's time in one call of ``fn``, split by where it goes:
    :data:`PROFILE_CALLS` calls under ``cProfile``, in chunks of
    :data:`PROFILE_CHUNK` behind a device spin (so no call waits for the
    device), each after one unprofiled call (as ``bench_torch._enqueue``),
    then per call in µs: the whole profiled time, its builtin calls
    (torch's C++ ops and Python's builtins; ctypes calls are not builtins
    and stay in their caller), the Python around them, and the cumulative
    time of the named functions (nested: the launch runs inside
    ``autograd.Function.apply``, the tensor-cache lookups inside both).
    cProfile's own cost inflates the Python share; the unprofiled host time
    a call is ``enqueue_us`` beside it.  ``top_own_us``: the twelve functions
    with the most own time a call."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    for i in range(0, PROFILE_CALLS, PROFILE_CHUNK):
        torch.cuda.synchronize()
        torch.cuda._sleep(PROFILE_SPIN)
        out = fn(xs[-1])  # the first call after a synchronize, unprofiled
        prof.enable()
        for j in range(i, i + PROFILE_CHUNK):
            out = fn(xs[j % len(xs)])
        prof.disable()
        del out
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    per = lambda t: round(1e6 * t / PROFILE_CALLS, 2)
    total = sum(v[2] for v in stats.values())
    builtin = sum(v[2] for (f, _, _), v in stats.items() if f == "~")

    def cum(test):
        return sum(v[3] for (f, _, name), v in stats.items() if test(f.replace("\\", "/"), name))

    launch = cum(lambda f, n: n == "_launch" and "ops/cuda/" in f)
    launch_own = sum(v[2] for (f, _, n), v in stats.items() if n == "_launch" and "ops/cuda/" in f)
    return {
        "total_us": per(total), "builtin_us": per(builtin),
        "python_us": per(total - builtin - launch_own),
        "tensor_cache_us": per(cum(lambda f, n: n == "call" and f.endswith("constants.py"))),
        "ct_mel_supported_us": per(cum(lambda f, n: n == "ct_mel_supported")),
        "autograd_apply_us": per(cum(lambda f, n: n == "apply" and "autograd/function" in f)),
        "pad_signal_us": per(cum(lambda f, n: n == "pad_signal")),
        "launch_us": per(launch), "launch_own_us": per(launch_own),
        "fill_us": per(cum(lambda f, n: n == "fill" and f.endswith("api.py"))),
        "replay_us": per(cum(lambda f, n: n == "replay" and "cuda/graphs" in f)),
        "clone_us": per(sum(v[2] for (f, _, n), v in stats.items()
                            if f == "~" and "'clone'" in n)),
        "top_own_us": [(f"{Path(f).name}:{line} {n}" if f != "~" else n, per(v[2]))
                       for (f, line, n), v in sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]],
    }


def compiled_phase(np, torch, P, k1, k2) -> dict:
    """The compiled-call layer (``utils/graphs.py``), the counterpart of the
    JAX package's ``jax.jit`` at ``api._jitted`` and ``Pipeline._jit``.

    For every path of :func:`compiled_paths`, on four device-resident
    N(0, 0.1) batches of its family, each step with the counts zeroed just
    before: one eager call (``graphs.disabled()``), the first graphed call
    (it must capture once) and replayed calls (each must replay and capture
    nothing); a path of :data:`DIRECT_PATHS` must capture and replay
    nothing at all; the eager call, the first call and a replay must each
    launch the path's (K1, K2).  A replay must sit within :data:`COMPILED_TOL` of
    the eager call on two batches (and says whether it was bitwise); on the
    K1/K2 paths it must sit within 1e-4 of the same call with the kernels'
    plain versions (``bench_torch._plain_twins``) and, on two rows, within
    the float64 oracle's limits (5e-3 of max|ref|; the librosa mel rtol
    5e-3, atol 1e-4 max|ref|).  Then host µs to enqueue a call and device ms
    a call, eager and replayed in turns (eager, replayed, replayed, eager),
    by ``bench_torch._enqueue`` (eight calls behind a device spin after an
    untimed one, median of five), the wall ms a call of a long loop
    (:func:`loop_ms`) in the same turns, the capture's ms, the host µs of the graph
    launch alone (:func:`host_us`), and the bytes each graph holds.  Beside:
    ``api.mfcc`` from a numpy batch (host clock, synced), the enqueue
    profile of the librosa and ``extract`` lines (:func:`enqueue_profile`),
    a capture that fails (it must raise), and the bytes the cache
    reserves.  Raises after printing every number."""
    import bench_torch as bench
    from mfcc_rust_tpu_torch.utils import graphs

    fails, rec = [], {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    shapes = {"speechpy": (BATCH, SECONDS * RATE), "librosa": (L_BATCH, SECONDS * L_RATE)}
    host = {f: [rng.normal(0, 0.1, sh).astype(np.float32) for _ in range(4)]
            for f, sh in shapes.items()}
    batches = {f: [torch.from_numpy(h).to(dev) for h in hs] for f, hs in host.items()}
    graphs.cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()

    def counted(fn, x):
        k1.mfcc_fused.launches = k2.ct_mel.launches = 0
        out = fn(x)
        torch.cuda.synchronize()
        return out, (k1.mfcc_fused.launches, k2.ct_mel.launches)

    def eager(fn):
        def call(x):
            with graphs.disabled():
                return fn(x)
        return call

    for name, fn, family, want, oracle, rule in compiled_paths(P, bench):
        xs, r = batches[family], {"family": family, "shape": list(shapes[family])}
        out_e, r["launches_eager"] = counted(eager(fn), xs[0])
        c0, p0 = graphs.cache.captures, graphs.cache.replays
        t0 = time.perf_counter()
        out_1, r["launches_first"] = counted(fn, xs[0])
        r["first_call_ms"] = 1e3 * (time.perf_counter() - t0)
        r["captures"] = graphs.cache.captures - c0
        direct = name in DIRECT_PATHS
        if not direct:
            g = next(reversed(graphs.cache._graphs.values()))
            r["capture_ms"] = 1e3 * g.capture_s
            r["graph_bytes"] = g.pool_bytes() + g.static.numel() * g.static.element_size()
            r["replay_us"] = host_us(torch, g.graph.replay)  # the graph launch alone
        out_r, r["launches_replay"] = counted(fn, xs[0])
        r["replays"] = graphs.cache.replays - p0
        r["rel_eager"], r["bitwise"] = _compare(out_r, out_e)
        r["rel_first"], _ = _compare(out_1, out_e)
        with graphs.disabled():
            ref1 = fn(xs[1])
        r["rel_eager_2"], r["bitwise_2"] = _compare(fn(xs[1]), ref1)
        r["finite"] = all(bool(torch.isfinite(t).all()) for t in _leaves(out_r))
        bad = ((r["captures"], r["replays"]) != ((0, 0) if direct else (1, 1))
               or not r["launches_eager"] == r["launches_first"] == r["launches_replay"] == want
               or max(r["rel_eager"], r["rel_first"], r["rel_eager_2"]) > COMPILED_TOL
               or not r["finite"])
        if oracle is not None:
            with bench._plain_twins():
                ref_plain = fn(xs[0])
            r["rel_plain"], _ = _compare(out_r, ref_plain)
            r["rel_oracle"] = max(bench.rel_err(out_r[i], oracle(host[family][0][i]), rule)
                                  for i in range(2))
            bad = bad or r["rel_plain"] > REL_TOL or r["rel_oracle"] > ORACLE_TOL
        timing = {"eager": [], "replayed": []}
        loops = {"eager": [], "replayed": []}
        for mode in ("eager", "replayed", "replayed", "eager"):
            call = eager(fn) if mode == "eager" else fn
            timing[mode].append(bench._enqueue(call, xs))
            loops[mode].append(loop_ms(torch, call, xs))
        for mode, pairs in timing.items():
            r[f"enqueue_us_{mode}"] = [round(h, 2) for h, _ in pairs]
            r[f"device_ms_{mode}"] = [round(d, 5) for _, d in pairs]
            r[f"loop_ms_{mode}"] = [round(t, 5) for t in loops[mode]]
        rec[name] = r
        log(f"compiled {name} {tuple(shapes[family])}: captures {r['captures']}, replays "
            f"{r['replays']}; launches (K1, K2) eager {r['launches_eager']}, first "
            f"{r['launches_first']}, replay {r['launches_replay']} (want {want}); replay vs "
            f"eager rel {r['rel_eager']:.3e} bitwise {r['bitwise']} (second batch "
            f"{r['rel_eager_2']:.3e} {r['bitwise_2']}; first call {r['rel_first']:.3e}; limit "
            f"{COMPILED_TOL})"
            + (f"; vs plain kernels {r['rel_plain']:.3e} (limit {REL_TOL}), vs float64 oracle "
               f"{r['rel_oracle']:.3e} ({rule} rule, limit {ORACLE_TOL})" if oracle else "")
            + f"; enqueue us eager {r['enqueue_us_eager']} replayed {r['enqueue_us_replayed']}; "
            f"device ms eager {r['device_ms_eager']} replayed {r['device_ms_replayed']}; "
            f"loop ms a call ({LOOP_CALLS} calls) eager {r['loop_ms_eager']} replayed "
            f"{r['loop_ms_replayed']}; "
            f"first call {r['first_call_ms']:.1f} ms, "
            + ("no graph (in place)" if direct else
               f"capture {r['capture_ms']:.1f} ms; one graph launch {r['replay_us']:.2f} us "
               f"(median of 500); graph holds {r['graph_bytes']} B"))
        if bad:
            fails.append(f"{name}: {r}")

    # api.mfcc from a numpy batch: uploaded, then K1 in place on the upload
    audio = host["speechpy"][0]
    from_host = {"eager": [], "direct": []}
    c0 = graphs.cache.captures
    for mode in ("eager", "direct", "direct", "eager"):
        fn = eager(lambda a: P.mfcc(a, RATE)) if mode == "eager" else (lambda a: P.mfcc(a, RATE))
        fn(audio)
        torch.cuda.synchronize()
        for _ in range(10):
            t0 = time.perf_counter()
            fn(audio)
            torch.cuda.synchronize()
            from_host[mode].append(1e3 * (time.perf_counter() - t0))
    rec["from_host_ms"] = {k: statistics.median(v) for k, v in from_host.items()}
    rec["from_host_ms_all"] = from_host
    rec["from_host_captures"] = graphs.cache.captures - c0
    log(f"compiled api.mfcc from a numpy {tuple(audio.shape)} batch, host ms a synced call "
        f"(median of 20): eager {rec['from_host_ms']['eager']:.3f}, direct "
        f"{rec['from_host_ms']['direct']:.3f}; captures {rec['from_host_captures']}")
    if rec["from_host_captures"]:
        fails.append(f"api.mfcc from numpy captured {rec['from_host_captures']} graphs")

    # where the host's time goes: the librosa and extract lines of bench_torch
    prof = {}
    for line, api_fn in (("librosa", lambda x: P.mel_spectrogram_librosa(x, L_RATE)),
                         ("multi", lambda x: P.extract(x, RATE, which=bench.LINES["multi"][1]))):
        cfg, feature, shape, _ = bench.LINES[line]
        xs = [torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)).to(dev)
              for _ in range(2)]
        api_fn(xs[0])  # capture first
        variants = {"features eager (the bench line)": bench._call(feature, cfg),
                    "api eager": eager(api_fn), "api (graph or in place)": api_fn}
        prof[line] = {}
        for label, fn in variants.items():
            p = enqueue_profile(torch, fn, xs)
            p["enqueue_us"] = round(bench._enqueue(fn, xs)[0], 2)
            prof[line][label] = p
            log(f"enqueue profile, {line} {tuple(shape)}, {label}, per call over "
                f"{PROFILE_CALLS} (us; nested cumulative): {p}")
    rec["profile"] = prof

    # a capture that fails raises, keeps nothing, and the layer goes on
    probe = graphs.GraphCache()
    try:
        probe.run(("sync",), lambda s: s * float(s.sum()), (4,), torch.float32, dev,
                  lambda s: s.fill_(1.0))
        rec["failed_capture"] = "no error"
        fails.append("a capture that syncs did not raise")
    except Exception as e:  # noqa: BLE001 - any error is the expected outcome
        rec["failed_capture"] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    again, _ = counted(lambda x: P.mfcc(x, RATE), batches["speechpy"][2])
    torch.cuda.synchronize()
    log(f"compiled: a capture that syncs raised {rec['failed_capture']!r}; graphs kept "
        f"{len(probe)}; api.mfcc afterwards {tuple(again.shape)}")
    if len(probe) or not bool(torch.isfinite(again).all()):
        fails.append("the layer did not go on after a failed capture")

    st = graphs.cache.stats()
    rec["cache"] = dict(st, reserved_bytes=torch.cuda.memory_reserved() - reserved0)
    rec["seconds"] = time.perf_counter() - t_phase
    # the launches of the replayed calls, each driven with the counts zeroed
    rec["launches"] = [sum(r["launches_replay"][i] for r in rec.values()
                           if isinstance(r, dict) and "launches_replay" in r) for i in (0, 1)]
    log(f"compiled cache: {st['graphs']} graphs, {st['captures']} captures, {st['replays']} "
        f"replays; pools {st['pool_bytes']} B + static inputs {st['static_bytes']} B = "
        f"{st['bytes']} B; reserved since the phase began "
        f"{rec['cache']['reserved_bytes']} B; phase {rec['seconds']:.1f} s")
    graphs.cache.clear()
    if fails:
        raise AssertionError("compiled phase: " + "; ".join(fails))
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


HEADS_TOL = {"mfe": (1e-5, "mixed"), "energy": (1e-5, "mixed"), "lmfe": (3e-5, "rel"),
             "ssc": (1e-5, "rel"), "mfcc": (3e-5, "rel")}


def heads_phase(np, torch, P, PF, flush, chip) -> dict:
    """The speechpy heads kernel (``ops/cuda/speechpy_heads.cu``: the mel,
    SSC, log-mel, MFCC and frame energy of each frame of the chunk-GEMM
    product in one pass; ``features._extract_heads``) against its plain
    version (``features._extract_heads_plain``) on the suite cell's
    (64, 177,664) bucket, the last 17,664 samples of each row zero as the
    bucket gives, of the cell's four heads: each head's error in the cell's
    own number (``mfe`` and its energies max|Δ|/(|ref| + 0.02 max|ref|), the
    others max|Δ|/max|ref|), within 1e-5 (the logs 3e-5).  Kernel and plain
    version timed with CUDA events after an L2 flush and a device spin, 20
    calls each; the kernel's share of HBM on the bytes one call must move:
    the product read once, the samples read once, the 134 floats a frame
    written, and ``bound_ms`` from those bytes and the operations of one
    call.  Its launches are read from ``api.extract`` of the four heads at
    (64, 160,000), the suite cell's call, replayed from the call's CUDA
    graph with the count set to 0 just before: one a replay.  Returns the
    kernels line's entry."""
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_heads as kh
    from mfcc_rust_tpu_torch.utils import profiling as prof

    dev = torch.device("cuda")
    cfg = P.speechpy_config(RATE)
    fl, hop = cfg.frame_size, cfg.frame_step
    rng = np.random.default_rng(22)
    x = rng.normal(0.0, 0.1, (EDGE_ROWS, EDGE_BUCKET)).astype(np.float32)
    x[:, RATE * SECONDS:] = 0.0
    x = torch.from_numpy(x).to(dev)
    n = (EDGE_BUCKET - fl) // hop
    c = PF._speechpy_tensors(cfg, dev, torch.float32)
    ch, y = PF._speechpy_product(x, c, cfg, n)
    want = set(HEADS)
    got = kh.heads(ch, y, cfg, want, n, True)
    ref = PF._extract_heads_plain(ch, y, c, cfg, want, n, True)
    errs = {}
    for name in ("mfe", "energy", "lmfe", "ssc", "mfcc"):
        a, b = ((got["mfe"][0], ref["mfe"][0]) if name == "mfe" else
                (got["mfe"][1], ref["mfe"][1]) if name == "energy" else (got[name], ref[name]))
        tol, kind = HEADS_TOL[name]
        a, b = a.double(), b.double()
        top = b.abs().max()
        d = (a - b).abs()
        errs[name] = (d / (b.abs() + 0.02 * top) if kind == "mixed" else d / top).max().item()
        assert errs[name] <= tol, (f"speechpy heads: {name} off the plain heads", errs[name], tol)
    log(f"speechpy heads at ({EDGE_ROWS}, {EDGE_BUCKET}), {n} frames, {sorted(want)}: vs plain "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    launches = replayed_extract_launches(torch, P, x[:, :RATE * SECONDS].contiguous(), kh.heads)

    runs = {"kernel": lambda: kh.heads(ch, y, cfg, want, n, True),
            "plain": lambda: PF._extract_heads_plain(ch, y, c, cfg, want, n, True)}
    times = {name: [] for name in runs}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for name in order:
            times[name] += cuda_ms(torch, runs[name], 10, flush)
    med = {name: statistics.median(v) for name, v in times.items()}
    frames = EDGE_ROWS * n
    m, cc, kmax = cfg.num_filters, cfg.num_cepstral, (y.shape[-1] - 2) // 2
    nnz = kh._kernel_constants(cfg)[3]
    out_floats = 3 * m + 1 + cc
    nbytes = 4 * frames * y.shape[-1] + 4 * EDGE_ROWS * EDGE_BUCKET + 4 * frames * out_floats
    # a frame: |X_k|^2 and its SSC power (4 a bin), x^2 w^2 summed (3 a
    # sample), three weighted sums over the bands' bins (6 a weight), the DCT
    flops = frames * (4 * kmax + 3 * fl + 6 * nnz + 2 * m * cc)
    bound_s, bound_by = prof.bound_seconds(flops, nbytes, chip)
    hbm = nbytes / (med["kernel"] * 1e-3) / (chip["hbm_gbs"] * 1e9)
    log(f"speechpy heads: kernel {1e3 * med['kernel']:.1f} us, plain {1e3 * med['plain']:.1f} us "
        f"(median of {len(times['kernel'])}); {nbytes / 1e6:.1f} MB a call, "
        f"{100 * hbm:.1f}% of HBM; bound {1e3 * bound_s:.4f} ms ({bound_by}; "
        f"{flops / 1e9:.3f} GFLOP)")
    return {"name": kh.KERNEL, "route": "cuda",
            "source": "mfcc_rust_tpu_torch/ops/cuda/speechpy_heads.cu", "replaces": None,
            "launches": launches, "max_err": errs, "ms": med["kernel"],
            "plain_ms": med["plain"], "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
            "bytes": nbytes, "hbm_share": hbm, "times_ms": times}


W_ROWS, W_SAMPLES, W_MELS = 64, 480_000, 128  # the Whisper cell's batch of 30-s windows
W_FINISH_TOL, W_PLAIN_TOL = 2e-6, 5e-4


def ptxas_lines(text: str, kernel: str) -> list:
    """The ``-Xptxas -v`` lines (registers, spills, shared memory) of the
    entry functions whose name holds ``kernel``, from an nvcc log."""
    out, inside = [], False
    for line in text.splitlines():
        if "entry function" in line or "Function properties for" in line:
            inside = kernel in line
        if inside and any(w in line for w in ("registers", "spill", "smem", "stack")):
            out.append(line.strip())
    return out


def whisper_phase(np, torch, P, PF, k2, flush, chip, k2_log: str = "") -> dict:
    """Whisper's log-mel front end (``api.log_mel_spectrogram_whisper``) at
    the Whisper cell's (64, 480,000), 128 mels, rows of speech of lognormal
    length with zero tails: K2's launch plan at n_fft 400 (path 3, the 8 x 25
    register FFT, is asserted, with the plan mirror's warps and bytes) and
    the ptxas lines of its kernel ``ct_mel_fft200_kernel`` (from ``k2_log``,
    K2's nvcc log), K2 alone on the centre-padded batch and the finish alone
    (``ops/cuda/whisper_logmel.cu``: the rows' maxima, then the finish) on
    K2's output, each against its plain version (K2 1e-4 of max|ref|, the
    finish 2e-6 in Whisper's units) and timed with CUDA events after an L2
    flush and a device spin, 20 calls each, beside their plain versions,
    with its share of HBM on the bytes one call must move (K2: the padded
    batch in, the (64, 3,001, 128) power out; the finish: that power in, the
    (64, 128, 3,000) answer out) and ``bound_ms``; K2 again at the librosa
    128 and librosa 80 cells' batches (path 1 asserted, timed in the same
    turns); the centre pad and the whole API call timed the same way; the
    API call's launches (K2 once, on path 3, staging the reflect pad, the
    finish's two kernels) and its errors against the plain path
    (``pallas="off"`` on the card, 5e-4) and the float64 reference
    (``tests/golden/whisper_ref.py``).  At the Whisper and the two librosa
    cells' batches, K2's centred launch (``ct_mel`` on the unpadded rows,
    the kernel staging the reflect pad) against the centre pad and an
    uncentred launch: equal bit for bit, within 1e-4 of the plain version,
    and both timed in the same turns (``staged_*`` and ``pad_launch_*``).
    Returns the kernels line's entry of the finish and the phase's
    record."""
    from mfcc_rust_tpu_torch import api as PA
    from mfcc_rust_tpu_torch.ops import framing
    from mfcc_rust_tpu_torch.ops.cuda import whisper_logmel as wl
    from mfcc_rust_tpu_torch.utils import profiling as prof
    from tests.golden import whisper_ref

    dev = torch.device("cuda")
    cfg = PA._whisper_cfg(W_MELS)
    cu = cfg.replace(center=False)
    rng = np.random.default_rng(23)
    x = rng.normal(0.0, 0.1, (W_ROWS, W_SAMPLES)).astype(np.float32)
    speech = np.clip(rng.lognormal(np.log(6.0), 0.6, W_ROWS), 1.0, 30.0)
    for r, s in enumerate(speech):
        x[r, int(s * RATE):] = 0.0
    x = torch.from_numpy(x).to(dev)
    xp = framing.center_pad(x, cfg)
    frames = 1 + W_SAMPLES // cfg.frame_step
    plan = k2.launch_plan(cu, W_ROWS, frames)
    log(f"whisper: K2 launch plan at ({W_ROWS}, {xp.shape[-1]}), n_fft 400: {plan}")
    _, _, wp, _, km = k2._kernel_constants(cu)
    a = (cu.fft_points, cu.frame_step, km, wp.size, cu.num_filters)
    assert plan["path"] == 3, ("K2 at n_fft 400 must take path 3", plan)
    assert plan["warps"] == k2.fft_warps(*a) and plan["smem_bytes"] == k2.fft_smem_bytes(
        *a, plan["warps"]), ("path-3 plan mirror", plan)
    ptxas = ptxas_lines(k2_log, "ct_mel_fft200")
    for line in ptxas:
        log(f"whisper: ptxas ct_mel_fft200_kernel: {line}")

    power = k2.ct_mel(xp, cu)
    k2_rel, _ = rel_err(power, k2.ct_mel_plain(xp, cu))
    assert tuple(power.shape) == (W_ROWS, frames, W_MELS) and k2_rel <= REL_TOL, k2_rel
    got = wl.whisper_logmel(power)
    fin_err = (got.double() - wl.whisper_logmel_plain(power).double()).abs().max().item()
    assert tuple(got.shape) == (W_ROWS, W_MELS, frames - 1), tuple(got.shape)
    assert fin_err <= W_FINISH_TOL, ("whisper finish off its plain twin", fin_err)

    k2.ct_mel.launches = wl.whisper_logmel.launches = 0
    direct0, paths0 = PA.paths.read()["direct"], k2.path_counts()
    reflect0 = k2.reflect_launches.launches
    out = P.log_mel_spectrogram_whisper(x, n_mels=W_MELS)
    torch.cuda.synchronize()
    paths1 = k2.path_counts()
    launches = {"k2": k2.ct_mel.launches, "finish": wl.whisper_logmel.launches,
                "direct": PA.paths.read()["direct"] - direct0,
                "k2_by_path": {p: paths1[p] - paths0[p] for p in paths1},
                "k2_reflect": k2.reflect_launches.launches - reflect0}
    assert launches == {"k2": 1, "finish": 2, "direct": 1,
                        "k2_by_path": {1: 0, 2: 0, 3: 1}, "k2_reflect": 1}, launches
    assert out.is_contiguous() and tuple(out.shape) == (W_ROWS, W_MELS, frames - 1)
    plain = PF.whisper_log_mel(x, cfg.replace(pallas="off"))
    api_plain = (out.double() - plain.double()).abs().max().item()
    ref64 = whisper_ref.log_mel_spectrogram(x, W_MELS)
    api_ref = (out.double() - ref64).abs().max().item()
    plain_ref = (plain.double() - ref64).abs().max().item()
    del plain, ref64
    log(f"whisper at ({W_ROWS}, {W_SAMPLES}), {W_MELS} mels: K2 vs plain rel {k2_rel:.3e}; "
        f"finish vs plain {fin_err:.3e}; API vs plain path {api_plain:.3e}, vs float64 "
        f"{api_ref:.3e} (plain path vs float64 {plain_ref:.3e}); launches {launches}")
    assert api_plain <= W_PLAIN_TOL and api_ref <= W_PLAIN_TOL, (api_plain, api_ref)

    # K2 at the librosa cells' batches, path 1, beside path 3
    librosa = {}
    for label, c, rows, samples in (
            ("k2_librosa128", P.librosa_config(22050), 32, 220_500),
            ("k2_librosa80", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
             64, 160_000)):
        xu = torch.from_numpy(rng.normal(0.0, 0.1, (rows, samples)).astype(np.float32)).to(dev)
        xl = framing.center_pad(xu, c)
        cl = c.replace(center=False)
        before = k2.path_counts()
        got_l = k2.ct_mel(xl, cl)
        after = k2.path_counts()
        assert {p: after[p] - before[p] for p in after} == {1: 1, 2: 0, 3: 0}, label
        l_rel, _ = rel_err(got_l, k2.ct_mel_plain(xl, cl))
        assert l_rel <= REL_TOL, (label, l_rel)
        librosa[label] = (xl, cl, l_rel, xu, c)
    runs = {"pad": lambda: framing.center_pad(x, cfg), "k2": lambda: k2.ct_mel(xp, cu),
            "k2_plain": lambda: k2.ct_mel_plain(xp, cu),
            "finish": lambda: wl.whisper_logmel(power),
            "finish_plain": lambda: wl.whisper_logmel_plain(power),
            "api": lambda: P.log_mel_spectrogram_whisper(x, n_mels=W_MELS)}
    for label, (xl, cl, *_) in librosa.items():
        runs[label] = lambda xl=xl, cl=cl: k2.ct_mel(xl, cl)
    # the reflect pad staged by K2 against the pad and an uncentred launch
    staged = {"whisper": (x, cfg, xp, cu)}
    for label, (xl, cl, _, xu, c) in librosa.items():
        staged[label[3:]] = (xu, c, xl, cl)
    staged_rel = {}
    for label, (xu, c, xl, cl) in staged.items():
        r0 = k2.reflect_launches.launches
        got_s = k2.ct_mel(xu, c)
        assert k2.reflect_launches.launches == r0 + 1, (label, "K2 did not stage the pad")
        assert torch.equal(got_s, k2.ct_mel(xl, cl)), (label, "staged pad off the padded launch")
        staged_rel[label], _ = rel_err(got_s, k2.ct_mel_plain(xu, c))
        assert staged_rel[label] <= REL_TOL, (label, staged_rel[label])
        del got_s
        runs[f"staged_{label}"] = lambda xu=xu, c=c: k2.ct_mel(xu, c)
        runs[f"pad_launch_{label}"] = lambda xu=xu, c=c, cl=cl: k2.ct_mel(
            framing.center_pad(xu, c), cl)
    times = {name: [] for name in runs}
    for order in (tuple(runs), tuple(reversed(tuple(runs)))):
        for name in order:
            times[name] += cuda_ms(torch, runs[name], 10, flush)
    med = {name: statistics.median(v) for name, v in times.items()}
    nnz = int(np.count_nonzero(whisper_ref.mel_filters(RATE, 400, W_MELS)))
    n = cfg.fft_points
    f_all = W_ROWS * frames
    k2_bytes = 4 * W_ROWS * xp.shape[-1] + 4 * f_all * W_MELS
    k2_flops = f_all * (n + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * nnz)
    fin_bytes = 4 * f_all * W_MELS + 4 * W_ROWS * W_MELS * (frames - 1)
    fin_flops = 6 * W_ROWS * W_MELS * (frames - 1)
    entries = {}
    for name, flops, nbytes in (("k2", k2_flops, k2_bytes), ("finish", fin_flops, fin_bytes)):
        bound_s, bound_by = prof.bound_seconds(flops, nbytes, chip)
        entries[name] = {"ms": med[name], "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
                         "bytes": nbytes, "flops": flops,
                         "hbm_share": nbytes / (med[name] * 1e-3) / (chip["hbm_gbs"] * 1e9),
                         "roofline_share": 1e3 * bound_s / med[name]}
    log("whisper times, median of 20 (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    log(f"whisper: K2 path 3 {1e3 * med['k2']:.1f} us against its plain version "
        f"{1e3 * med['k2_plain']:.1f} us ({med['k2_plain'] / med['k2']:.1f}x); path 1 at the "
        f"librosa 128 / 80 cells' batches {1e3 * med['k2_librosa128']:.1f} / "
        f"{1e3 * med['k2_librosa80']:.1f} us (rel {librosa['k2_librosa128'][2]:.2e} / "
        f"{librosa['k2_librosa80'][2]:.2e})")
    for label in staged:
        a, b = med[f"staged_{label}"], med[f"pad_launch_{label}"]
        log(f"whisper: K2 staging the reflect pad at the {label} cell's batch "
            f"{1e3 * a:.1f} us against the pad and an uncentred launch {1e3 * b:.1f} us "
            f"({1e3 * (b - a):.1f} us saved; bitwise equal; rel {staged_rel[label]:.2e} of plain)")
    for name, e in entries.items():
        log(f"whisper {name}: {1e3 * e['ms']:.1f} us, {e['bytes'] / 1e6:.1f} MB, "
            f"{100 * e['hbm_share']:.1f}% of HBM, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{100 * e['roofline_share']:.2f}% of its roofline")
    entry = {"name": wl.KERNEL, "route": "cuda",
             "source": "mfcc_rust_tpu_torch/ops/cuda/whisper_logmel.cu", "replaces": None,
             "launches": launches["finish"], "max_err": fin_err, "ms": med["finish"],
             "plain_ms": med["finish_plain"], "bound_ms": entries["finish"]["bound_ms"],
             "bound_by": entries["finish"]["bound_by"], "bytes": fin_bytes,
             "hbm_share": entries["finish"]["hbm_share"]}
    record = {"plan": plan, "ptxas": ptxas, "k2": entries["k2"], "finish": entries["finish"],
              "median_ms": med, "times_ms": times, "launches": launches,
              "errors": {"k2_rel": k2_rel, "finish": fin_err, "api_vs_plain": api_plain,
                         "api_vs_float64": api_ref, "plain_vs_float64": plain_ref,
                         **{f"{k}_rel": v[2] for k, v in librosa.items()},
                         **{f"staged_{k}_rel": v for k, v in staged_rel.items()}}}
    return entry, record


N_ROWS, N_MELS = 64, 128  # the NeMo cell's batch of ragged rows
N_FINISH_TOL, N_PLAIN_TOL = 5e-5, 1e-3


def nemo_phase(np, torch, P, PF, k2, flush, chip, nemo_log: str = "") -> dict:
    """NeMo FastConformer's log-mel front end (``api.log_mel_spectrogram_nemo``)
    at the NeMo cell's shape: 64 rows of clip(lognormal(ln 6 s, 0.6), 1, 35)
    s of noise, zeros to the longest row, the lengths on the card, 128 mels.
    The prologue alone (``nemo_prologue_kernel``, bit for bit against its
    plain twin, over the whole buffer and, writing the frame counts, over
    what each row's frames read), K2 alone on its output (path 1 at
    512/160/128 asserted, against ``ct_mel_plain``, 1e-4 of max|ref|, on
    every frame and, ragged, ``ct_mel_ragged_kernel``, on each row's own)
    and the finish alone (``nemo_finish_*``, against its twin, 5e-5), the
    prologue and K2 timed as the API runs them (ragged), with CUDA events
    after an L2 flush, 20 calls each, beside its plain version, with its
    share of HBM on the bytes one call must move (the prologue: the rows'
    true samples in, each row's samples and pad that its frames read out;
    K2: those in, the power of the tiles of each row's own frames out; the
    finish: the power of each row's own frames in, the answer out) and
    ``bound_ms``, and K2 on every frame as well; the ptxas lines (registers, spills)
    of the new kernels from ``nemo_log``, their nvcc log; the whole API
    call timed the same way, its launches (the prologue, K2 once on path 1,
    the finish's two kernels, the direct path) and its errors against the
    plain path on the card (``pallas="off"``) and the float64 reference
    (``tests/golden/nemo_ref.py``) on eight rows, each within
    ``N_PLAIN_TOL`` (1e-3: ~4x the ~2.6e-4 either reads on the card, half
    the cell's ``max_abs_err`` limit).  Returns
    the kernels line's entry of the NeMo kernels and the phase's record."""
    from mfcc_rust_tpu_torch import api as PA
    from mfcc_rust_tpu_torch.ops.cuda import nemo_logmel as nl
    from mfcc_rust_tpu_torch.utils import profiling as prof
    from tests.golden import librosa_ref, nemo_ref

    dev = torch.device("cuda")
    cfg = PA._nemo_cfg(N_MELS)
    cu = cfg.replace(center=False)
    rng = np.random.default_rng(25)
    lens_np = np.round(np.clip(rng.lognormal(np.log(6.0), 0.6, N_ROWS), 1.0, 35.0)
                       * RATE).astype(np.int64)
    samples = int(lens_np.max())
    x = rng.normal(0.0, 0.1, (N_ROWS, samples)).astype(np.float32)
    for r, n in enumerate(lens_np):
        x[r, n:] = 0.0
    x = torch.from_numpy(x).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    frames = 1 + samples // cfg.frame_step
    ptxas = {k: ptxas_lines(nemo_log, k) for k in
             ("nemo_prologue", "nemo_finish_stats", "nemo_finish_kernel")}
    for k, lines in ptxas.items():
        for line in lines:
            log(f"nemo: ptxas {k}: {line}")

    xp = nl.nemo_prologue(x, lens, cfg)
    pro_equal = bool(torch.equal(xp, nl.nemo_prologue_plain(x, lens, cfg)))
    assert pro_equal, "the NeMo prologue differs from its plain twin"
    plan = k2.launch_plan(cu, N_ROWS, frames)
    log(f"nemo: K2 launch plan at ({N_ROWS}, {xp.shape[-1]}), 512/160/128: {plan}")
    assert plan["path"] == 1, ("K2 at n_fft 512 must take path 1", plan)
    power = k2.ct_mel(xp, cu)
    k2_rel, _ = rel_err(power, k2.ct_mel_plain(xp, cu))
    assert tuple(power.shape) == (N_ROWS, frames, N_MELS) and k2_rel <= REL_TOL, k2_rel
    got, seq = nl.nemo_finish(power, lens, cfg.frame_step)
    want, want_seq = nl.nemo_finish_plain(power, lens, cfg.frame_step)
    fin_err = (got.double() - want.double()).abs().max().item()
    assert torch.equal(seq, want_seq) and fin_err <= N_FINISH_TOL, ("NeMo finish", fin_err)
    # ragged, as the API runs them: the frame counts, each row's own frames
    used = torch.empty_like(lens)
    xr = nl.nemo_prologue(x, lens, cfg, used)
    assert torch.equal(used, seq), "the prologue's frame counts"
    pad = cfg.fft_points
    assert all(torch.equal(xr[r, : n + pad], xp[r, : n + pad]) for r, n in enumerate(lens_np.tolist()))
    power_r = k2.ct_mel(xr, cu, used)
    assert all(torch.equal(power_r[r, :n], power[r, :n]) for r, n in enumerate(seq.tolist())), \
        "K2's ragged kernel differs from its kernel on every frame"
    assert torch.equal(nl.nemo_finish(power_r, lens, cfg.frame_step)[0], got)

    P.log_mel_spectrogram_nemo(x, lens, n_mels=N_MELS)
    torch.cuda.synchronize()
    k2.ct_mel.launches = nl.nemo_prologue.launches = nl.nemo_finish.launches = 0
    direct0, paths0 = PA.paths.read()["direct"], k2.path_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, out_seq = P.log_mel_spectrogram_nemo(x, lens, n_mels=N_MELS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    paths1 = k2.path_counts()
    launches = {"prologue": nl.nemo_prologue.launches, "k2": k2.ct_mel.launches,
                "finish": nl.nemo_finish.launches, "direct": PA.paths.read()["direct"] - direct0,
                "k2_by_path": {p: paths1[p] - paths0[p] for p in paths1}}
    assert launches == {"prologue": 1, "k2": 1, "finish": 2, "direct": 1,
                        "k2_by_path": {1: 1, 2: 0, 3: 0}}, launches
    assert out.is_contiguous() and tuple(out.shape) == (N_ROWS, N_MELS, frames)
    plain, plain_seq = PF.nemo_log_mel(x, lens, cfg.replace(pallas="off"))
    api_plain = (out.double() - plain.double()).abs().max().item()
    rows = list(range(0, N_ROWS, 8))
    ref64, ref_seq = nemo_ref.log_mel_spectrogram(x[rows].cpu().numpy(), lens_np[rows], N_MELS)
    api_ref = (out[rows].double().cpu() - ref64).abs().max().item()
    plain_ref = (plain[rows].double().cpu() - ref64).abs().max().item()
    assert torch.equal(out_seq, plain_seq) and torch.equal(out_seq[rows].cpu(), ref_seq)
    del plain, ref64
    log(f"nemo at ({N_ROWS}, {samples}), {N_MELS} mels, {int(lens_np.sum())} true samples: "
        f"prologue equal {pro_equal}; K2 vs plain rel {k2_rel:.3e}; finish vs plain "
        f"{fin_err:.3e}; API vs plain path {api_plain:.3e}, vs float64 {api_ref:.3e} (plain "
        f"path vs float64 {plain_ref:.3e}); launches {launches}")
    assert api_plain <= N_PLAIN_TOL and api_ref <= N_PLAIN_TOL, (api_plain, api_ref)

    runs = {"prologue": lambda: nl.nemo_prologue(x, lens, cfg, used),
            "prologue_plain": lambda: nl.nemo_prologue_plain(x, lens, cfg),
            "k2": lambda: k2.ct_mel(xr, cu, used), "k2_plain": lambda: k2.ct_mel_plain(xp, cu),
            "k2_every_frame": lambda: k2.ct_mel(xp, cu),
            "finish": lambda: nl.nemo_finish(power, lens, cfg.frame_step),
            "finish_plain": lambda: nl.nemo_finish_plain(power, lens, cfg.frame_step),
            "api": lambda: P.log_mel_spectrogram_nemo(x, lens, n_mels=N_MELS)}
    times = {name: [] for name in runs}
    for order in (tuple(runs), tuple(reversed(tuple(runs)))):
        for name in order:
            times[name] += cuda_ms(torch, runs[name], 10, flush)
    med = {name: statistics.median(v) for name, v in times.items()}
    true = int(lens_np.sum())
    needed = int(np.minimum(lens_np // cfg.frame_step + 1, frames).sum())
    nnz = int(np.count_nonzero(librosa_ref.mel_filters(RATE, 512, N_MELS)))
    n = cfg.fft_points
    f_all = N_ROWS * frames
    per_frame = n + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * nnz
    tiled = int(np.minimum(-(-(lens_np // cfg.frame_step + 1) // 16) * 16, frames).sum())
    work = {"prologue": (2 * true, 8 * true + 4 * N_ROWS * n),
            "k2": (per_frame * tiled, 4 * (true + N_ROWS * n) + 4 * tiled * N_MELS),
            "finish": (8 * needed * N_MELS, 4 * needed * N_MELS + 4 * f_all * N_MELS)}
    entries = {}
    for name, (flops, nbytes) in work.items():
        bound_s, bound_by = prof.bound_seconds(flops, nbytes, chip)
        entries[name] = {"ms": med[name], "plain_ms": med[f"{name}_plain"],
                         "bound_ms": 1e3 * bound_s, "bound_by": bound_by, "bytes": nbytes,
                         "flops": flops,
                         "hbm_share": nbytes / (med[name] * 1e-3) / (chip["hbm_gbs"] * 1e9),
                         "roofline_share": 1e3 * bound_s / med[name]}
    log("nemo times, median of 20 (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    for name, e in entries.items():
        log(f"nemo {name}: {1e3 * e['ms']:.1f} us (plain {1e3 * e['plain_ms']:.1f} us), "
            f"{e['bytes'] / 1e6:.1f} MB, {100 * e['hbm_share']:.1f}% of HBM, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}), {100 * e['roofline_share']:.2f}% of its "
            f"roofline")
    log(f"nemo: K2 on every frame {1e3 * med['k2_every_frame']:.1f} us, on the "
        f"{tiled} frames of the tiles of each row's own {1e3 * med['k2']:.1f} us")
    log(f"nemo: the frames the answers need, {needed} of {f_all} ({100 * needed / f_all:.1f}%); "
        f"API call {1e3 * med['api']:.1f} us, {true / RATE / (med['api'] * 1e-3):.0f} audio-s/s "
        "of true speech")
    entry = {"name": nl.KERNEL, "route": "cuda",
             "source": "mfcc_rust_tpu_torch/ops/cuda/nemo_logmel.cu", "replaces": None,
             "launches": launches["prologue"] + launches["finish"], "max_err": fin_err,
             "ms": med["prologue"] + med["finish"],
             "plain_ms": med["prologue_plain"] + med["finish_plain"],
             "bound_ms": entries["prologue"]["bound_ms"] + entries["finish"]["bound_ms"],
             "bound_by": "bytes",
             "bytes": work["prologue"][1] + work["finish"][1]}
    record = {"plan": plan, "ptxas": ptxas, "entries": entries, "median_ms": med,
              "times_ms": times, "launches": launches, "shape": [N_ROWS, samples],
              "true_samples": true, "needed_frames": needed,
              "errors": {"k2_rel": k2_rel, "finish": fin_err, "api_vs_plain": api_plain,
                         "api_vs_float64": api_ref, "plain_vs_float64": plain_ref}}
    return entry, record


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
    from mfcc_rust_tpu_torch.ops.cuda import nemo_logmel as kn
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_heads as kh
    from mfcc_rust_tpu_torch.ops.cuda import whisper_logmel as kw

    logs = build.build([k1.KERNEL, k2.KERNEL, kh.KERNEL, kw.KERNEL, kn.KERNEL])
    record["build_s"] = time.perf_counter() - t0
    log(f"build: {k1.KERNEL}, {k2.KERNEL}, {kh.KERNEL}, {kw.KERNEL}, {kn.KERNEL} in "
        f"{record['build_s']:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "entry function")):
                log(f"  ptxas {name}: {line.strip()}")
    lib = k1._lib()
    lib2 = k2._lib()
    for mc in (P.librosa_config(22050), P.librosa_config(16000, n_fft=512, hop_length=160,
                                                         n_mels=80), P.librosa_config(16000, n_fft=768),
               P.librosa_config(22050, hop_length=333), P.librosa_config(8000, n_fft=256, n_mels=40),
               P.librosa_config(16000, n_fft=400, hop_length=160, n_mels=128)):
        _, _, wp, _, km = k2._kernel_constants(mc)
        nnz = wp.size
        g = k2.frames_per_block(mc.fft_points, nnz)
        assert lib2.ct_mel_smem_bytes(mc.fft_points, g, nnz) == \
            k2.smem_bytes(mc.fft_points, g, nnz), "ct_mel smem mirror"
        for warps in (1, 8):
            a = (mc.fft_points, mc.frame_step, km, nnz, mc.num_filters)
            assert lib2.ct_mel_fft_smem_bytes(*a, warps) == k2.fft_smem_bytes(*a, warps), \
                ("ct_mel path-1 / path-3 smem mirror", a, warps)
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
    for a in ((260, 210, 40, 13, 320), (516, 456, 40, 13, 320), (262, 500, 128, 40, 400)):
        assert kh._lib().speechpy_heads_smem_bytes(*a) == kh.smem_bytes(*a), ("heads smem", a)

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
    edge_entry = edges_phase(np, torch, P, PF, flush, chip)
    heads_entry = heads_phase(np, torch, P, PF, flush, chip)
    whisper_entry, record["whisper"] = whisper_phase(np, torch, P, PF, k2, flush, chip,
                                                     logs[k2.KERNEL])
    nemo_entry, record["nemo"] = nemo_phase(np, torch, P, PF, k2, flush, chip, logs[kn.KERNEL])
    record["streaming"] = streaming_phase(np, torch, P, k1, k2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name:
        tmp = Path(tmp_name)
        record["corpus"] = corpus_phase(np, torch, P, k1, k2, tmp)
        record["cli"] = cli_phase(np, torch, P, k1, k2, tmp)
        record["export"] = export_phase(np, torch, P, k1, k2, flush, tmp)
        measured = {"speechpy": audio_s / med["kernel"] * 1e3,
                    "librosa": L_BATCH * SECONDS / k2_entry["ms"] * 1e3}
        record["profiling"] = profiling_phase(np, torch, P, k1, k2, tmp, measured)
    record["entry"] = entry_phase(np, torch, PF, k1, k2)
    record["bench"] = bench_phase(np, torch, k1, k2)
    record["compiled"] = compiled_phase(np, torch, P, k1, k2)
    kernels = [{
        "name": k1.KERNEL, "route": "cuda",
        "source": "mfcc_rust_tpu_torch/ops/cuda/speechpy_mfcc.cu",
        "replaces": "mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py:155",
        "launches": launches, "max_abs_err": headline_abs,
        "ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": med["library"], "path": plan["path"],
        "launches_corpus": record["corpus"]["a"]["turns"]["a_r"]["launches"][0],
        "launches_bench": record["bench"]["launches"][k1.KERNEL],
        "launches_entry": record["entry"]["launches_entry"][0],
        "launches_examples": record["entry"]["launches_examples"][0],
        "launches_compiled": record["compiled"]["launches"][0],
        "launches_streaming": record["streaming"]["launches"][0],
    }, dict(k2_entry, launches_corpus=record["corpus"]["a"]["turns"]["a_r"]["launches"][1],
            launches_bench=record["bench"]["launches"][k2.KERNEL],
            launches_entry=record["entry"]["launches_entry"][1],
            launches_examples=record["entry"]["launches_examples"][1],
            launches_compiled=record["compiled"]["launches"][1],
            launches_streaming=record["streaming"]["launches"][1]),
        {key: v for key, v in edge_entry.items() if key != "times_ms"},
        {key: v for key, v in heads_entry.items() if key != "times_ms"}, whisper_entry,
        nemo_entry]
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
