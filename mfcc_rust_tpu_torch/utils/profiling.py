"""Profiling and the work model (port of ``mfcc_rust_tpu.utils.profiling``).

* :class:`Meter` accumulates named wall-clock scopes with audio-seconds
  throughput accounting, free-form counters (transfer bytes, dispatch and
  fetch counts) and per-call spans whose union gives the time a kind of
  call kept busy, overlapping calls counted once.  The host clock around
  an asynchronous CUDA call measures its enqueue, so device times come from
  CUDA events (``chip_smoke.py``) or from :func:`trace`.
* :func:`span` (and :func:`annotate`, the same): a named scope of the
  program's call path, as a context manager or a decorator.  It costs next
  to nothing while nothing records; inside :func:`spans` it records its
  interval on the host clock, nested under the span that encloses it on its
  thread, all of one outermost call under one id; under a running
  ``torch.profiler`` (or ``torch.autograd.profiler.emit_nvtx``) it is also
  a ``record_function`` scope of the trace (an NVTX range).
* :func:`trace`: a ``torch.profiler`` trace that TensorBoard or
  ``chrome://tracing`` opens.
* The work model: :func:`chip_spec` (the card's peaks from NVIDIA's data
  sheets), :func:`work` / :func:`kernel_work` (operations and bytes of one
  call of a feature, counted for the lowering the port dispatches),
  :func:`pipeline_costs` (the same per audio-second) and
  :func:`speed_of_light` (the bound they give on the card).  The JAX
  package's model is of a TPU v5e, with measured v5e constants; none of it
  is carried over, only what it is for: a count of the work that does not
  depend on what implements it, and the least time the card needs for it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..config import FeatureConfig


@dataclass
class Meter:
    """Accumulating throughput meter: audio-seconds per wall second, plus
    free-form counters (transfer bytes, fetch/dispatch counts)."""

    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    batches: int = 0
    scopes: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    # per-call wall-clock spans [(name, t0, t1)]; list.append is atomic
    # under the GIL, so pool threads record theirs too
    spans: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, audio_seconds: float, scope: str = "extract"):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.audio_seconds += audio_seconds
        self.wall_seconds += dt
        self.batches += 1
        self.scopes[scope] = self.scopes.get(scope, 0.0) + dt

    @contextlib.contextmanager
    def span(self, name: str):
        """Record a named wall-clock interval (absolute perf_counter times).
        Unlike :meth:`measure`, spans keep per-call start/end so overlap and
        busy unions are computable afterwards."""
        t0 = time.perf_counter()
        yield
        self.spans.append((name, t0, time.perf_counter()))

    def span_union(self, *names: str) -> float:
        """Total seconds covered by the union of the named spans (merged
        intervals — concurrent calls do not double-count)."""
        want = set(names)
        ivs = sorted((t0, t1) for n, t0, t1 in self.spans if n in want)
        total, cur1 = 0.0, None
        cur0 = None
        for a, b in ivs:
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    total += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            total += cur1 - cur0
        return total

    def bump(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @property
    def throughput(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def report(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "audio_seconds_per_sec": round(self.throughput, 1),
            "batches": self.batches,
            "scopes": {k: round(v, 4) for k, v in self.scopes.items()},
            "counters": {k: round(v, 1) for k, v in self.counters.items()},
        }

    def __str__(self) -> str:
        return json.dumps(self.report())


# ------------------------------------------------------------------ tracing --
@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block: CPU activity, plus CUDA when
    CUDA is available.  On exit it writes ``<host>_<pid>.<time>.pt.trace.json``
    into ``log_dir`` (default ``$TMPDIR/mfcc_torch_trace``), which
    TensorBoard's profiler plugin or ``chrome://tracing`` opens; yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "mfcc_torch_trace")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


# -------------------------------------------------------------------- spans --
_MAX_IDLE = 1024  # names whose idle span is kept for reuse

_profiler_enabled = torch._C._autograd._profiler_enabled
_recorder: Optional["Recorder"] = None
_local = threading.local()  # .top: the innermost recorded span open on the thread
_call_ids = itertools.count(1)
_idle: dict = {}  # name -> its _Idle span


class Recorder:
    """The spans begun while :func:`spans` was open, on every thread:
    ``records``, the :class:`Span` objects in the order they began, at
    most ``limit`` of them; ``dropped`` counts those begun past it."""

    def __init__(self, limit: int):
        self.limit = limit
        self.records: list = []
        self.dropped = 0
        self._room = iter(range(limit))  # next() on it is one atomic step
        self._lock = threading.Lock()

    def _drop(self) -> None:
        with self._lock:
            self.dropped += 1


@contextlib.contextmanager
def spans(limit: int = 100_000):
    """Record every span begun inside, on every thread, in the
    :class:`Recorder` it yields; in memory, nothing is written."""
    global _recorder
    rec, saved = Recorder(limit), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = saved


def recording() -> bool:
    """Whether a span begun now does anything: :func:`spans` is open or a
    profiler runs."""
    return _recorder is not None or _profiler_enabled()


class _Scope:
    """A named span: a context manager, and a decorator whose function
    runs in ``span(name)`` at every call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def in_span(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return in_span


class _Idle(_Scope):
    """A span while nothing records: entering and leaving it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


class Span(_Scope):
    """A span while :func:`spans` is open or a profiler runs, entered once.
    Entered inside :func:`spans` it is its own record: ``name``; ``call``,
    the id of the call its outermost span began; ``parent``, the span that
    enclosed it on its thread when it began (None for the outermost);
    ``t0_ns`` and ``t1_ns`` on ``time.perf_counter_ns()`` (``t1_ns`` None
    while it is open); ``thread``, ``threading.get_ident()``.  Under a
    profiler it is also a ``torch.profiler.record_function`` scope."""

    __slots__ = ("call", "parent", "t0_ns", "t1_ns", "thread", "_scope")

    def __enter__(self):
        self._scope = self.parent = self.thread = self.t1_ns = None
        if _profiler_enabled():
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        rec = _recorder
        if rec is not None:
            parent = self.parent = getattr(_local, "top", None)
            if parent is None:
                self.call, self.thread = next(_call_ids), threading.get_ident()
            else:
                self.call, self.thread = parent.call, parent.thread
            _local.top = self
            if next(rec._room, None) is None:
                rec._drop()
            else:
                rec.records.append(self)
            self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.thread is not None:  # recorded
            self.t1_ns = time.perf_counter_ns()
            _local.top = self.parent
        if self._scope is not None:
            self._scope.__exit__(exc_type, exc, tb)
        return False

    def __iter__(self):
        """(name, call, parent, t0_ns, t1_ns, thread)."""
        return iter((self.name, self.call, self.parent, self.t0_ns, self.t1_ns, self.thread))


def span(name: str):
    """The span ``name``: ``with span(name): ...`` or ``@span(name)``.

    While :func:`spans` is open it records a :class:`Span` of its
    interval; while a ``torch.profiler`` runs it is a
    ``torch.profiler.record_function`` scope of the trace, on the trace's
    clock, and under ``torch.autograd.profiler.emit_nvtx`` an NVTX range.
    Otherwise it is the name's one idle span, which does nothing and
    allocates nothing."""
    if _recorder is None and not _profiler_enabled():
        idle = _idle.get(name)
        if idle is None:
            idle = _Idle(name)
            if len(_idle) < _MAX_IDLE:
                _idle[name] = idle
        return idle
    return Span(name)


# the JAX package's ``annotate``: a user's scopes are recorded and traced as
# the program's own spans
annotate = span


# ---------------------------------------------------------------- chip spec --
# NVIDIA's data sheets: FP32 outside the tensor cores (the port computes in
# IEEE FP32 throughout, so no tensor-core or TF32 rate applies) and HBM rate
CHIP_SPECS = {
    "H100 SXM": {"fp32_tflops": 67.0, "hbm_gbs": 3350.0},
    "H100 PCIe": {"fp32_tflops": 51.0, "hbm_gbs": 2000.0},
}


def chip_spec(device_name: Optional[str] = None) -> dict:
    """Peak FP32 FLOP/s and HBM bytes/s of the card named ``device_name``
    (default: ``torch.cuda.get_device_name()``): keys ``fp32_tflops``,
    ``hbm_gbs``, ``chip``.  The H100 SXM5 reports itself as "NVIDIA H100
    80GB HBM3", the PCIe card as "NVIDIA H100 PCIe"; any other name takes
    the SXM entry as ``"H100 SXM (assumed)"``."""
    if device_name is None and torch.cuda.is_available():
        device_name = torch.cuda.get_device_name()
    name = (device_name or "").lower()
    if "h100" in name and "pcie" in name:
        return dict(CHIP_SPECS["H100 PCIe"], chip="H100 PCIe")
    if "h100" in name and ("hbm3" in name or "sxm" in name):
        return dict(CHIP_SPECS["H100 SXM"], chip="H100 SXM")
    return dict(CHIP_SPECS["H100 SXM"], chip="H100 SXM (assumed)")


def bound_seconds(flops: float, nbytes: float, spec: Optional[dict] = None) -> tuple:
    """(the least seconds the card needs, "operations" or "bytes"): the
    larger of the operations over the FP32 peak and the bytes over the HBM
    rate."""
    spec = chip_spec() if spec is None else spec
    t_ops = flops / (spec["fp32_tflops"] * 1e12)
    t_bytes = nbytes / (spec["hbm_gbs"] * 1e9)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------- kernel work counts --
# operations of fft_regs.cuh's dft<R>: the halves, the W_R^k products that
# are not 1 or -i (6 each), the butterflies (4 each); of its dft5: 20 adds,
# 12 multiply-adds and 4 products
DFT_OPS = {2: 4.0, 4: 16.0, 5: 48.0, 8: 56.0, 16: 180.0, 32: 508.0}


def k2_work_stockham(cfg: FeatureConfig, batch: int, t: int) -> tuple:
    """(operations, bytes) of one ct_mel call on (batch, t) uncentred
    samples, counted from the design of K2's path 2 (v4, ct_mel.cu's
    ct_mel_kernel), a multiply-add as two: the window, the Stockham stages
    (a twiddle only where k != 0), the real split and power of the kmax bins
    the filterbank needs, and the projection over each filter's nonzero
    bins; every input read once, the output written once."""
    from ..ops.cuda import ct_mel as k2

    n, hop, m = cfg.fft_points, cfg.frame_step, cfg.num_filters
    nc = n // 2
    m_odd, n4, has2 = k2.fft_plan(n)
    _, _, wpack, _, kmax = k2._kernel_constants(cfg)
    frames = batch * max(1 + (t - n) // hop, 0)
    per_frame, ns = float(n), 1
    if m_odd > 1:
        per_frame += 8.0 * nc * m_odd  # complex multiply-add per term
        ns *= m_odd
    for radix in [4] * n4 + [2] * has2:
        twiddled = (ns - 1) / ns  # butterflies with k = j % ns != 0
        per_frame += nc / radix * (2.0 * radix * (radix // 2) + 6.0 * (radix - 1) * twiddled)
        ns *= radix
    per_frame += 19.0 * kmax + 2.0 * wpack.size
    nbytes = 4.0 * (batch * t + frames * m + 3 * n + wpack.size) + 12.0 * m
    return frames * per_frame, nbytes


def k2_work(cfg: FeatureConfig, batch: int, t: int) -> tuple:
    """(operations, bytes) of one ct_mel call on (batch, t) uncentred
    samples, counted from the design of the path K2 takes: path 2 as
    :func:`k2_work_stockham` counts; path 1 the window, the register passes
    (every input after the first pass times its twiddle; at nc = 1024 the 31
    products a lane that make the last pass's twiddles, and W_n^k of the
    split as a product of two), the real split and power of the kmax bins,
    and the projection over each filter's nonzero bins; path 3 the window,
    on each of 8 lanes ten 5-point DFTs, 16 W_25 and 24 W_200 twiddles and
    three lane stages over 25 points (two multiply-adds, then a twiddle but
    after the last), the split, power and projection as path 1's.  Bytes as
    path 2's.  A design's count is not the least the function needs:
    :func:`work`'s ``least_flops`` takes the least of this and the
    Stockham count."""
    from ..ops.cuda import ct_mel as k2

    path = k2.path_for(cfg)
    if path == 2:
        return k2_work_stockham(cfg, batch, t)
    n, hop = cfg.fft_points, cfg.frame_step
    nc = n // 2
    _, _, wpack, _, kmax = k2._kernel_constants(cfg)
    frames = batch * max(1 + (t - n) // hop, 0)
    if path == 3:
        lane = 10 * DFT_OPS[5] + 6.0 * (16 + 24) + 25 * (4.0 + 6.0 + 4.0 + 6.0 + 4.0)
        per_frame = n + 8 * lane + 19.0 * kmax + 2.0 * wpack.size
        return frames * per_frame, k2_work_stockham(cfg, batch, t)[1]
    radices = (32, 32) if nc == 1024 else (8, 8) + ((nc // 64,) if nc > 64 else ())
    per_frame, ns = float(n), 1
    for radix in radices:
        per_frame += nc / radix * (DFT_OPS[radix] + (6.0 * (radix - 1) if ns > 1 else 0.0))
        ns *= radix
    per_frame += 19.0 * kmax + 2.0 * wpack.size
    if nc == 1024:
        per_frame += 32 * 31 * 6.0 + 6.0 * kmax
    return frames * per_frame, k2_work_stockham(cfg, batch, t)[1]


def k1_work(cfg: FeatureConfig, batch: int, t: int) -> tuple:
    """(operations, bytes) of one speechpy_mfcc call on (batch, t) samples,
    counted from K1's own design (speechpy_mfcc.cu), a multiply-add as two:
    the sum of squares, the FFT passes (path 1 multiplies every input after
    the first pass by its twiddle, path 2 only where k != 0, as
    :func:`k2_work` counts), the real split and power of the kmax bins, the
    projection over each filter's nonzero bins and the DCT; every input read
    once, the output written once."""
    from ..ops.cuda import speechpy_mfcc as k1

    n, hop, fl = cfg.fft_points, cfg.frame_step, cfg.frame_size
    m, c = cfg.num_filters, cfg.num_cepstral
    nc = n // 2
    _, wpack, _, _, kmax = k1._kernel_constants(cfg)
    frames = batch * max((t - fl) // hop, 0)
    butterfly = {2: 4.0, 4: 16.0, 8: 56.0}
    per_frame, ns = 2.0 * fl, 1
    for radix in k1.stage_plan(n):
        if radix in butterfly:
            if k1.fft_path(n) == 1:
                twiddled = 1.0 if ns > 1 else 0.0
            else:
                twiddled = (ns - 1) / ns
            per_frame += nc / radix * (butterfly[radix] + 6.0 * (radix - 1) * twiddled)
        else:
            per_frame += 8.0 * nc * radix  # the odd part's direct DFT
        ns *= radix
    per_frame += 19.0 * kmax + 2.0 * wpack.size
    per_frame += 2.0 * m * (c - 1 if cfg.dc_elimination else c) + 8.0
    nbytes = 4.0 * (batch * t + frames * c + 2 * n + wpack.size + 3 * m + m * c)
    return frames * per_frame, nbytes


# ------------------------------------------------- plain lowerings' products --
SPEECHPY_FEATURES = ("mfcc", "mfe", "lmfe", "ssc")
LIBROSA_FEATURES = ("mel_spectrogram_librosa", "mfcc_librosa", "log_mel_spectrogram")


def _rdft_products(cfg: FeatureConfig, rows: int, frame_len: int) -> list:
    """The products of ``ops.spectrum.rdft`` on ``rows`` frames of
    ``frame_len`` samples: the cos and sin products (matmul), the two CT
    stages (ct), none (fft: cuFFT, not a product).  Each (rows, k, n)."""
    from ..ops.fft import good_factorization
    from ..ops.spectrum import resolve_fft_impl

    impl = resolve_fft_impl(cfg)
    kk = cfg.fft_points // 2 + 1
    if impl == "matmul":
        return [(rows, frame_len, 2 * kk)]
    if impl == "ct":
        n1, n2 = good_factorization(cfg.fft_points)
        k1 = n1 // 2 + 1
        return [(rows * 2 * n2, n2, n1), (rows * n2, 2 * n1, 2 * k1)]
    return []


def _speechpy_products(cfg: FeatureConfig, want: set, lowering: str, b: int,
                       frames: int) -> tuple:
    """(products, constant elements) of the speechpy heads ``want`` on b
    rows of ``frames`` frames."""
    from ..constants import chunk_gemm_wall

    m, c = cfg.num_filters, cfg.num_cepstral
    rows = b * frames
    mel_heads = bool(want & {"mfcc", "lmfe", "mfe", "energy"})
    prods, consts = [], 0
    if lowering.startswith("chunk-gemm"):
        wd = chunk_gemm_wall(cfg, True)
        rk, w = wd["wall"].shape
        kmax = wd["kmax"]
        r, hop = wd["r"], cfg.frame_step
        prods.append((rows, rk, w))
        consts += rk * w
        unit = cfg.frame_size % hop == 0 and cfg.window == "rect"
        if lowering == "chunk-gemm":  # the single heads: mfe() always wants energies
            need_energy = mel_heads
        else:
            need_energy = bool(want & {"mfe", "energy"}) or ("mfcc" in want and cfg.dc_elimination)
        if need_energy and not unit:  # one (hop, r) product a hop chunk
            prods.append((b * (frames + r - 1), hop, r))
            consts += r * hop
        if want & {"mfcc", "lmfe", "mfe"}:
            prods.append((rows, w, m))
            consts += w * m
        if "ssc" in want:
            prods.append((rows, kmax, 2 * m))
            consts += kmax * 2 * m
    else:  # the gather fallback: framed power spectrum, then the heads
        kk = cfg.freq_size
        fl = cfg.frame_size
        rdft = _rdft_products(cfg, rows, fl)
        # the mel heads (mfe) and ssc each frame and transform the signal
        prods += rdft * (mel_heads + ("ssc" in want))
        consts += fl * 2 * kk if rdft else 0
        if mel_heads:
            prods.append((rows, kk, m))
        if "ssc" in want:
            prods += [(rows, kk, m), (rows, kk, m)]
        consts += kk * m
    if "mfcc" in want:
        prods.append((rows, m, c))
        consts += m * c
    return prods, consts


def _output_elems(cfg: FeatureConfig, want, b: int, frames: int) -> int:
    m, c = cfg.num_filters, cfg.num_cepstral
    per = {"mfcc": c, "lmfe": m, "ssc": m, "mfe": m + 1, "energy": 1}
    return b * frames * sum(per[h] for h in want)


def work(cfg: FeatureConfig, feature="mfcc", batch: int = 1, samples: Optional[int] = None,
         device_type: str = "cuda") -> dict:
    """The work of one call of ``features.<feature>`` on a (batch, samples)
    tensor of ``cfg.dtype`` on ``device_type`` (``samples`` default: one
    second), for the lowering the port dispatches there
    (``features.speechpy_lowering``, ``vorbis_lowering``,
    ``librosa_lowering``).  ``feature`` is a name of :mod:`..features` or a
    tuple of speechpy heads (``extract``).

    Keys: ``lowering``; ``frames`` per row; ``flops``, a multiply-add as
    two; ``least_flops``, the least count known for the function (K2: the
    least of its two designs; elsewhere ``flops``); ``bytes``, the input
    read once, the output written once and the constants; ``gemms``, the
    products of a lowering without a kernel as (k, n, per frame): a (k, n)
    product per frame and row that many times.

    A kernel (K1, K2) is counted from its design: every operation it does,
    the FFT's included (:func:`k1_work`, :func:`k2_work`).  A lowering
    without a kernel is counted by its products alone, from the shapes of
    the constants it multiplies (``constants.chunk_gemm_wall``,
    ``vorbis_chunk_wall``, ``features._librosa_tensors``, the CT stage
    matrices); its elementwise work (squares, logs, the window) is not
    counted, and cuFFT's transform (``fft_impl="fft"``) is not a product."""
    from .. import features as F
    from ..constants import constant_bundle, vorbis_chunk_wall
    from ..ops.fft import good_factorization, permute_weights_for_ct
    from ..ops.framing import speechpy_frame_counts

    samples = cfg.sample_rate if samples is None else int(samples)
    b = int(batch)
    dtype = getattr(torch, cfg.dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    m = cfg.num_filters
    heads = tuple(feature) if isinstance(feature, (tuple, list)) else None
    if heads is not None or feature in SPEECHPY_FEATURES:
        low = F.speechpy_lowering(cfg, heads or feature, device_type, dtype)
        fl = min(cfg.frame_size, cfg.fft_points)
        frames = speechpy_frame_counts(samples, fl, cfg.frame_step, False)[0]
        if low == "k1":
            flops, nbytes = k1_work(cfg, b, samples)
            return {"lowering": low, "frames": frames, "flops": flops, "least_flops": flops,
                    "bytes": nbytes, "gemms": None}
        want = set(heads or (feature,))
        prods, consts = _speechpy_products(cfg, want, low, b, frames)
        out = _output_elems(cfg, want, b, frames)
    elif feature == "mel_spectrogram":
        vcfg = cfg.replace(window="vorbis") if cfg.window != "vorbis" else cfg
        low = F.vorbis_lowering(vcfg)
        frames = -(-samples // vcfg.stream_hop)
        rows = b * frames
        if low == "vorbis-chunk-gemm":
            vw = vorbis_chunk_wall(vcfg)
            rk, w2k = vw["wall"].shape
            prods = [(rows, rk, w2k), (rows, w2k, m)]
            consts = rk * w2k + w2k * m
        else:
            kk = vcfg.freq_size
            prods = _rdft_products(vcfg, rows, vcfg.fft_points) + [(rows, kk, m)]
            consts = kk * m + vcfg.fft_points
        out = rows * m
    elif feature in LIBROSA_FEATURES:
        low = F.librosa_lowering(cfg, device_type, dtype)
        n, hop = cfg.fft_points, cfg.frame_step
        t = samples + 2 * (n // 2) if cfg.center else samples
        frames = max(1 + (t - n) // hop, 0)
        rows = b * frames
        c = cfg.num_cepstral
        tail, tail_consts = [], 0
        if feature == "mfcc_librosa":
            tail, tail_consts = [(rows, m, c)], m * c
        if low == "k2":
            ucfg = cfg.replace(center=False)
            flops, nbytes = k2_work(ucfg, b, t)
            least = min(flops, k2_work_stockham(ucfg, b, t)[0])
            extra = sum(2.0 * p * k * q for p, k, q in tail)
            if tail:  # the DCT reads the mel back and writes the cepstra
                nbytes += esize * (rows * m + tail_consts + rows * c)
            return {"lowering": low, "frames": frames, "flops": flops + extra,
                    "least_flops": least + extra, "bytes": nbytes, "gemms": None}
        kmax = constant_bundle(cfg)["fbank_kmax"]
        if low in ("librosa-chunk-gemm", "librosa-hoppad"):
            rk = -(-n // hop) * hop
            kin = 2 * kmax if cfg.power == 2.0 else kmax
            prods = [(rows, rk, 2 * kmax), (rows, kin, m)]
            consts = rk * 2 * kmax + kin * m
        elif low == "librosa-ct":
            n1, n2 = good_factorization(n)
            proj = permute_weights_for_ct(constant_bundle(cfg)["fbank"], n, (n1, n2))
            k1max = proj.shape[1] // n2
            prods = [(rows * 2 * n2, n2, n1), (rows * n2, n1, 2 * k1max),
                     (rows * n2, n1, 2 * k1max), (rows, n2 * k1max, m)]
            consts = n + 2 * n2 * n2 + 2 * n2 * n1 * 2 * k1max + n2 * k1max * m
        else:
            kk = cfg.freq_size
            prods = _rdft_products(cfg, rows, n) + [(rows, kk, m)]
            consts = kk * m + n
        prods += tail
        consts += tail_consts
        out = rows * (c if feature == "mfcc_librosa" else m)
    else:
        raise ValueError(f"unknown feature {feature!r}")
    flops = sum(2.0 * p * k * q for p, k, q in prods)
    per_frame = max(b * frames, 1)
    return {"lowering": low, "frames": frames, "flops": flops, "least_flops": flops,
            "bytes": float(esize * (b * samples + out + consts)),
            "gemms": [(k, q, p / per_frame) for p, k, q in prods]}


def kernel_work(cfg: FeatureConfig, feature="mfcc", batch: int = 1,
                samples: Optional[int] = None, device_type: str = "cuda") -> tuple:
    """(flops, bytes) of one call of ``features.<feature>`` on (batch,
    samples), as :func:`work` counts them."""
    w = work(cfg, feature, batch, samples, device_type)
    return w["flops"], w["bytes"]


def pipeline_costs(cfg: FeatureConfig, feature="mfcc", device_type: str = "cuda") -> dict:
    """Per audio-second costs of the lowering the port dispatches for
    (cfg, feature) on ``device_type``: :func:`work` of one call on one second
    of audio (batch 1), so a call's constants are charged to its second.
    Keys: ``lowering``, ``frames_per_audio_second``,
    ``flops_per_audio_second``, ``least_flops_per_audio_second``,
    ``hbm_bytes_per_audio_second`` and, for the lowerings without a kernel,
    ``gemms_per_frame``."""
    w = work(cfg, feature, 1, cfg.sample_rate, device_type)
    out = {
        "lowering": w["lowering"],
        "frames_per_audio_second": w["frames"],
        "flops_per_audio_second": w["flops"],
        "least_flops_per_audio_second": w["least_flops"],
        "hbm_bytes_per_audio_second": w["bytes"],
    }
    if w["gemms"] is not None:
        out["gemms_per_frame"] = w["gemms"]
    return out


def speed_of_light(cfg: FeatureConfig, feature="mfcc", device_name: Optional[str] = None,
                   spec: Optional[dict] = None) -> dict:
    """Audio-seconds per second that the card cannot exceed for (cfg,
    feature) on CUDA: the least operation count over the FP32 peak
    (``compute_bound_audio_s_per_s``), the bytes over the HBM rate
    (``bandwidth_bound_audio_s_per_s``) and the smaller of the two
    (``speed_of_light_audio_s_per_s``), with the ``lowering`` and the
    ``chip`` (:func:`chip_spec` of ``device_name`` unless ``spec`` is
    given).  A measured rate over it is the share of the bound achieved."""
    costs = pipeline_costs(cfg, feature, "cuda")
    spec = chip_spec(device_name) if spec is None else spec
    t_ops = costs["least_flops_per_audio_second"] / (spec["fp32_tflops"] * 1e12)
    t_bytes = costs["hbm_bytes_per_audio_second"] / (spec["hbm_gbs"] * 1e9)
    compute = 1.0 / t_ops if t_ops else math.inf
    bandwidth = 1.0 / t_bytes if t_bytes else math.inf
    return {
        "lowering": costs["lowering"],
        "chip": spec.get("chip", "?"),
        "compute_bound_audio_s_per_s": compute,
        "bandwidth_bound_audio_s_per_s": bandwidth,
        "speed_of_light_audio_s_per_s": min(compute, bandwidth),
    }
