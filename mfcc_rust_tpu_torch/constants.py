"""Constant builders (pure numpy, float64), and their tensors per device.

The builders are the JAX package's ``constants.py``, kept here as a copy so
that the port imports nothing of that package; ``tests/test_torch_port_imports.py``
pins them array-equal to the originals.  Everything is computed in float64
and cast once per (config, device, dtype) by :func:`bundle_tensor` or
``features._speechpy_tensors``; such caches of tensors take
:func:`tensor_cache`, which stores nothing while a trace runs.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


# ------------------------------------------------------------ tensor caches --
def _tracing() -> bool:
    """A trace is running (``torch.export``, ``torch.compile``, ``make_fx``):
    the tensors made now are fake or symbolic, valid only inside it."""
    return torch.compiler.is_compiling() or torch._guards.detect_fake_mode() is not None


def tensor_cache(maxsize: int):
    """``functools.lru_cache`` for a function that builds tensors, except
    while a trace runs: then the function builds its tensors afresh and the
    cache neither stores nor returns them.  A tensor made inside a trace is
    a fake one, and an eager call that later found it in the cache would
    compute on it."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _tracing():
                return fn(*args, **kwargs)
            return cached(*args, **kwargs)

        call.cache_info = cached.cache_info
        call.cache_clear = cached.cache_clear
        return call

    return wrap


# ------------------------------------------------------------------ windows --
def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / denom)


def hamming_window(n: int, periodic: bool = True) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    i = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * i / denom)


def povey_window(n: int) -> np.ndarray:
    """Kaldi's "povey" window: hann(symmetric)**0.85."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** 0.85


def vorbis_window(n_fft: int) -> np.ndarray:
    """``w[i] = sin(pi/2 * sin(pi/2 * (i+0.5)/(N/2))^2)`` over the full fft
    length."""
    nh = n_fft // 2
    i = np.arange(n_fft, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / nh)
    return np.sin(0.5 * np.pi * s * s)


def window_array(name: str, win_length: int, n_fft: Optional[int] = None) -> np.ndarray:
    """A window of ``win_length`` samples, center-padded to ``n_fft`` when
    given."""
    if name == "rect":
        w = np.ones(win_length, dtype=np.float64)
    elif name == "hann":
        w = hann_window(win_length)
    elif name == "hamming":
        w = hamming_window(win_length)
    elif name == "povey":
        w = povey_window(win_length)
    elif name == "vorbis":
        return vorbis_window(n_fft if n_fft is not None else win_length)
    else:
        raise ValueError(f"unknown window {name!r}")
    if n_fft is not None and n_fft > win_length:
        w = pad_center(w, n_fft)
    return w


def pad_center(w: np.ndarray, size: int) -> np.ndarray:
    if size < len(w):
        raise ValueError(f"target size {size} < input size {len(w)}")
    lpad = (size - len(w)) // 2
    out = np.zeros(size, dtype=w.dtype)
    out[lpad : lpad + len(w)] = w
    return out


# ---------------------------------------------------------------- mel scale --
def hz_to_mel(f, scale: str = "speechpy"):
    f = np.asarray(f, dtype=np.float64)
    if scale == "speechpy":
        return 1127.0 * np.log(1.0 + f / 700.0)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        lin = f / f_sp
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, lin)
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_to_hz(m, scale: str = "speechpy"):
    m = np.asarray(m, dtype=np.float64)
    if scale == "speechpy":
        return 700.0 * (np.exp(m / 1127.0) - 1.0)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        lin = f_sp * m
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), lin)
    raise ValueError(f"unknown mel scale {scale!r}")


# -------------------------------------------------------------- filterbanks --
def speechpy_filterbanks(
    num_filter: int,
    coefficients: int,
    sample_rate: int,
    low_freq: float = 0.0,
    high_freq: Optional[float] = None,
    mel_scale: str = "speechpy",
) -> np.ndarray:
    """speechpy-compatible mel filterbank, shape ``(num_filter,
    coefficients)``, with the integer bin-edge quirk
    ``floor((coefficients+1)*hz/fs)`` and the falling edge winning at the
    apex."""
    fs = float(sample_rate)
    high_freq = fs / 2.0 if high_freq is None else float(high_freq)
    if high_freq > fs / 2.0 + 1e-9:
        raise ValueError(
            "High frequency cannot be greater than half of the sampling frequency!"
        )
    if low_freq < 0.0:
        raise ValueError("low frequency cannot be less than zero!")

    mels = np.linspace(
        hz_to_mel(low_freq, mel_scale), hz_to_mel(high_freq, mel_scale), num_filter + 2
    )
    hertz = mel_to_hz(mels, mel_scale)
    # the bin index is computed in f32, as the reference does
    freq_index = (
        ((coefficients + 1) * hertz.astype(np.float32) / np.float32(fs))
        .astype(np.float64)
    )
    freq_index = np.floor(freq_index).astype(np.int64)

    fbank = np.zeros((num_filter, coefficients), dtype=np.float64)
    for i in range(num_filter):
        left, middle, right = freq_index[i], freq_index[i + 1], freq_index[i + 2]
        for j in range(left, min(right, coefficients)):
            if j <= middle and middle != left:
                fbank[i, j] = (j - left) / float(middle - left)
            if middle <= j and right != middle:
                fbank[i, j] = (right - j) / float(right - middle)
    return fbank


def librosa_filterbanks(
    num_filter: int,
    n_fft: int,
    sample_rate: int,
    low_freq: float = 0.0,
    high_freq: Optional[float] = None,
    mel_scale: str = "slaney",
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """librosa-compatible mel filterbank, shape ``(num_filter, 1+n_fft//2)``."""
    fs = float(sample_rate)
    high_freq = fs / 2.0 if high_freq is None else float(high_freq)
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, fs / 2.0, n_freq)
    mels = np.linspace(
        hz_to_mel(low_freq, mel_scale), hz_to_mel(high_freq, mel_scale), num_filter + 2
    )
    mel_f = mel_to_hz(mels, mel_scale)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : num_filter + 2] - mel_f[:num_filter])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unknown fbank norm {norm!r}")
    return weights


# ---------------------------------------------------------------- DCT / DFT --
def dct_matrix(n: int, n_out: Optional[int] = None, norm: str = "ortho") -> np.ndarray:
    """DCT-II as an ``(n, n_out)`` matrix so that ``x @ D == dct(x)[:n_out]``
    (scipy ``norm='ortho'`` scaling)."""
    n_out = n if n_out is None else n_out
    k = np.arange(n_out, dtype=np.float64)[None, :]
    i = np.arange(n, dtype=np.float64)[:, None]
    d = 2.0 * np.cos(np.pi * k * (2.0 * i + 1.0) / (2.0 * n))
    if norm == "ortho":
        scale = np.full((1, n_out), math.sqrt(1.0 / (2.0 * n)))
        if n_out > 0:
            scale[0, 0] = math.sqrt(1.0 / (4.0 * n))
        d = d * scale
    elif norm is not None:
        raise ValueError(f"unknown dct norm {norm!r}")
    return d


def idct_matrix(n: int, n_in: Optional[int] = None) -> np.ndarray:
    """Orthonormal DCT-III, the inverse of :func:`dct_matrix` with the ortho
    norm, shape ``(n_in, n)``."""
    return dct_matrix(n, n_in).T


def rdft_matrices(
    n_fft: int,
    frame_len: Optional[int] = None,
    window: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT as two ``(frame_len, n_fft//2+1)`` matrices (cos, -sin) so
    that ``X = frames @ C + 1j * frames @ S`` equals ``rfft(frames * w,
    n_fft)``."""
    frame_len = n_fft if frame_len is None else frame_len
    n_freq = n_fft // 2 + 1
    n_arr = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n_arr * k / n_fft
    c = np.cos(ang)
    s = -np.sin(ang)
    if window is not None:
        w = np.asarray(window, dtype=np.float64)[:frame_len, None]
        c = c * w
        s = s * w
    return c, s


# ----------------------------------------------------------- config bundles --
@functools.lru_cache(maxsize=64)
def constant_bundle(cfg) -> dict:
    """All precomputed float64 constants for a config (memoized)."""
    out = {}
    n_fft = cfg.fft_points
    if cfg.fbank_style == "speechpy":
        fb = speechpy_filterbanks(
            cfg.num_filters,
            cfg.freq_size,
            cfg.sample_rate,
            cfg.low_frequency,
            cfg.resolved_high_frequency,
            mel_scale=cfg.mel_scale,
        )
    elif cfg.fbank_style == "librosa":
        fb = librosa_filterbanks(
            cfg.num_filters,
            n_fft,
            cfg.sample_rate,
            cfg.low_frequency,
            cfg.resolved_high_frequency,
            mel_scale=cfg.mel_scale,
            norm=cfg.fbank_norm,
        )
    else:
        raise ValueError(f"unknown fbank_style {cfg.fbank_style!r}")
    out["fbank"] = fb

    # three framing regimes: vorbis (fft-long frames, vorbis window),
    # centered librosa (fft-long frames, window center-padded), speechpy
    # (frame_size frames; the rFFT's zero padding is folded into the DFT
    # matrix by truncating its rows)
    if cfg.window == "vorbis":
        frame_len = n_fft
        win = vorbis_window(n_fft)
    elif cfg.center:
        frame_len = n_fft
        win = window_array(cfg.window, cfg.win_length, n_fft)
    else:
        frame_len = min(cfg.frame_size, n_fft)
        win = window_array(cfg.window, min(cfg.win_length, frame_len))
        if len(win) < frame_len:
            if frame_len == n_fft:
                win = pad_center(win, frame_len)
            else:
                win = np.concatenate([win, np.zeros(frame_len - len(win))])
    out["window"] = win
    out["frame_len"] = frame_len
    out["dct"] = dct_matrix(cfg.num_filters, cfg.num_cepstral)
    out["dct_full"] = dct_matrix(cfg.num_filters, cfg.num_filters)
    out["dft"] = rdft_matrices(n_fft, frame_len)
    out["dft_windowed"] = rdft_matrices(n_fft, frame_len, win)
    # speechpy's (K+1)-quirk banks span only the lower half-spectrum, so the
    # DFT product is trimmed to the last bin any filter touches
    nonzero_cols = np.nonzero(fb.any(axis=0))[0]
    out["fbank_kmax"] = int(nonzero_cols[-1]) + 1 if len(nonzero_cols) else fb.shape[1]
    return out


def chunk_gemm_wall(cfg, want_energy: bool, lane_align: Optional[int] = None) -> dict:
    """The chunk-GEMM constant shared by the plain chunked path and the fused
    kernel: columns ``[C_trim | S_trim (| w | ±w)]``, rows zero-padded up to
    ``r = ceil(fl/hop)`` whole hops.

    Returns dict(wall (r*hop, W) float64, kmax, kpad, r, fl, hop, w, w2)."""
    bundle = constant_bundle(cfg)
    kmax = bundle["fbank_kmax"]
    c64, s64 = bundle["dft_windowed" if cfg.window != "rect" else "dft"]
    win = bundle["window"]
    fl = c64.shape[0]
    hop = cfg.frame_step
    if fl < hop:
        raise ValueError(f"chunked lowering requires frame {fl} >= hop {hop}")
    # hop-misaligned frames (25 ms / 10 ms -> 400/160): the zero rows
    # multiply out-of-frame samples by zero weight
    r = -(-fl // hop)
    fl_pad = r * hop

    def _align(x: int) -> int:
        return x if lane_align is None else ((x + lane_align - 1) // lane_align) * lane_align

    kpad = _align(kmax)
    c = np.zeros((fl_pad, kpad))
    s = np.zeros((fl_pad, kpad))
    c[:fl, :kmax] = c64[:, :kmax]
    s[:fl, :kmax] = s64[:, :kmax]
    cols = [c, s]
    w = win[:fl] if cfg.window != "rect" else np.ones(fl)
    wp = np.zeros(fl_pad)
    wp[:fl] = w
    if want_energy:
        alt = wp * ((-1.0) ** np.arange(fl_pad))
        cols += [wp[:, None], alt[:, None]]
    wall = np.concatenate(cols, axis=1)
    if lane_align is not None and wall.shape[1] % lane_align:
        wall = np.pad(wall, [(0, 0), (0, _align(wall.shape[1]) - wall.shape[1])])
    return {
        "wall": wall, "kmax": kmax, "kpad": kpad, "r": r, "fl": fl,
        "hop": hop, "w": w, "w2": (wp * wp).reshape(r, hop),
    }


@functools.lru_cache(maxsize=64)
def vorbis_chunk_wall(cfg) -> dict:
    """The vorbis-STFT chunk-GEMM constant: ``[C_trim | S_trim]`` windowed
    DFT columns with rows zero-padded to a stream-hop multiple, plus the
    filterbank stacked over both blocks with wnorm^2 folded in.  Returns
    dict(wall (r*hop, 2*kmax), fb2 (2*kmax, M), r, hop)."""
    bundle = constant_bundle(cfg)
    kmax = bundle["fbank_kmax"]
    c64, s64 = bundle["dft_windowed"]
    hop = cfg.stream_hop
    n = cfg.fft_points
    wall = np.concatenate([c64[:, :kmax], s64[:, :kmax]], axis=1)
    rows = math.ceil(n / hop) * hop
    wall = np.pad(wall, [(0, rows - n), (0, 0)])
    w2 = cfg.wnorm * cfg.wnorm
    fb = bundle["fbank"][:, :kmax].T * w2
    fb2 = np.concatenate([fb, fb], axis=0)
    return {"wall": wall, "fb2": fb2, "r": rows // hop, "hop": hop}


@tensor_cache(maxsize=64)
def bundle_tensor(cfg, key: str, device: torch.device, dtype: torch.dtype):
    """One entry of :func:`constant_bundle` as a tensor (a pair for the DFT
    entries)."""
    v = constant_bundle(cfg)[key]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(t(a) for a in v) if isinstance(v, tuple) else t(v)
