"""Feature pipelines on tensors (port of ``mfcc_rust_tpu.features``: the
speechpy MFE / log-MFE / MFCC part and the librosa mel / log-mel / MFCC
part).

Every function is a plain function of ``(signal, cfg)`` over arbitrary
leading batch dims, computing in the signal's dtype on the signal's device.
The default lowering never builds the frame matrix: framing folds into one
product with the chunk-GEMM wall (``_chunk_gemm``), the DFT is trimmed to the
filterbank's support, and frame energies come from Parseval columns of the
same product.  On a CUDA float32 tensor ``mfcc`` runs the fused kernel
(``ops/cuda/speechpy_mfcc``) and ``mel_spectrogram_librosa`` the CT mel
kernel (``ops/cuda/ct_mel``); everywhere else they run the plain paths,
which the kernels are held against.

``consts`` (optional) is a dict of the chunk-GEMM constant tensors
(:func:`_speechpy_tensors`); the pipelines pass their buffers through it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from .config import FeatureConfig, fp32_matmul
from .constants import chunk_gemm_wall, constant_bundle
from .ops import framing as _framing
from .ops import stft as _stft
from .ops.dct import dct2_ortho
from .ops.fft import ct_power_project, good_factorization, permute_weights_for_ct
from .ops.mel import apply_filterbank, mel_project_time_major
from .ops.spectrum import power_spectrum, power_to_db, resolve_fft_impl, zero_handling


def _speechpy_frames(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """speechpy mfe framing: rectangular window, zero_padding=False."""
    if cfg.preemphasis_cof:
        signal = _framing.preemphasis(signal, 1, cfg.preemphasis_cof)
    return _framing.stack_frames_samples(
        signal, cfg.frame_size, cfg.frame_step, window=None, zero_padding=False
    )


# ------------------------------------------------------- fast chunked path --
@fp32_matmul()
def _chunk_gemm(signal: torch.Tensor, wall: torch.Tensor, n_frames: int, hop: int,
                fuse: Optional[bool] = None):
    """frames @ wall without building frames: hop-chunk the signal and
    contract against the (r*hop, D) wall.  Returns
    (chunks (..., n_frames + r - 1, hop), result (..., n_frames, D)).

    Two forms, equal up to rounding: ONE K=r*hop product over the
    overlapping [chunk_f | ... | chunk_{f+r-1}] rows (a strided view of the
    signal, copied once by the product), or r shifted K=hop products summed.
    The port fuses whenever r > 1: one cuBLAS call in place of r calls and
    r-1 adds of the (F, D) output.  ``fuse`` overrides (tests)."""
    r = wall.shape[0] // hop
    need = (n_frames + r - 1) * hop
    if need > signal.shape[-1]:
        signal = tF.pad(signal, (0, need - signal.shape[-1]))
    signal = signal[..., :need]
    ch = signal.reshape(signal.shape[:-1] + (n_frames + r - 1, hop))
    if fuse is None:
        fuse = r > 1
    if fuse and r > 1:
        big = signal.unfold(-1, r * hop, hop)  # (..., n_frames, r*hop)
        return ch, torch.matmul(big, wall)
    y = None
    for s in range(r):
        part = torch.matmul(ch[..., s : s + n_frames, :], wall[s * hop : (s + 1) * hop])
        y = part if y is None else y + part
    return ch, y


def _stacked_fb(fbank: np.ndarray, kmax: int, width: int, scale: float = 1.0) -> np.ndarray:
    """Filterbank weights for projecting the *squared* [C_trim | S_trim | ...]
    output directly to mel: ``mel_m = sum_k fb[m,k] * (xr_k^2 + xi_k^2) *
    scale``, so the (M, K) bank is transposed, scaled and duplicated over the
    cos and sin blocks; other columns (the Parseval terms) weigh zero."""
    fb = fbank[:, :kmax].T * scale
    fb2 = np.zeros((width, fb.shape[1]))
    fb2[:kmax] = fb
    fb2[kmax : 2 * kmax] = fb
    return fb2


def _projection(cfg: FeatureConfig) -> np.ndarray:
    """(W, M+1) float64 projection of the squared chunk-GEMM output: the
    stacked filterbank over N in columns 0..M-1 (mel energies) and column M
    selecting the two Parseval columns (y0² + y1²)."""
    bundle = constant_bundle(cfg)
    wd = chunk_gemm_wall(cfg, True)
    kmax, m = wd["kmax"], cfg.num_filters
    proj = np.zeros((wd["wall"].shape[1], m + 1))
    proj[:, :m] = _stacked_fb(bundle["fbank"], kmax, proj.shape[0]) / cfg.fft_points
    proj[2 * kmax, m] = 1.0
    proj[2 * kmax + 1, m] = 1.0
    return proj


@functools.lru_cache(maxsize=64)
def _speechpy_tensors(cfg: FeatureConfig, device: torch.device, dtype: torch.dtype) -> dict:
    """The chunk-GEMM constants as tensors on one device and dtype:
    ``wall`` (r*hop, W) ``[C_trim | S_trim | w | ±w]``, ``proj`` (W, M+1)
    (:func:`_projection`), ``dct`` (M, C) and ``w2`` (r, hop), the squared
    window of the Parseval term."""
    wd = chunk_gemm_wall(cfg, True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return {"wall": t(wd["wall"]), "proj": t(_projection(cfg)),
            "dct": t(constant_bundle(cfg)["dct"]), "w2": t(wd["w2"])}


def _consts(cfg: FeatureConfig, signal: torch.Tensor, consts: Optional[dict]) -> dict:
    return consts if consts is not None else _speechpy_tensors(cfg, signal.device, signal.dtype)


def _chunk_r(cfg: FeatureConfig) -> Optional[int]:
    """Shifted-slice count r = ceil(frame/hop) of the chunk-GEMM family, or
    ``None`` when it does not apply: frames must span at least one hop and
    r is capped at 8 (a tiny hop makes the overlapping operand r times the
    signal)."""
    fl, hop = cfg.frame_size, cfg.frame_step
    if fl < hop:
        return None
    r = -(-fl // hop)
    return r if r <= 8 else None


def _fast_path_ok(cfg: FeatureConfig) -> bool:
    """The chunk-GEMM lowering needs frames of a bounded number of whole
    hops, an even fft size (for the Parseval Nyquist term) and the matmul
    DFT impl."""
    return (
        cfg.frame_size <= cfg.fft_points
        and _chunk_r(cfg) is not None
        and cfg.fft_points % 2 == 0
        and resolve_fft_impl(cfg) == "matmul"
    )


@fp32_matmul()
def _chunked_mel_energy(
    signal: torch.Tensor, cfg: FeatureConfig, want_energy: bool,
    spectral_weight: Optional[np.ndarray] = None, n_frames: Optional[int] = None,
    consts: Optional[dict] = None,
):
    """speechpy-nopad framed power spectrum -> mel projection without
    building the (F, frame_len) matrix, the DFT trimmed to the filterbank's
    support.  Frame energies (over all rFFT bins, trimmed ones included) come
    from Parseval: ``sum_{k<=N/2} |X_k|^2 = (N * sum(x^2) + X_0^2 +
    X_{N/2}^2) / 2`` with ``X_0``, ``X_{N/2}`` the wall's w/±w columns.

    Returns (mel_feats, energies_or_None[, ssc_numerator]) where
    ``spectral_weight`` (a per-bin weight vector, SSC's frequency ramp) adds
    a second weighted mel projection."""
    if cfg.preemphasis_cof:
        signal = _framing.preemphasis(signal, 1, cfg.preemphasis_cof)
    bundle = constant_bundle(cfg)
    kmax = bundle["fbank_kmax"]
    hop = cfg.frame_step
    fl = min(cfg.frame_size, cfg.fft_points)
    n = cfg.fft_points
    m = cfg.num_filters
    if n_frames is None:
        n_frames, _ = _framing.speechpy_frame_counts(signal.shape[-1], fl, hop,
                                                     zero_padding=False)
    if n_frames <= 0:
        empty = signal.new_zeros(signal.shape[:-1] + (0, m))
        e = signal.new_zeros(signal.shape[:-1] + (0,)) if want_energy else None
        if spectral_weight is not None:
            return empty, e, empty
        return empty, e

    c = _consts(cfg, signal, consts)
    ch, y = _chunk_gemm(signal, c["wall"], n_frames, hop)
    energies = None
    if want_energy:
        energies = _parseval_energies(ch, y[..., 2 * kmax], y[..., 2 * kmax + 1],
                                      c["w2"], n, n_frames, fl % hop == 0 and cfg.window == "rect")
    if spectral_weight is None:
        # project the squared product straight to mel (see _stacked_fb)
        feats = zero_handling(torch.matmul(y * y, c["proj"][:, :m]))
        return feats, energies

    # SSC: the zero replacement is per bin, so the power spectrum is built,
    # and it takes the float64 epsilon (the SSC spec), not the f32 one
    xr = y[..., :kmax]
    xi = y[..., kmax : 2 * kmax]
    power = (xr * xr + xi * xi) * (1.0 / n)
    eps = float(np.finfo(np.float64).eps)
    pz = torch.where(power == 0.0, torch.full_like(power, eps), power)
    # num = (pz*rw)@fbt == pz@(rw·fbt): numerator and denominator in one product
    fbt64 = bundle["fbank"][:, :kmax].T
    both = torch.as_tensor(
        np.concatenate([spectral_weight[:kmax, None] * fbt64, fbt64], axis=1),
        dtype=signal.dtype, device=signal.device,
    )
    nd = torch.matmul(pz, both)
    return nd[..., :m], energies, nd[..., m:]


@fp32_matmul()
def _parseval_energies(ch, s0, s1, w2, n, n_frames, unit_window: bool):
    """Exact frame energies from the Parseval identity: the sum of x²·w² per
    frame from per-chunk reductions, plus the s0/s1 terms from the product's
    Parseval columns.  ``unit_window``: every entry of ``w2`` (r, hop) is 1
    (a rect window on whole hops), so plain sums of squares suffice."""
    r = w2.shape[0]
    if unit_window:
        cs2 = torch.sum(ch * ch, dim=-1)  # (..., n_chunks)
        parts = [cs2[..., s : s + n_frames] for s in range(r)]
    else:
        # per-(chunk, shift) weighted sums as one (hop, r) product; zero
        # rows of w2 drop the samples past a hop-misaligned frame
        p = torch.matmul(ch * ch, w2.T)
        parts = [p[..., s : s + n_frames, s] for s in range(r)]
    s2 = parts[0]
    for part in parts[1:]:
        s2 = s2 + part
    return zero_handling((n * s2 + s0 * s0 + s1 * s1) / (2.0 * n))


def mfe(signal: torch.Tensor, cfg: FeatureConfig,
        consts: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mel filterbank energies + frame energies:
    (..., T) -> ((..., F, num_filters), (..., F))."""
    if _fast_path_ok(cfg):
        return _chunked_mel_energy(signal, cfg, want_energy=True, consts=consts)
    frames = _speechpy_frames(signal, cfg)
    ps = power_spectrum(frames, cfg, windowed=cfg.window != "rect")
    energies = zero_handling(torch.sum(ps, dim=-1))
    feats = apply_filterbank(ps, cfg, handle_zeros=True)
    return feats, energies


def lmfe(signal: torch.Tensor, cfg: FeatureConfig,
         consts: Optional[dict] = None) -> torch.Tensor:
    """Log mel filterbank energies."""
    feats, _ = mfe(signal, cfg, consts)
    return torch.log(feats)


def mfcc(signal: torch.Tensor, cfg: FeatureConfig,
         consts: Optional[dict] = None) -> torch.Tensor:
    """MFCC with the orthonormal DCT-II: (..., T) -> (..., F, num_cepstral).
    On a CUDA float32 tensor, with ``cfg.pallas != "off"`` and a config the
    kernel takes, this is one launch of the fused kernel."""
    if signal.is_cuda and cfg.pallas != "off" and signal.dtype == torch.float32:
        from .ops.cuda.speechpy_mfcc import mfcc_kernel_supported

        if mfcc_kernel_supported(cfg):
            return _MFCCKernel.apply(signal, cfg, consts)
    feats, energy = mfe(signal, cfg, consts)
    feats = torch.log(feats)
    if consts is None:
        out = dct2_ortho(feats, cfg)
    else:
        with fp32_matmul():
            out = torch.matmul(feats, consts["dct"])
    if cfg.dc_elimination:
        out = torch.cat([torch.log(energy)[..., None], out[..., 1:]], dim=-1)
    return out


class _MFCCKernel(torch.autograd.Function):
    """The fused kernel forward; the backward recomputes through the plain
    chunk-GEMM path, which computes the same function."""

    @staticmethod
    def forward(ctx, signal, cfg, consts):
        from .ops.cuda.speechpy_mfcc import mfcc_fused

        ctx.cfg = cfg
        ctx.consts = consts
        ctx.save_for_backward(signal)
        x = signal
        if cfg.preemphasis_cof:
            x = _framing.preemphasis(x, 1, cfg.preemphasis_cof)
        return mfcc_fused(x, cfg, consts)

    @staticmethod
    def backward(ctx, g):
        (signal,) = ctx.saved_tensors
        with torch.enable_grad():
            s = signal.detach().requires_grad_(True)
            out = mfcc(s, ctx.cfg.replace(pallas="off"), ctx.consts)
            (gs,) = torch.autograd.grad(out, s, g)
        return gs, None, None


# --------------------------------------------------------- librosa pipeline --
@functools.lru_cache(maxsize=64)
def _librosa_tensors(cfg: FeatureConfig, device: torch.device, dtype: torch.dtype) -> dict:
    """The librosa chunk-GEMM constants on one device and dtype: ``wall``
    ``[C_trim | S_trim]`` of the windowed DFT, its rows zero-padded to
    ceil(n_fft/hop) whole hops (a no-op when the hop divides n_fft; the
    zero rows weigh the samples past a frame), ``fb2`` (2*kmax, M), the
    filterbank stacked over both blocks, and ``fbt`` (kmax, M)."""
    bundle = constant_bundle(cfg)
    kmax = bundle["fbank_kmax"]
    c64, s64 = bundle["dft_windowed"]
    n, hop = cfg.fft_points, cfg.frame_step
    wall = np.zeros((-(-n // hop) * hop, 2 * kmax))
    wall[:n] = np.concatenate([c64[:, :kmax], s64[:, :kmax]], axis=1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return {"wall": t(wall), "fb2": t(_stacked_fb(bundle["fbank"], kmax, 2 * kmax)),
            "fbt": t(bundle["fbank"][:, :kmax].T)}


def mel_spectrogram_librosa(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """librosa-compatible mel spectrogram: (..., T) -> (..., n_mels, frames).
    Build ``cfg`` with :func:`..config.librosa_config`.

    On a CUDA float32 tensor, with ``cfg.pallas != "off"``, ``cfg.fft_impl
    != "fft"`` and a config the kernel takes, this is one launch of the CT
    mel kernel (``ops/cuda/ct_mel``).  Otherwise one of the plain lowerings,
    picked by the reference's rules: the Cooley-Tukey products (fft > 1024,
    hop a multiple of N1), the chunk-GEMM (hop divides n_fft), the
    hop-padded chunk-GEMM (hop does not divide n_fft) or framed STFT."""
    n = cfg.fft_points
    hop = cfg.frame_step
    if cfg.frame_size != n:
        # librosa frames are always n_fft samples; shorter analysis windows
        # go through win_length.  A speechpy frame_size here would change
        # the frame count silently.
        raise ValueError(
            f"mel_spectrogram_librosa frames by fft_points={n}, but "
            f"cfg.frame_size={cfg.frame_size}; build the config with "
            "librosa_config() (use win_length for short analysis windows)"
        )
    if _librosa_kernel_ok(signal, cfg):
        return _MelLibrosaKernel.apply(signal, cfg).transpose(-1, -2)
    if _librosa_ct_ok(cfg):
        return _librosa_ct_mel(signal, cfg)
    use_fast = _fast_path_ok(cfg) and n % hop == 0
    if use_fast or _librosa_hoppad_ok(cfg):
        if cfg.center:
            signal = _framing.pad_signal(signal, n // 2, n // 2, cfg.pad_mode)
        count = 1 + (signal.shape[-1] - n) // hop
        if count > 0:
            c = _librosa_tensors(cfg, signal.device, signal.dtype)
            _, y = _chunk_gemm(signal, c["wall"], count, hop)
            with fp32_matmul():
                if cfg.power == 2.0:
                    # the squared product projects straight to mel (librosa:
                    # no 1/N scale)
                    mel = torch.matmul(y * y, c["fb2"])
                else:
                    kmax = c["fbt"].shape[0]
                    xr, xi = y[..., :kmax], y[..., kmax:]
                    mel = torch.matmul((xr * xr + xi * xi) ** (cfg.power / 2.0), c["fbt"])
            return mel.transpose(-1, -2)
    power = _stft.stft_framed(signal, cfg, framing_style="librosa", return_power=True)
    return mel_project_time_major(power, cfg)


def _librosa_hoppad_ok(cfg: FeatureConfig) -> bool:
    """The hop-padded chunk-GEMM applies: the matmul DFT, an even fft, a hop
    that does NOT divide the frame, and a shifted-slice count bounded by
    :func:`_chunk_r` (512/160 or 512/130 -> r = 4; hop 40 -> r = 13 takes
    framed STFT)."""
    if resolve_fft_impl(cfg) != "matmul" or cfg.fft_points % 2:
        return False
    if cfg.frame_size % cfg.frame_step == 0:
        return False
    return _chunk_r(cfg) is not None


def _librosa_kernel_ok(signal: torch.Tensor, cfg: FeatureConfig) -> bool:
    """Dispatch the CT mel kernel: a CUDA float32 tensor, ``cfg.pallas !=
    "off"``, no explicit ``fft_impl="fft"`` request (the kernel is an FFT of
    its own, so "auto", "matmul" and "ct" all take it) and a config the
    kernel supports.  Every hop takes it: the kernel reads frame f at
    f*hop of the signal, whatever the hop."""
    if not signal.is_cuda or signal.dtype != torch.float32:
        return False
    if cfg.pallas == "off" or cfg.fft_impl == "fft":
        return False
    from .ops.cuda.ct_mel import ct_mel_supported

    return ct_mel_supported(cfg)


class _MelLibrosaKernel(torch.autograd.Function):
    """The CT mel kernel forward, frame-major (..., F, M); the backward
    recomputes through the plain path (``pallas="off"``), which computes the
    same function."""

    @staticmethod
    def forward(ctx, signal, cfg):
        from .ops.cuda.ct_mel import ct_mel

        ctx.cfg = cfg
        ctx.save_for_backward(signal)
        return ct_mel(signal, cfg)

    @staticmethod
    def backward(ctx, g):
        (signal,) = ctx.saved_tensors
        with torch.enable_grad():
            s = signal.detach().requires_grad_(True)
            out = mel_spectrogram_librosa(s, ctx.cfg.replace(pallas="off")).transpose(-1, -2)
            (gs,) = torch.autograd.grad(out, s, g)
        return gs, None


def _librosa_ct_ok(cfg: FeatureConfig) -> bool:
    if resolve_fft_impl(cfg) != "ct" or cfg.frame_size != cfg.fft_points:
        return False
    if cfg.power != 2.0:
        return False
    f = good_factorization(cfg.fft_points)
    if f is None:
        return False
    n1, _ = f
    hop = cfg.frame_step
    return cfg.fft_points % hop == 0 and hop % n1 == 0


@functools.lru_cache(maxsize=64)
def _ct_mel_tensors(cfg: FeatureConfig, factors: Tuple[int, int], device: torch.device,
                    dtype: torch.dtype) -> dict:
    """``window`` (n_fft,) and ``proj`` (N2*k1max, M), the filterbank
    permuted onto the CT output plane, as tensors."""
    bundle = constant_bundle(cfg)
    proj = permute_weights_for_ct(bundle["fbank"], cfg.fft_points, factors).T
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return {"window": t(bundle["window"]), "proj": t(proj)}


def ct_frames_mel(padded: torch.Tensor, cfg: FeatureConfig,
                  factors: Tuple[int, int]) -> torch.Tensor:
    """(..., T) already centre-padded -> (..., F, M) frame-major: frames of
    n_fft at every hop (a strided view), the window, then the CT products
    and the projection of :func:`ops.fft.ct_power_project`."""
    n, hop = cfg.fft_points, cfg.frame_step
    n1, n2 = factors
    count = 1 + (padded.shape[-1] - n) // hop
    if count <= 0:
        return padded.new_zeros(padded.shape[:-1] + (0, cfg.num_filters))
    c = _ct_mel_tensors(cfg, factors, padded.device, padded.dtype)
    frames = _framing.frame_signal(padded, n, hop, count) * c["window"]
    frames = frames.reshape(frames.shape[:-1] + (n2, n1))  # sample n = n1 + N1*n2
    return ct_power_project(frames, n, n1, n2, c["proj"])


def _librosa_ct_mel(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """librosa mel spectrogram for large transforms through the CT products,
    the filterbank permuted onto the CT output plane (no spectrum
    transpose)."""
    n = cfg.fft_points
    if cfg.center:
        signal = _framing.pad_signal(signal, n // 2, n // 2, cfg.pad_mode)
    return ct_frames_mel(signal, cfg, good_factorization(n)).transpose(-1, -2)


def log_mel_spectrogram(signal: torch.Tensor, cfg: FeatureConfig, ref: float = 1.0,
                        top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa ``power_to_db(melspectrogram)``."""
    return power_to_db(mel_spectrogram_librosa(signal, cfg), ref=ref, top_db=top_db)


def mfcc_librosa(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """librosa-compatible MFCC: DCT-II (ortho) over the log-mel,
    (..., n_mfcc, frames).  Frame-major inside, so the kernel's output feeds
    the DCT product without a copy."""
    s = mel_spectrogram_librosa(signal, cfg).transpose(-1, -2)  # (..., T, M)
    return dct2_ortho(power_to_db(s), cfg).transpose(-1, -2)
