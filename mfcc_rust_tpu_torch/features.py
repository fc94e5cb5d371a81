"""Feature pipelines on tensors (port of ``mfcc_rust_tpu.features``): the
speechpy MFE / log-MFE / MFCC / SSC part with the single-pass ``extract``,
the reference's vorbis mel spectrogram, and the librosa mel / log-mel / MFCC
part.

Every function is a plain function of ``(signal, cfg)`` over arbitrary
leading batch dims, computing in the signal's dtype on the signal's device.
The default lowering never builds the frame matrix: framing folds into one
product with the chunk-GEMM wall (``_chunk_gemm``), the DFT is trimmed to the
filterbank's support, and frame energies come from Parseval columns of the
same product.  On a CUDA float32 tensor ``mfcc`` runs the fused kernel
(``ops/cuda/speechpy_mfcc``) and ``mel_spectrogram_librosa`` the CT mel
kernel (``ops/cuda/ct_mel``); everywhere else they run the plain paths,
which the kernels are held against.  ``ssc``, ``extract`` and
``mel_spectrogram`` have no kernel: their products run on cuBLAS.

``consts`` (optional) is a dict of the chunk-GEMM constant tensors
(:func:`_speechpy_tensors`); the pipelines pass their buffers through it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from .config import FeatureConfig, fp32_matmul
from .constants import (bundle_tensor, chunk_gemm_wall, constant_bundle, tensor_cache,
                        vorbis_chunk_wall)
from .ops import framing as _framing
from .ops import stft as _stft
from .ops.dct import dct2_ortho
from .ops.fft import _ct_tensors, ct_power_project, good_factorization, permute_weights_for_ct
from .ops.mel import apply_filterbank, mel_project_time_major
from .ops.spectrum import power_spectrum, power_to_db, resolve_fft_impl, zero_handling
from .ops.ssc import SSC_EPS, ssc_from_power, ssc_ramp


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


def _ssc_projection(cfg: FeatureConfig) -> np.ndarray:
    """(kmax, 2M) float64 ``[ramp·fbᵀ | fbᵀ]``: one product of the power
    spectrum gives the SSC numerator (``(p·ramp) @ fbᵀ == p @ (ramp·fbᵀ)``)
    and its denominator."""
    bundle = constant_bundle(cfg)
    kmax = bundle["fbank_kmax"]
    fbt = bundle["fbank"][:, :kmax].T
    return np.concatenate([ssc_ramp(cfg)[:kmax, None] * fbt, fbt], axis=1)


@tensor_cache(maxsize=64)
def _speechpy_tensors(cfg: FeatureConfig, device: torch.device, dtype: torch.dtype) -> dict:
    """The chunk-GEMM constants as tensors on one device and dtype:
    ``wall`` (r*hop, W) ``[C_trim | S_trim | w | ±w]``, ``proj`` (W, M+1)
    (:func:`_projection`), ``dct`` (M, C), ``w2`` (r, hop), the squared
    window of the Parseval term, and ``ssc`` (kmax, 2M)
    (:func:`_ssc_projection`)."""
    wd = chunk_gemm_wall(cfg, True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return {"wall": t(wd["wall"]), "proj": t(_projection(cfg)),
            "dct": t(constant_bundle(cfg)["dct"]), "w2": t(wd["w2"]),
            "ssc": t(_ssc_projection(cfg))}


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


def speechpy_lowering(cfg: FeatureConfig, feature="mfcc", device_type: str = "cuda",
                      dtype: torch.dtype = torch.float32) -> str:
    """The lowering a speechpy-family feature takes on a tensor of
    ``device_type`` and ``dtype``: ``"k1"`` (the fused kernel; ``mfcc`` on a
    CUDA float32 tensor, ``cfg.pallas != "off"``, a config the kernel
    takes), ``"chunk-gemm"`` (:func:`_fast_path_ok`) or ``"framed"`` (the
    gather fallback); a tuple of heads (:func:`extract`) takes
    ``"chunk-gemm-multi"`` or ``"framed-multi"``.  The functions below
    dispatch on it."""
    if isinstance(feature, (tuple, list)):
        return speechpy_lowering(cfg, "ssc", device_type, dtype) + "-multi"
    if (feature == "mfcc" and device_type == "cuda" and cfg.pallas != "off"
            and dtype == torch.float32):
        from .ops.cuda.speechpy_mfcc import mfcc_kernel_supported

        if mfcc_kernel_supported(cfg):
            return "k1"
    return "chunk-gemm" if _fast_path_ok(cfg) else "framed"


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
    signal: torch.Tensor, cfg: FeatureConfig, want_energy: bool, ssc: bool = False,
    n_frames: Optional[int] = None, consts: Optional[dict] = None,
):
    """speechpy-nopad framed power spectrum -> mel projection without
    building the (F, frame_len) matrix, the DFT trimmed to the filterbank's
    support.  Frame energies (over all rFFT bins, trimmed ones included) come
    from Parseval: ``sum_{k<=N/2} |X_k|^2 = (N * sum(x^2) + X_0^2 +
    X_{N/2}^2) / 2`` with ``X_0``, ``X_{N/2}`` the wall's w/±w columns.

    Returns (mel_feats, energies_or_None), or with ``ssc`` the SSC
    numerator, energies and denominator (:func:`_ssc_head`)."""
    if cfg.preemphasis_cof:
        signal = _framing.preemphasis(signal, 1, cfg.preemphasis_cof)
    hop = cfg.frame_step
    fl = min(cfg.frame_size, cfg.fft_points)
    m = cfg.num_filters
    if n_frames is None:
        n_frames, _ = _framing.speechpy_frame_counts(signal.shape[-1], fl, hop,
                                                     zero_padding=False)
    if n_frames <= 0:
        empty = signal.new_zeros(signal.shape[:-1] + (0, m))
        e = signal.new_zeros(signal.shape[:-1] + (0,)) if want_energy else None
        return (empty, e, empty) if ssc else (empty, e)

    c = _consts(cfg, signal, consts)
    ch, y = _chunk_gemm(signal, c["wall"], n_frames, hop)
    energies = _frame_energies(ch, y, c, cfg, n_frames) if want_energy else None
    if ssc:
        num, den = _ssc_head(y, c, cfg)
        return num, energies, den
    # project the squared product straight to mel (see _stacked_fb)
    return _mel_head(y, c, cfg), energies


def _frame_energies(ch, y, c: dict, cfg: FeatureConfig, n_frames: int) -> torch.Tensor:
    """Parseval frame energies of one chunk-GEMM product (the wall's w/±w
    columns sit at 2*kmax and 2*kmax + 1)."""
    kmax = constant_bundle(cfg)["fbank_kmax"]
    fl = min(cfg.frame_size, cfg.fft_points)
    return _parseval_energies(ch, y[..., 2 * kmax], y[..., 2 * kmax + 1], c["w2"],
                              cfg.fft_points, n_frames,
                              fl % cfg.frame_step == 0 and cfg.window == "rect")


@fp32_matmul()
def _mel_head(y: torch.Tensor, c: dict, cfg: FeatureConfig) -> torch.Tensor:
    """Mel energies, zeros replaced: ``(y·y) @ proj[:, :M]``."""
    return zero_handling(torch.matmul(y * y, c["proj"][:, : cfg.num_filters]))


@fp32_matmul()
def _ssc_head(y: torch.Tensor, c: dict, cfg: FeatureConfig):
    """SSC (numerator, denominator) of one chunk-GEMM product.  The zero
    replacement is per bin, so the power spectrum is built, and it takes the
    float64 epsilon (the SSC spec), not the float32 one."""
    kmax = constant_bundle(cfg)["fbank_kmax"]
    xr = y[..., :kmax]
    xi = y[..., kmax : 2 * kmax]
    power = (xr * xr + xi * xi) * (1.0 / cfg.fft_points)
    pz = torch.where(power == 0.0, torch.full_like(power, SSC_EPS), power)
    nd = torch.matmul(pz, c["ssc"])
    m = cfg.num_filters
    return nd[..., :m], nd[..., m:]


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
    if speechpy_lowering(cfg, "mfcc", signal.device.type, signal.dtype) == "k1":
        return _MFCCKernel.apply(signal, cfg, consts)
    feats, energy = mfe(signal, cfg, consts)
    logm = torch.log(feats)
    dct = consts["dct"] if consts is not None else bundle_tensor(cfg, "dct", logm.device,
                                                                 logm.dtype)
    return _cepstra(logm, energy, dct, cfg)


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


def ssc(signal: torch.Tensor, cfg: FeatureConfig,
        consts: Optional[dict] = None) -> torch.Tensor:
    """Spectral subband centroids in Hz: (..., T) -> (..., F, num_filters)."""
    if _fast_path_ok(cfg):
        num, _, den = _chunked_mel_energy(signal, cfg, want_energy=False, ssc=True,
                                          consts=consts)
        return num / den
    frames = _speechpy_frames(signal, cfg)
    return ssc_from_power(power_spectrum(frames, cfg, windowed=cfg.window != "rect"), cfg)


# --------------------------------------------------- reference mel spectrum --
@tensor_cache(maxsize=64)
def _vorbis_tensors(cfg: FeatureConfig, device: torch.device, dtype: torch.dtype) -> dict:
    """:func:`..constants.vorbis_chunk_wall`'s ``wall`` and ``fb2`` as
    tensors on one device and dtype."""
    vw = vorbis_chunk_wall(cfg)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return {"wall": t(vw["wall"]), "fb2": t(vw["fb2"])}


def vorbis_lowering(cfg: FeatureConfig) -> str:
    """The lowering :func:`mel_spectrogram` takes: ``"vorbis-chunk-gemm"``
    with the matmul DFT, else ``"vorbis-framed"``."""
    if cfg.window != "vorbis":
        cfg = cfg.replace(window="vorbis")
    return "vorbis-chunk-gemm" if resolve_fft_impl(cfg) == "matmul" else "vorbis-framed"


def mel_spectrogram(signal: torch.Tensor, cfg: FeatureConfig,
                    consts: Optional[dict] = None) -> torch.Tensor:
    """The reference's mel spectrogram: the vorbis-window streaming STFT's
    power on the speechpy filterbank, mel-major (..., num_filters, T'),
    T' = ceil(T / stream_hop), in the reference's n_pad layout.

    With the matmul DFT the stream's frames are hop-strided windows of the
    signal left-padded with fft_points - hop zeros (the analysis memory), so
    the STFT is one chunk-GEMM against the vorbis wall (its rows zero-padded
    to whole hops) and the squared product projects through the stacked
    filterbank with wnorm² folded in (``consts``: :func:`_vorbis_tensors`'s
    dict).  Otherwise the framed STFT."""
    if cfg.window != "vorbis":
        cfg = cfg.replace(window="vorbis")
    if vorbis_lowering(cfg) == "vorbis-framed":
        return mel_project_time_major(_stft.stft_vorbis_power(signal, cfg), cfg)
    hop = cfg.stream_hop
    n_frames = -(-signal.shape[-1] // hop)
    if n_frames > 0:
        c = consts if consts is not None else _vorbis_tensors(cfg, signal.device, signal.dtype)
        x = tF.pad(signal, (cfg.fft_points - hop, 0))
        _, y = _chunk_gemm(x, c["wall"], n_frames, hop)
        with fp32_matmul():
            mel = torch.matmul(y * y, c["fb2"])
    else:  # an empty clip: only the n_pad zero rows of the layout
        mel = signal.new_zeros(signal.shape[:-1] + (0, cfg.num_filters))
    return _stft._apply_npad_layout(mel, cfg).transpose(-1, -2)


# --------------------------------------------------------- librosa pipeline --
@tensor_cache(maxsize=64)
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


def librosa_lowering(cfg: FeatureConfig, device_type: str = "cuda",
                     dtype: torch.dtype = torch.float32) -> str:
    """The lowering :func:`mel_spectrogram_librosa` takes on a tensor of
    ``device_type`` and ``dtype``: ``"k2"``, the CT mel kernel
    (:func:`_librosa_kernel_ok`), else one of the plain lowerings, picked by
    the reference's rules: ``"librosa-ct"``, the Cooley-Tukey products (fft >
    1024, hop a multiple of N1); ``"librosa-chunk-gemm"`` (hop divides
    n_fft); ``"librosa-hoppad"``, the hop-padded chunk-GEMM (hop does not
    divide n_fft); or ``"librosa-framed"``, the framed STFT."""
    if _kernel_takes_librosa(device_type, dtype, cfg):
        return "k2"
    if _librosa_ct_ok(cfg):
        return "librosa-ct"
    if _fast_path_ok(cfg) and cfg.fft_points % cfg.frame_step == 0:
        return "librosa-chunk-gemm"
    if _librosa_hoppad_ok(cfg):
        return "librosa-hoppad"
    return "librosa-framed"


def _librosa_plain_tensors(cfg: FeatureConfig, device: torch.device,
                           dtype: torch.dtype) -> Optional[dict]:
    """The constants of the plain lowering :func:`mel_spectrogram_librosa`
    takes for ``cfg`` off the kernel, the ``consts`` it accepts: the CT
    path's window, permuted projection and stage matrices, the chunk-GEMM
    paths' :func:`_librosa_tensors`, or None (the framed STFT)."""
    low = librosa_lowering(cfg, device.type, dtype)
    if low == "k2":
        low = librosa_lowering(cfg.replace(pallas="off"), device.type, dtype)
    if low == "librosa-ct":
        n1, n2 = good_factorization(cfg.fft_points)
        c = dict(_ct_mel_tensors(cfg, (n1, n2), device, dtype))
        st = _ct_tensors(cfg.fft_points, n1, n2, c["proj"].shape[0] // n2, device, dtype)
        return dict(c, st1=st["st1"], a=st["a"], b=st["b"])
    if low in ("librosa-chunk-gemm", "librosa-hoppad"):
        return dict(_librosa_tensors(cfg, device, dtype))
    return None


def mel_spectrogram_librosa(signal: torch.Tensor, cfg: FeatureConfig,
                            consts: Optional[dict] = None) -> torch.Tensor:
    """librosa-compatible mel spectrogram: (..., T) -> (..., n_mels, frames).
    Build ``cfg`` with :func:`..config.librosa_config`.

    On a CUDA float32 tensor, with ``cfg.pallas != "off"``, ``cfg.fft_impl
    != "fft"`` and a config the kernel takes, this is one launch of the CT
    mel kernel (``ops/cuda/ct_mel``).  Otherwise the plain lowering of
    :func:`librosa_lowering`, on ``consts`` (:func:`_librosa_plain_tensors`)
    when given."""
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
    low = librosa_lowering(cfg, signal.device.type, signal.dtype)
    if low == "k2":
        return _MelLibrosaKernel.apply(signal, cfg).transpose(-1, -2)
    if low == "librosa-ct":
        return _librosa_ct_mel(signal, cfg, consts)
    if low != "librosa-framed":
        if cfg.center:
            signal = _framing.pad_signal(signal, n // 2, n // 2, cfg.pad_mode)
        count = 1 + (signal.shape[-1] - n) // hop
        if count > 0:
            c = consts if consts is not None else _librosa_tensors(cfg, signal.device,
                                                                   signal.dtype)
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
    """Dispatch the CT mel kernel on ``signal``: see :func:`_kernel_takes_librosa`."""
    return _kernel_takes_librosa(signal.device.type, signal.dtype, cfg)


def _kernel_takes_librosa(device_type: str, dtype: torch.dtype, cfg: FeatureConfig) -> bool:
    """The CT mel kernel takes a CUDA float32 tensor, ``cfg.pallas !=
    "off"``, no explicit ``fft_impl="fft"`` request (the kernel is an FFT of
    its own, so "auto", "matmul" and "ct" all take it) and a config the
    kernel supports.  Every hop takes it: the kernel reads frame f at
    f*hop of the signal, whatever the hop."""
    if device_type != "cuda" or dtype != torch.float32:
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


@tensor_cache(maxsize=64)
def _ct_mel_tensors(cfg: FeatureConfig, factors: Tuple[int, int], device: torch.device,
                    dtype: torch.dtype) -> dict:
    """``window`` (n_fft,) and ``proj`` (N2*k1max, M), the filterbank
    permuted onto the CT output plane, as tensors."""
    bundle = constant_bundle(cfg)
    proj = permute_weights_for_ct(bundle["fbank"], cfg.fft_points, factors).T
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return {"window": t(bundle["window"]), "proj": t(proj)}


def ct_frames_mel(padded: torch.Tensor, cfg: FeatureConfig, factors: Tuple[int, int],
                  consts: Optional[dict] = None) -> torch.Tensor:
    """(..., T) already centre-padded -> (..., F, M) frame-major: frames of
    n_fft at every hop (a strided view), the window, then the CT products
    and the projection of :func:`ops.fft.ct_power_project` (``consts``: the
    CT dict of :func:`_librosa_plain_tensors`)."""
    n, hop = cfg.fft_points, cfg.frame_step
    n1, n2 = factors
    count = 1 + (padded.shape[-1] - n) // hop
    if count <= 0:
        return padded.new_zeros(padded.shape[:-1] + (0, cfg.num_filters))
    c = consts if consts is not None else _ct_mel_tensors(cfg, factors, padded.device,
                                                          padded.dtype)
    frames = _framing.frame_signal(padded, n, hop, count) * c["window"]
    frames = frames.reshape(frames.shape[:-1] + (n2, n1))  # sample n = n1 + N1*n2
    return ct_power_project(frames, n, n1, n2, c["proj"], stages=consts)


def _librosa_ct_mel(signal: torch.Tensor, cfg: FeatureConfig,
                    consts: Optional[dict] = None) -> torch.Tensor:
    """librosa mel spectrogram for large transforms through the CT products,
    the filterbank permuted onto the CT output plane (no spectrum
    transpose)."""
    n = cfg.fft_points
    if cfg.center:
        signal = _framing.pad_signal(signal, n // 2, n // 2, cfg.pad_mode)
    return ct_frames_mel(signal, cfg, good_factorization(n), consts).transpose(-1, -2)


def log_mel_spectrogram(signal: torch.Tensor, cfg: FeatureConfig, ref: float = 1.0,
                        top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa ``power_to_db(melspectrogram)``."""
    return power_to_db(mel_spectrogram_librosa(signal, cfg), ref=ref, top_db=top_db)


def mfcc_librosa(signal: torch.Tensor, cfg: FeatureConfig,
                 consts: Optional[dict] = None) -> torch.Tensor:
    """librosa-compatible MFCC: DCT-II (ortho) over the log-mel,
    (..., n_mfcc, frames).  Frame-major inside, so the kernel's output feeds
    the DCT product without a copy.  ``consts``: those of
    :func:`mel_spectrogram_librosa` plus ``dct`` (M, n_mfcc)."""
    s = mel_spectrogram_librosa(signal, cfg, consts).transpose(-1, -2)  # (..., T, M)
    if consts is None or "dct" not in consts:
        return dct2_ortho(power_to_db(s), cfg).transpose(-1, -2)
    with fp32_matmul():
        return torch.matmul(power_to_db(s), consts["dct"]).transpose(-1, -2)


# ------------------------------------------------------- multi-feature pass --
EXTRACT_HEADS = ("mfcc", "lmfe", "mfe", "ssc", "energy")


def extract(signal: torch.Tensor, cfg: FeatureConfig, which: Tuple[str, ...] = ("mfcc",),
            consts: Optional[dict] = None) -> dict:
    """Several speechpy-family features from ONE frontend pass.

    ``which`` ⊆ {"mfcc", "lmfe", "mfe", "ssc", "energy"}; returns a dict
    (``"mfe"`` maps to the (features, energies) pair of :func:`mfe`).  The
    chunk-GEMM, the Parseval energies and the log-mel run once and every
    requested head reads them.  The ``mfcc`` head is the plain chunk-GEMM
    path on every device: it never launches the fused kernel."""
    unknown = set(which) - set(EXTRACT_HEADS)
    if unknown:
        raise ValueError(f"unknown features {sorted(unknown)}; valid: {sorted(EXTRACT_HEADS)}")
    want = set(which)
    if not _fast_path_ok(cfg):
        return _extract_unfused(signal, cfg, want)

    x = signal
    if cfg.preemphasis_cof:
        x = _framing.preemphasis(x, 1, cfg.preemphasis_cof)
    need_energy = bool(want & {"mfe", "energy"}) or ("mfcc" in want and cfg.dc_elimination)
    n_frames, _ = _framing.speechpy_frame_counts(
        x.shape[-1], min(cfg.frame_size, cfg.fft_points), cfg.frame_step, zero_padding=False)
    if n_frames <= 0:
        lead = x.shape[:-1]
        empty2 = x.new_zeros(lead + (0, cfg.num_filters))
        empty1 = x.new_zeros(lead + (0,))
        out = {"mfcc": x.new_zeros(lead + (0, cfg.num_cepstral)), "lmfe": empty2,
               "ssc": empty2, "mfe": (empty2, empty1), "energy": empty1}
        return {k: v for k, v in out.items() if k in want}
    c = _consts(cfg, x, consts)
    ch, y = _chunk_gemm(x, c["wall"], n_frames, cfg.frame_step)
    return _extract_heads(ch, y, c, cfg, want, n_frames, need_energy)


def _extract_heads(ch, y, c: dict, cfg: FeatureConfig, want, n_frames: int,
                   need_energy: bool) -> dict:
    """Every requested head of one chunk-GEMM product ``y`` of the chunks
    ``ch`` against ``c["wall"]`` (:func:`_speechpy_tensors`, whose wall
    always holds the Parseval columns): the body of :func:`extract`, and the
    shard-local step of a data-parallel extraction."""
    energies = _frame_energies(ch, y, c, cfg, n_frames) if need_energy else None
    mel = _mel_head(y, c, cfg) if want & {"mfcc", "lmfe", "mfe"} else None
    out = _mel_heads(mel, energies, c["dct"], cfg, want)
    if "ssc" in want:
        num, den = _ssc_head(y, c, cfg)
        out["ssc"] = num / den
    return out


def _mel_heads(mel: Optional[torch.Tensor], energies: Optional[torch.Tensor],
               dct: torch.Tensor, cfg: FeatureConfig, want) -> dict:
    """The ``mfe``, ``energy``, ``lmfe`` and ``mfcc`` heads of one pair of
    mel and frame energies."""
    out = {}
    if "mfe" in want:
        out["mfe"] = (mel, energies)
    if "energy" in want:
        out["energy"] = energies
    if want & {"mfcc", "lmfe"}:
        logm = torch.log(mel)
        if "lmfe" in want:
            out["lmfe"] = logm
        if "mfcc" in want:
            out["mfcc"] = _cepstra(logm, energies, dct, cfg)
    return out


def _cepstra(logm: torch.Tensor, energies: Optional[torch.Tensor], dct: torch.Tensor,
             cfg: FeatureConfig) -> torch.Tensor:
    """DCT of the log-mel; with dc_elimination column 0 is the log frame
    energy."""
    with fp32_matmul():
        out = torch.matmul(logm, dct)
    if cfg.dc_elimination:
        out = torch.cat([torch.log(energies)[..., None], out[..., 1:]], dim=-1)
    return out


def _extract_unfused(signal: torch.Tensor, cfg: FeatureConfig, want) -> dict:
    """:func:`extract` off the chunk-GEMM path: the gather fallback of
    :func:`mfe` feeds the mel heads, :func:`ssc` its own."""
    out = {}
    if want & {"mfcc", "lmfe", "mfe", "energy"}:
        feats, energies = mfe(signal, cfg)
        dct = bundle_tensor(cfg, "dct", feats.device, feats.dtype)
        out = _mel_heads(feats, energies, dct, cfg, want)
    if "ssc" in want:
        out["ssc"] = ssc(signal, cfg)
    return out
