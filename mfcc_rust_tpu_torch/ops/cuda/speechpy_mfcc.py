"""Fused speechpy MFCC: the CUDA kernel ``speechpy_mfcc.cu``, its binding,
and its plain PyTorch version.

Replaces the TPU kernel ``mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py``
(``mfcc_pallas``): Parseval frame energies, mel energies, f32-eps zero
handling, log, DCT-II ortho and dc-elimination in one launch that writes
only the (B, F, C) answer.  Where the TPU kernel multiplies by a DFT wall,
the CUDA kernel runs one FFT per frame (see the note in the .cu source):
path 1, a register-resident FFT, when n/2 is a power of two from 64 to 512;
path 2, the shared-memory Stockham stages of ``fft_stages.cuh``, for every
other even n.  The plain version keeps the chunk-GEMM form of the same
function.

:func:`mfcc_fused` launches the kernel for a CUDA tensor and runs
:func:`mfcc_fused_plain` for a CPU tensor; it never falls back from one to
the other.  ``mfcc_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from ... import features as _F
from ...config import FeatureConfig, fp32_matmul
from ...constants import constant_bundle, tensor_cache
from ..spectrum import resolve_fft_impl, zero_handling
from .ct_mel import fft_plan, pack_filterbank, twiddle_table

KERNEL = "speechpy_mfcc"

# speechpy_mfcc.cu: kTileF, kMaxSmem
_TILE_F, _MAX_SMEM = 32, 232448


def fft_path(n: int) -> int:
    """The kernel's FFT path for n (``fft_path`` in the .cu): 1, the
    register-resident FFT, when n/2 is a power of two from 64 to 512; else
    2, the shared-memory Stockham stages."""
    nc = n // 2
    return 1 if n % 2 == 0 and 64 <= nc <= 512 and nc & (nc - 1) == 0 else 2


def stage_plan(n: int) -> Tuple[int, ...]:
    """The radices of the kernel's complex FFT of n/2 points (n even), in
    order: 8, 8 and n/128 on path 1; the radix-4 stages, a radix-2 stage
    and the odd part's direct DFT on path 2."""
    nc = n // 2
    if fft_path(n) == 1:
        return (8, 8) + ((nc // 64,) if nc > 64 else ())
    m_odd, n4, has2 = fft_plan(n)
    return (4,) * n4 + (2,) * has2 + ((m_odd,) if m_odd > 1 else ())


def smem_bytes(n: int, hop: int, fl: int, kmax: int, nnz: int, m: int, warps: int) -> int:
    """Dynamic shared memory of one block (``Layout`` in the .cu): two slabs
    of a tile's (32 - 1) * hop + fl samples, the packed weights and ranges,
    then each warp's scratch: on path 1 per frame the padded re and im
    exchange buffers, the power spectrum and the log mels; on path 2 two
    Stockham buffers and the log mels."""
    round4 = lambda x: -(-x // 4) * 4
    pad8 = lambda i: i + (i >> 3)
    nc = n // 2
    slab = round4((_TILE_F - 1) * hop + fl + 3)
    if fft_path(n) == 1:
        lanes = min(32, nc // 8)
        per_warp = 32 // lanes * (2 * round4(pad8(nc)) + round4(kmax) + round4(m))
    else:
        per_warp = 2 * round4(n) + round4(m)
    return 4 * (2 * slab + round4(nnz) + round4(3 * m) + warps * per_warp)


@functools.lru_cache(maxsize=64)
def mfcc_kernel_supported(cfg: FeatureConfig) -> bool:
    """Rect-window speechpy framing on the chunk-GEMM fast path, f32,
    bounded r, an even fft, and a block of one warp that fits in shared
    memory.  (The TPU kernel's num_filters <= 127 lane bound does not apply
    here.)  Cached per config: every launch asks it."""
    r = _F._chunk_r(cfg)
    if not (cfg.window == "rect"
            and cfg.dtype == "float32"
            and cfg.frame_size <= cfg.fft_points
            and r is not None
            and cfg.fft_points % 2 == 0
            and resolve_fft_impl(cfg) == "matmul"
            and cfg.num_cepstral <= cfg.num_filters):
        return False
    args = (cfg.fft_points, cfg.frame_step, cfg.frame_size)
    # the slabs alone first: no constants are built for a tile that cannot fit
    if smem_bytes(*args, 0, 0, cfg.num_filters, 1) > _MAX_SMEM:
        return False
    _, wpack, _, _, kmax = _kernel_constants(cfg)
    return smem_bytes(*args, kmax, wpack.size, cfg.num_filters, 1) <= _MAX_SMEM


@functools.lru_cache(maxsize=16)
def _kernel_constants(cfg: FeatureConfig):
    """The kernel's float32 numpy constants from the float64 builders: tw
    (n, 2) = (cos, sin)(2πj/n); wpack (nnz,) and ranges (M, 3) int32, the
    weights fb/n packed over each filter's nonzero bins [lo, hi) (the mel
    columns of the chunk-GEMM projection ``_F._projection``); dct (M, C);
    and kmax, the bins the kernel splits and weighs."""
    kmax = constant_bundle(cfg)["fbank_kmax"]
    wpack, ranges = pack_filterbank(_F._projection(cfg)[:kmax, :cfg.num_filters].T)
    dct = np.ascontiguousarray(constant_bundle(cfg)["dct"], np.float32)
    return twiddle_table(cfg.fft_points), wpack, ranges, dct, kmax


@tensor_cache(maxsize=16)
def _kernel_tensors(cfg: FeatureConfig, device: torch.device) -> dict:
    """The constants on one device, with the ints a launch passes: kmax and
    the path-2 stage plan (m_odd, n4, has2)."""
    tw, wpack, ranges, dct, kmax = _kernel_constants(cfg)
    t = lambda a: torch.from_numpy(a).to(device)
    return {"tw": t(tw), "wpack": t(wpack), "ranges": t(ranges), "dct": t(dct),
            "kmax": kmax, "fft_plan": fft_plan(cfg.fft_points)}


def _shape(cfg: FeatureConfig, wall: torch.Tensor):
    hop = cfg.frame_step
    return wall.shape[0] // hop, hop, cfg.frame_size


@fp32_matmul()
def mfcc_fused_plain(signal: torch.Tensor, cfg: FeatureConfig,
                     consts: Optional[dict] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (..., T) -> (..., F, C) with
    F = (T - fl) // hop (0 when T < fl).  Preemphasis is the caller's.

    The chunk-GEMM form, except that X_0 = sum x_t and X_{n/2} = sum (-1)^t
    x_t (the wall's DC column and its two Parseval columns) are float64 sums
    of each frame, as the kernel takes them: X_0 is real and cancels, and
    the first speechpy filter weighs it alone, so on the rare frame where it
    nearly vanishes a float32 product's rounding reaches that band's log."""
    c = _F._consts(cfg, signal, consts)
    r, hop, fl = _shape(cfg, c["wall"])
    n, m = cfg.fft_points, cfg.num_filters
    count = max((signal.shape[-1] - fl) // hop, 0)
    if count == 0:
        return signal.new_zeros(signal.shape[:-1] + (0, cfg.num_cepstral))
    need = (count + r - 1) * hop
    x = signal
    if need > x.shape[-1]:
        x = tF.pad(x, (0, need - x.shape[-1]))
    big = x[..., :need].unfold(-1, r * hop, hop)  # (..., F, r*hop)
    y = torch.matmul(big, c["wall"])
    frame = big[..., :fl].double()
    alt = torch.ones(fl, dtype=torch.float64, device=frame.device)
    alt[1::2] = -1.0
    x0 = frame.sum(-1, keepdim=True).to(y.dtype)
    xn = torch.matmul(frame, alt)[..., None].to(y.dtype)
    kmax = (y.shape[-1] - 2) // 2
    y = torch.cat([x0, y[..., 1:2 * kmax], x0, xn], dim=-1)
    s2 = torch.sum(big[..., :fl] * big[..., :fl], dim=-1)  # emask
    p = torch.matmul(y * y, c["proj"])
    out = torch.matmul(torch.log(zero_handling(p[..., :m])), c["dct"])
    if cfg.dc_elimination:
        en = (n * s2 + p[..., m]) * (1.0 / (2.0 * n))
        out = torch.cat([torch.log(zero_handling(en))[..., None], out[..., 1:]], dim=-1)
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .build import library

    return _bind(library(KERNEL))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the C interface."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mfcc_fft_launch.argtypes = [p] * 6 + [i, ll] + [i] * 12 + [ctypes.c_float, p]
    lib.mfcc_fft_launch.restype = i
    lib.mfcc_fft_plan.argtypes = [i] * 6 + [ll, ctypes.POINTER(ll)]
    lib.mfcc_fft_plan.restype = i
    lib.mfcc_fft_smem_bytes.argtypes = [i] * 7
    lib.mfcc_fft_smem_bytes.restype = ll
    lib.mfcc_fft_path.argtypes = [i]
    lib.mfcc_fft_path.restype = i
    lib.mfcc_cuda_error_string.argtypes = [i]
    lib.mfcc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: {lib.mfcc_cuda_error_string(err).decode()}")


def launch_plan(cfg: FeatureConfig, batch: int, frames: int) -> dict:
    """The launch shape the kernel's host code picks for (batch, frames)
    on the current CUDA device: path, warps a block, shared bytes a block,
    resident blocks per SM and the grid."""
    lib = _lib()
    _, wpack, _, _, kmax = _kernel_constants(cfg)
    info = (ctypes.c_longlong * 5)()
    tiles = batch * -(-frames // _TILE_F)
    _check(lib, lib.mfcc_fft_plan(cfg.fft_points, cfg.frame_step, cfg.frame_size, kmax,
                                  wpack.size, cfg.num_filters, tiles, info), "mfcc_fft_plan")
    return dict(zip(("path", "warps", "smem_bytes", "blocks_per_sm", "grid"), info))


def mfcc_fused(signal: torch.Tensor, cfg: FeatureConfig,
               consts: Optional[dict] = None) -> torch.Tensor:
    """Fused speechpy MFCC, (..., T) -> (..., F, C).  A CUDA tensor launches
    the kernel (and counts the launch); a CPU tensor runs
    :func:`mfcc_fused_plain`.  ``consts`` (the chunk-GEMM constants a
    pipeline holds) serves the plain version only: the kernel reads its own
    FFT constants.  Preemphasis is the caller's."""
    if not mfcc_kernel_supported(cfg):
        raise ValueError("config not supported by the fused MFCC kernel")
    if not signal.is_cuda:
        return mfcc_fused_plain(signal, cfg, consts)
    if signal.dtype != torch.float32:
        raise TypeError(f"the fused MFCC kernel takes float32, got {signal.dtype}")
    lead, t = signal.shape[:-1], signal.shape[-1]
    x = signal.reshape(-1, t).contiguous()
    count = max((t - cfg.frame_size) // cfg.frame_step, 0)
    out = torch.empty((x.shape[0], count, cfg.num_cepstral), dtype=torch.float32,
                      device=signal.device)
    if count == 0 or x.shape[0] == 0:
        return out.reshape(lead + out.shape[1:])
    _launch(_lib(), x, cfg, out)
    mfcc_fused.launches += 1
    return out.reshape(lead + out.shape[1:])


def _launch(lib: ctypes.CDLL, x: torch.Tensor, cfg: FeatureConfig, out: torch.Tensor) -> None:
    """One launch of the kernel in ``lib`` on x (B, T) into out (B, F, C),
    both contiguous float32 on one CUDA device, F > 0."""
    c = _kernel_tensors(cfg, x.device)
    with torch.cuda.device(x.device):
        err = lib.mfcc_fft_launch(
            x.data_ptr(), c["tw"].data_ptr(), c["wpack"].data_ptr(), c["ranges"].data_ptr(),
            c["dct"].data_ptr(), out.data_ptr(), x.shape[0], x.shape[-1], out.shape[1],
            cfg.frame_step, cfg.frame_size, cfg.fft_points, *c["fft_plan"], c["kmax"],
            c["wpack"].numel(), cfg.num_filters, cfg.num_cepstral, int(cfg.dc_elimination),
            float(np.finfo(np.float32).eps), torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "mfcc_fft_launch")


mfcc_fused.launches = 0
