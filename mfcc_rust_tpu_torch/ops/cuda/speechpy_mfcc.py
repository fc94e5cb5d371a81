"""Fused speechpy MFCC: the CUDA kernel ``speechpy_mfcc.cu``, its binding,
and its plain PyTorch version.

Replaces the TPU kernel ``mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py``
(``mfcc_pallas``): chunk-GEMM against the ``[C|S|w|±w]`` wall, Parseval
frame energies, mel projection, f32-eps zero handling, log, DCT-II ortho
and dc-elimination in one launch that writes only the (B, F, C) answer.
The kernel is compute-bound in FP32 (see the note in the .cu source).

:func:`mfcc_fused` launches the kernel for a CUDA tensor and runs
:func:`mfcc_fused_plain` for a CPU tensor; it never falls back from one to
the other.  ``mfcc_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF

from ... import features as _F
from ...config import FeatureConfig, fp32_matmul
from ...constants import chunk_gemm_wall, constant_bundle
from ..spectrum import resolve_fft_impl, zero_handling

KERNEL = "speechpy_mfcc"

# tile shape of speechpy_mfcc.cu (kTileF, kTileK, kPassW, kMaxSmem)
_TILE_F, _TILE_K, _PASS_W, _MAX_SMEM = 64, 32, 288, 232448


def smem_bytes(hop: int, r: int, m: int, w: int) -> int:
    """Dynamic shared memory of one block (``Layout`` in the .cu): the
    signal slab and a wall tile, y*y of a pass (over the first two when
    one pass covers the W wall columns), P and the sums of squares."""
    round4 = lambda n: -(-n // 4) * 4
    stage = round4((_TILE_F + r - 1) * hop) + _TILE_K * _PASS_W
    ysq = _TILE_F * _PASS_W
    body = max(stage, ysq) if w <= _PASS_W else stage + ysq
    return 4 * (body + round4(_TILE_F * (m + 1)) + _TILE_F)


def mfcc_kernel_supported(cfg: FeatureConfig) -> bool:
    """Rect-window speechpy framing on the chunk-GEMM fast path, f32,
    bounded r, an even fft, and a tile that fits in shared memory.  (The
    TPU kernel's num_filters <= 127 lane bound does not apply here.)"""
    r = _F._chunk_r(cfg)
    return (
        cfg.window == "rect"
        and cfg.dtype == "float32"
        and cfg.frame_size <= cfg.fft_points
        and r is not None
        and cfg.fft_points % 2 == 0
        and resolve_fft_impl(cfg) == "matmul"
        and cfg.num_cepstral <= cfg.num_filters
        and smem_bytes(cfg.frame_step, r, cfg.num_filters,
                       2 * constant_bundle(cfg)["fbank_kmax"] + 2) <= _MAX_SMEM
    )


@functools.lru_cache(maxsize=16)
def _mfcc_constants(cfg: FeatureConfig):
    """f32 constants from the float64 builders: wall (r*hop, W), proj
    (W, M+1), dct (M, C), emask (1, r*hop) (1.0 on the first frame_size
    lanes), and r, hop, fl.  The kernel's emask is the bound ``k < fl`` of
    its sum of squares."""
    wd = chunk_gemm_wall(cfg, True)
    emask = np.zeros((1, wd["r"] * wd["hop"]))
    emask[0, : wd["fl"]] = 1.0
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return (f32(wd["wall"]), f32(_F._projection(cfg)), f32(constant_bundle(cfg)["dct"]),
            f32(emask), wd["r"], wd["hop"], wd["fl"])


def _shape(cfg: FeatureConfig, wall: torch.Tensor):
    hop = cfg.frame_step
    return wall.shape[0] // hop, hop, cfg.frame_size


@fp32_matmul()
def mfcc_fused_plain(signal: torch.Tensor, cfg: FeatureConfig,
                     consts: Optional[dict] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (..., T) -> (..., F, C) with
    F = (T - fl) // hop (0 when T < fl).  Preemphasis is the caller's."""
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

    lib = library(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_fused_launch.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, i, i,
                                      i, i, i, i, i, i, ctypes.c_float, p]
    lib.mfcc_fused_launch.restype = i
    lib.mfcc_fused_smem_bytes.argtypes = [i, i, i, i]
    lib.mfcc_fused_smem_bytes.restype = ctypes.c_longlong
    lib.mfcc_cuda_error_string.argtypes = [i]
    lib.mfcc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def mfcc_fused(signal: torch.Tensor, cfg: FeatureConfig,
               consts: Optional[dict] = None) -> torch.Tensor:
    """Fused speechpy MFCC, (..., T) -> (..., F, C).  A CUDA tensor launches
    the kernel (and counts the launch); a CPU tensor runs
    :func:`mfcc_fused_plain`.  Preemphasis is the caller's."""
    if not mfcc_kernel_supported(cfg):
        raise ValueError("config not supported by the fused MFCC kernel")
    if not signal.is_cuda:
        return mfcc_fused_plain(signal, cfg, consts)
    if signal.dtype != torch.float32:
        raise TypeError(f"the fused MFCC kernel takes float32, got {signal.dtype}")
    c = _F._consts(cfg, signal, consts)
    wall, proj, dct = (c[k] for k in ("wall", "proj", "dct"))
    for name, t in (("wall", wall), ("proj", proj), ("dct", dct)):
        if t.device != signal.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {signal.device}")
    r, hop, fl = _shape(cfg, wall)
    m, w = cfg.num_filters, wall.shape[1]
    if (wall.shape[0] != r * hop or proj.shape != (w, m + 1)
            or dct.shape != (m, cfg.num_cepstral)):
        raise ValueError(f"constant shapes {tuple(wall.shape)}, {tuple(proj.shape)}, "
                         f"{tuple(dct.shape)} do not match the config")
    lead, t = signal.shape[:-1], signal.shape[-1]
    x = signal.reshape(-1, t).contiguous()
    count = max((t - fl) // hop, 0)
    out = torch.empty((x.shape[0], count, cfg.num_cepstral), dtype=torch.float32,
                      device=signal.device)
    if count == 0 or x.shape[0] == 0:
        return out.reshape(lead + out.shape[1:])
    lib = _lib()
    with torch.cuda.device(signal.device):
        err = lib.mfcc_fused_launch(
            x.data_ptr(), wall.data_ptr(), proj.data_ptr(), dct.data_ptr(), out.data_ptr(),
            x.shape[0], t, count, hop, r, fl, wall.shape[1], cfg.num_filters,
            cfg.num_cepstral, cfg.fft_points, int(cfg.dc_elimination),
            float(np.finfo(np.float32).eps), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"mfcc_fused_launch failed: {lib.mfcc_cuda_error_string(err).decode()}")
    mfcc_fused.launches += 1
    return out.reshape(lead + out.shape[1:])


mfcc_fused.launches = 0
