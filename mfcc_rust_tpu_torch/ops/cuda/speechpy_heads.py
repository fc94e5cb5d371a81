"""The speechpy heads of one chunk-GEMM product in one pass: the CUDA
kernel ``speechpy_heads.cu`` and its binding.  The plain version is
:func:`...features._extract_heads_plain`.

``features._extract_heads`` (the body of ``extract``, the data-parallel
multi-head step and the graphs that capture them) launches :func:`heads`
after the wall product and the edge sums have written the product ``y``:
one kernel reads each product row and each frame's samples once and writes
the requested heads (``mfe``, ``energy``, ``lmfe``, ``ssc``, ``mfcc``),
where the plain version makes several passes over ``y`` and three small
products.  ``heads.launches`` counts the kernel's launches, a replayed CUDA
graph's among them (``utils/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import features as _F
from ...config import FeatureConfig
from ...constants import chunk_gemm_wall, constant_bundle, tensor_cache
from .ct_mel import pack_filterbank

KERNEL = "speechpy_heads"

# speechpy_heads.cu: Head, kWarpsPerBlock, fft::kMaxSmem
HEAD_BITS = {"mfe": 1, "energy": 2, "lmfe": 4, "ssc": 8, "mfcc": 16}
_WARPS, _MAX_SMEM = 8, 232448


def smem_bytes(w: int, nnz: int, m: int, c: int, fl: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the .cu): the
    three packed weight arrays, the (M, C) DCT, the fl squared window
    weights and the (M, 4) band schedule, then each warp's 4 product rows of
    w floats, each rounded up to four, and their (M, 4) band logs."""
    round4 = lambda v: -(-v // 4) * 4
    return 4 * (round4(3 * nnz + m * c + fl + 4 * m) + _WARPS * 4 * (round4(w) + m))


def band_schedule(ranges: np.ndarray) -> np.ndarray:
    """(M, 4) int32 (lo, hi, offset, band) of the (M, 3) ranges, in the
    order a warp's lanes take the bands (lane l those at l, l + 32, ...):
    the bands by width, the 32 widest first, each next 32 laid against the
    last in reverse, so that a lane that takes a second band took one of the
    narrowest of the first 32 and the widest bands share no lane."""
    wide = np.argsort(-(ranges[:, 1] - ranges[:, 0]), kind="stable")
    order = np.concatenate([wide[i:i + 32][::-1] if i % 64 == 0 else wide[i:i + 32]
                            for i in range(0, len(wide), 32)])
    return np.ascontiguousarray(np.column_stack([ranges[order], order]), np.int32)


@functools.lru_cache(maxsize=16)
def _kernel_constants(cfg: FeatureConfig):
    """(consts, sched, kmax, nnz): float32 ``[wmel | wnum | wden | dct | w2]``,
    the plain version's weights packed over each filter's nonzero bins
    [lo, hi): the mel columns of the projection (``_F._projection``, fb/N
    for |X_k|^2), the SSC numerator's ramp·fb and its denominator's fb
    (``_F._ssc_projection``), then the (M, C) DCT and the frame's squared
    window weights (fl); the bands' ranges, one for all three weight
    arrays, which share their nonzero bins, in the lanes' order
    (:func:`band_schedule`); nnz, the length of each weight array."""
    kmax = constant_bundle(cfg)["fbank_kmax"]
    m = cfg.num_filters
    wmel, ranges = pack_filterbank(_F._projection(cfg)[:kmax, :m].T)
    sscp = _F._ssc_projection(cfg)
    wnum, r_num = pack_filterbank(sscp[:, :m].T)
    wden, r_den = pack_filterbank(sscp[:, m:].T)
    assert np.array_equal(ranges, r_num) and np.array_equal(ranges, r_den)
    fl = min(cfg.frame_size, cfg.fft_points)
    w2 = chunk_gemm_wall(cfg, True)["w2"].reshape(-1)[:fl]
    consts = np.concatenate([wmel, wnum, wden, constant_bundle(cfg)["dct"].reshape(-1), w2])
    return np.ascontiguousarray(consts, np.float32), band_schedule(ranges), kmax, wmel.size


@functools.lru_cache(maxsize=64)
def heads_kernel_supported(cfg: FeatureConfig) -> bool:
    """Whether the block of a config on the chunk-GEMM fast path (the only
    configs that reach :func:`..features._extract_heads`) fits in shared
    memory: 4 product rows (2 kmax + 2 floats each) and their band logs for
    each of 8 warps, the weights (3 nnz), the M x C DCT, fl window weights
    and the band schedule, at most 232,448 bytes: no other bound on M, C or
    kmax.  At speechpy's defaults (kmax 129, M 40, C 13, nnz 210, fl 320) a
    block takes 44,928 bytes.  Cached per config."""
    _, _, kmax, nnz = _kernel_constants(cfg)
    fl = min(cfg.frame_size, cfg.fft_points)
    return smem_bytes(2 * kmax + 2, nnz, cfg.num_filters, cfg.num_cepstral, fl) <= _MAX_SMEM


@tensor_cache(maxsize=16)
def _kernel_tensors(cfg: FeatureConfig, device: torch.device) -> dict:
    consts, sched, kmax, nnz = _kernel_constants(cfg)
    return {"consts": torch.from_numpy(consts).to(device),
            "sched": torch.from_numpy(sched).to(device), "kmax": kmax, "nnz": nnz}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .build import library

    lib = library(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.speechpy_heads_launch.argtypes = [p, p, ll, p, p, p, p, p, p, p, ll, i, i, i, i, i, i,
                                          i, i, i, i, i, i, i, p]
    lib.speechpy_heads_launch.restype = i
    lib.speechpy_heads_smem_bytes.argtypes = [i, i, i, i, i]
    lib.speechpy_heads_smem_bytes.restype = i
    lib.speechpy_heads_error_string.argtypes = [i]
    lib.speechpy_heads_error_string.restype = ctypes.c_char_p
    return lib


def heads(ch: torch.Tensor, y: torch.Tensor, cfg: FeatureConfig, want, n_frames: int,
          need_energy: bool) -> dict:
    """The heads ``want`` of the contiguous float32 product ``y`` (...,
    n_frames, 2 kmax + 2) on a CUDA device, its X_0 and X_{N/2} exact, and
    of the chunks ``ch`` (..., n_frames + r - 1, hop) it was made from, as
    :func:`..features._extract_heads_plain` returns them; ``need_energy``
    as there.  One launch, none for a batch of no rows."""
    lead = y.shape[:-2]
    w, hop = y.shape[-1], ch.shape[-1]
    cs = ch.reshape((-1,) + ch.shape[-2:])
    if cs.stride(-1) != 1 or cs.stride(-2) != hop:
        cs = cs.contiguous()
    rows = cs.shape[0]
    m, c = cfg.num_filters, cfg.num_cepstral
    new = lambda *tail: y.new_empty(lead + (n_frames,) + tail)
    want = set(want)
    mel = new(m) if "mfe" in want else None
    energy = new() if want & {"mfe", "energy"} else None
    lmfe = new(m) if "lmfe" in want else None
    ssc = new(m) if "ssc" in want else None
    mfcc = new(c) if "mfcc" in want else None
    if rows and n_frames:
        k = _kernel_tensors(cfg, y.device)
        bits = sum(HEAD_BITS[h] for h in want)
        ptr = lambda t: t.data_ptr() if t is not None else None
        lib = _lib()
        with torch.cuda.device(y.device):
            err = lib.speechpy_heads_launch(
                y.data_ptr(), cs.data_ptr(), cs.stride(0), k["consts"].data_ptr(),
                k["sched"].data_ptr(), ptr(mel), ptr(energy), ptr(lmfe), ptr(ssc), ptr(mfcc),
                rows, n_frames, w, k["kmax"], k["nnz"], m, c,
                min(cfg.frame_size, cfg.fft_points), hop, cfg.fft_points, bits,
                int(need_energy), int(cfg.dc_elimination),
                int(w % 4 == 0 and y.data_ptr() % 16 == 0),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"speechpy_heads_launch failed: {lib.speechpy_heads_error_string(err).decode()}")
        heads.launches += 1
    out = {}
    if "mfe" in want:
        out["mfe"] = (mel, energy)
    if "energy" in want:
        out["energy"] = energy
    if "lmfe" in want:
        out["lmfe"] = lmfe
    if "mfcc" in want:
        out["mfcc"] = mfcc
    if "ssc" in want:
        out["ssc"] = ssc
    return out


heads.launches = 0
