"""X_0 and X_{N/2} of every speechpy frame, summed in float64, written into
the chunk-GEMM product: the CUDA kernel ``speechpy_edges.cu`` and its
binding.  The plain version is :func:`...features._exact_edges_plain`.

The plain chunk-GEMM path (``features._speechpy_product``: ``mfe``,
``lmfe``, ``ssc``, ``extract``, the corpus steps' heads) takes X_0 and
X_{N/2} from here on a CUDA float32 tensor, as the fused kernel sums them
itself: reading the signal once, where the plain version copies it to
float64 for one more product.  ``edge_sums.launches`` counts the kernel's
launches, a replayed CUDA graph's among them (``utils/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import FeatureConfig
from ...constants import constant_bundle
from ...features import _edge_weights

KERNEL = "speechpy_edges"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .build import library

    lib = library(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.edge_sums_launch.argtypes = [p, ll, ll, p, i, i, ll, i, p, ll, i, i, i, i, p]
    lib.edge_sums_launch.restype = i
    lib.edge_sums_error_string.argtypes = [i]
    lib.edge_sums_error_string.restype = ctypes.c_char_p
    return lib


def edge_sums(x: torch.Tensor, y: torch.Tensor, cfg: FeatureConfig, n_frames: int) -> torch.Tensor:
    """Write X_0 (columns 0 and 2*kmax) and X_{N/2} (column 2*kmax + 1) of
    the first ``n_frames`` frames of the signal ``x`` (..., T), samples past
    T reading zero, into the contiguous float32 product ``y`` (..., n_frames,
    W) on the same CUDA device, in place; returns ``y``."""
    t = x.shape[-1]
    xs = x.reshape(-1, t)
    if xs.stride(-1) != 1:
        xs = xs.contiguous()
    rows = xs.shape[0]
    if rows == 0 or n_frames == 0:
        return y
    k = constant_bundle(cfg)["fbank_kmax"]
    w = _edge_weights(cfg, x.device)[0]
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.edge_sums_launch(
            xs.data_ptr(), xs.stride(0), t, w.data_ptr(), w.numel(), cfg.frame_step, rows,
            n_frames, y.data_ptr(), n_frames * y.shape[-1], y.shape[-1], 0, 2 * k, 2 * k + 1,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"edge_sums_launch failed: {lib.edge_sums_error_string(err).decode()}")
    edge_sums.launches += 1
    return y


edge_sums.launches = 0
