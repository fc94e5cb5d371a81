"""Cooley–Tukey rFFT as two stages of products (port of
``mfcc_rust_tpu.ops.fft``).

Factor N = N1·N2 and evaluate the DFT in two product stages with a twiddle
in between, O(N·(N1+N2)) operations per frame against O(N·K) for the direct
DFT product.  Decimation in time with n = n1 + N1·n2:

    inner(n1, r)  = sum_{n2} x[n1 + N1 n2] · W_{N2}^{n2 r}        (stage 1)
    z(n1, r)      = inner(n1, r) · W_N^{n1 r}                      (twiddle)
    X[r + N2 k1]  = sum_{n1} z(n1, r) · W_{N1}^{n1 k1}             (stage 2)

The constant builders are float64 numpy, copies of the JAX package's (a test
pins them array-equal); the products run under :func:`fp32_matmul`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from ..config import fp32_matmul
from ..constants import tensor_cache


def good_factorization(n: int) -> Optional[Tuple[int, int]]:
    """N1·N2 = n for the two stages: N1 = 128 when n // 128 >= 8, else
    near-square factors, or None when n has no usable factorization (a
    prime, say).  The rule is the reference's, so ``fft_impl="auto"``
    resolves alike in both packages."""
    if n % 128 == 0 and n // 128 >= 8:
        return (128, n // 128)
    best = None
    for n2 in range(int(math.isqrt(n)), 1, -1):
        if n % n2 == 0:
            n1 = n // n2
            if n1 / n2 <= 8:  # keep the products reasonably square
                best = (n1, n2)
            break
    return best


@functools.lru_cache(maxsize=16)
def _ct_constants(n: int, n1: int, n2: int):
    """float64 stage matrices and twiddles, cached per size."""
    r2 = np.arange(n2)
    c2 = np.cos(2 * np.pi * np.outer(r2, r2) / n2)
    s2 = -np.sin(2 * np.pi * np.outer(r2, r2) / n2)
    k1 = np.arange(n1 // 2 + 1)
    a1 = np.arange(n1)
    c1 = np.cos(2 * np.pi * np.outer(a1, k1) / n1)
    s1 = -np.sin(2 * np.pi * np.outer(a1, k1) / n1)
    ang = 2 * np.pi * np.outer(a1, r2) / n  # W_N^{n1 r}
    twr = np.cos(ang)
    twi = -np.sin(ang)
    return c2, s2, c1, s1, twr, twi


@tensor_cache(maxsize=32)
def _ct_tensors(n: int, n1: int, n2: int, k1max: int, device: torch.device,
                dtype: torch.dtype) -> dict:
    """The stage constants as tensors on one device and dtype: ``st1``
    (2*N2, N2), ``st2`` (2*N1, 2*k1max), the twiddles ``twr``/``twi`` on the
    (r, n1) plane and the folded ``a``/``b`` (N2, N1, 2*k1max)."""
    _, _, _, _, twr, twi = _ct_constants(n, n1, n2)
    st1, st2 = _ct_stage_matrices(n, n1, n2, k1max)
    a, b = _ct_foldtw_matrices(n, n1, n2, k1max)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)
    return {"st1": t(st1), "st2": t(st2), "twr": t(twr.T), "twi": t(twi.T),
            "a": t(a), "b": t(b)}


def rfft_ct(
    frames: torch.Tensor,
    n_fft: int,
    factors: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L) real frames -> (real, imag) rFFT of size n_fft, each
    (..., n_fft//2 + 1).  Frames shorter than n_fft are zero-padded, longer
    ones truncated (``np.fft.rfft(n=)`` semantics)."""
    if factors is None:
        factors = good_factorization(n_fft)
        if factors is None:
            raise ValueError(f"n_fft={n_fft} has no balanced factorization")
    n1, n2 = factors
    if n1 * n2 != n_fft:
        raise ValueError(f"factors {factors} do not multiply to {n_fft}")
    l = frames.shape[-1]
    if l < n_fft:
        frames = tF.pad(frames, (0, n_fft - l))
    elif l > n_fft:
        frames = frames[..., :n_fft]
    xr, xi = _ct_stages(frames.reshape(frames.shape[:-1] + (n2, n1)), n_fft, n1, n2)
    # (..., N2=r, K1=k1) -> (..., K1, N2) flattens to k = N2*k1 + r
    xr = xr.transpose(-1, -2).reshape(frames.shape[:-1] + (-1,))
    xi = xi.transpose(-1, -2).reshape(frames.shape[:-1] + (-1,))
    k = n_fft // 2 + 1
    return xr[..., :k], xi[..., :k]


@functools.lru_cache(maxsize=16)
def _ct_stage_matrices(n: int, n1: int, n2: int, k1max: int):
    """Merged stage matrices: stage 1 stacks the real and imaginary inner
    DFTs, (2*N2, N2); stage 2 is the complex outer DFT as one real
    (2*N1, 2*k1max) matrix ``[[c1, s1], [-s1, c1]]``."""
    c2, s2, c1, s1, _, _ = _ct_constants(n, n1, n2)
    stage1 = np.concatenate([c2.T, s2.T], axis=0)  # (2*n2, n2)
    c1t, s1t = c1[:, :k1max], s1[:, :k1max]
    stage2 = np.concatenate(
        [
            np.concatenate([c1t, s1t], axis=1),
            np.concatenate([-s1t, c1t], axis=1),
        ],
        axis=0,
    )  # (2*n1, 2*k1max)
    return stage1, stage2


@fp32_matmul()
def _ct_stages(
    x: torch.Tensor, n_fft: int, n1: int, n2: int, k1max: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two stages on (..., N2, N1) frames; returns the rFFT in the
    native (..., N2=r, K1=k1) plane (bin k = N2*k1 + r; entries with
    k1 == N1/2 and r > 0 alias bins above N/2 and must be dropped or
    weighted zero by the consumer).  ``k1max`` trims the outer DFT to its
    first k1max columns."""
    if k1max is None:
        k1max = n1 // 2 + 1
    c = _ct_tensors(n_fft, n1, n2, k1max, x.device, x.dtype)
    # stage 1: inner DFT over n2 as one left product -> (..., 2*N2, N1)
    y = torch.matmul(c["st1"], x)
    ir = y[..., :n2, :]
    ii = y[..., n2:, :]
    # twiddle W_N^{n1 r} on the (r, n1) plane
    zr = ir * c["twr"] - ii * c["twi"]
    zi = ir * c["twi"] + ii * c["twr"]
    # stage 2: outer complex DFT over n1 as one product (contraction 2*N1)
    z = torch.cat([zr, zi], dim=-1)  # (..., N2, 2*N1)
    out = torch.matmul(z, c["st2"])  # (..., N2, 2*k1max)
    return out[..., :k1max], out[..., k1max:]


@functools.lru_cache(maxsize=16)
def _ct_foldtw_matrices(n: int, n1: int, n2: int, k1max: int):
    """Twiddle-folded per-r stage-2 matrices (float64, cached):
    ``[Xr | Xi][r] = ir[r] @ A[r] + ii[r] @ B[r]`` with ``A[r] = [P_r | Q_r]``,
    ``B[r] = [-Q_r | P_r]``, ``P_r = diag(twr_r)·c1 - diag(twi_r)·s1`` and
    ``Q_r = diag(twi_r)·c1 + diag(twr_r)·s1``."""
    _, _, c1, s1, twr, twi = _ct_constants(n, n1, n2)
    c1t, s1t = c1[:, :k1max], s1[:, :k1max]
    p = twr.T[:, :, None] * c1t[None] - twi.T[:, :, None] * s1t[None]
    q = twi.T[:, :, None] * c1t[None] + twr.T[:, :, None] * s1t[None]
    a = np.concatenate([p, q], axis=2)  # (N2, N1, 2*k1max)
    b = np.concatenate([-q, p], axis=2)
    return a, b


@functools.lru_cache(maxsize=16)
def _ct_bin_permutation(n_fft: int, n1: int, n2: int) -> np.ndarray:
    """Map the flat (r, k1) plane index r*K1 + k1 to the rFFT bin k, or -1
    for the alias entries above N/2."""
    k1max = n1 // 2 + 1
    out = np.full(n2 * k1max, -1, dtype=np.int64)
    for r in range(n2):
        for k1 in range(k1max):
            k = n2 * k1 + r
            if k <= n_fft // 2:
                out[r * k1max + k1] = k
    return out


def permute_weights_for_ct(weights: np.ndarray, n_fft: int,
                           factors: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Reorder a (M, n_fft//2+1) per-bin weight matrix (a mel filterbank)
    onto the CT output's flat (r, k1) plane, alias entries zero.  When the
    Nyquist bin carries zero weight (and N1 is even), the k1 == N1/2 plane
    is dropped: the output has N2*(N1//2) columns."""
    if factors is None:
        factors = good_factorization(n_fft)
    n1, n2 = factors
    k1full = n1 // 2 + 1
    # for odd N1 the k1 == N1/2 plane holds valid bins and must stay
    trim = n1 % 2 == 0 and not np.any(weights[:, n_fft // 2])
    k1max = n1 // 2 if trim else k1full
    full = _ct_bin_permutation(n_fft, n1, n2).reshape(n2, k1full)
    perm = full[:, :k1max].reshape(-1)
    out = np.zeros((weights.shape[0], len(perm)), dtype=weights.dtype)
    valid = perm >= 0
    out[:, valid] = weights[:, perm[valid]]
    return out


@fp32_matmul()
def ct_power_project(
    frames_n2n1: torch.Tensor,
    n_fft: int,
    n1: int,
    n2: int,
    projection_t: torch.Tensor,
    scale: float = 1.0,
    stages: Optional[dict] = None,
) -> torch.Tensor:
    """(..., N2, N1) windowed frames -> (..., M): CT rFFT, |X|^2 * scale,
    then the product with ``projection_t`` ((N2*k1max, M), built with
    :func:`permute_weights_for_ct`; k1max, inferred from its height, is
    N1//2 when the Nyquist plane was trimmed, N1//2+1 otherwise).
    ``stages``: the ``st1``, ``a`` and ``b`` of :func:`_ct_tensors`, else
    taken from its cache."""
    k1max, rem = divmod(projection_t.shape[0], n2)
    allowed = {n1 // 2 + 1} | ({n1 // 2} if n1 % 2 == 0 else set())
    if rem or k1max not in allowed:
        raise ValueError(
            f"projection width {projection_t.shape[0]} does not match the "
            f"(N2={n2}, k1max in {sorted(allowed)}) CT plane"
        )
    x = frames_n2n1
    c = stages if stages is not None else _ct_tensors(n_fft, n1, n2, k1max, x.device, x.dtype)
    # stage 1: inner DFT over n2, one left product -> (..., 2*N2, N1)
    y = torch.matmul(c["st1"], x)
    ir, ii = y[..., :n2, :], y[..., n2:, :]
    # stage 2 with the twiddle folded into per-r batched matrices
    out = (torch.einsum("...rn,rnk->...rk", ir, c["a"])
           + torch.einsum("...rn,rnk->...rk", ii, c["b"]))
    xr, xi = out[..., :k1max], out[..., k1max:]
    power = (xr * xr + xi * xi) * scale
    flat = power.reshape(power.shape[:-2] + (-1,))
    return torch.matmul(flat, projection_t)
