"""The benchmark's plain reference of speechpy's feature suite: ``mfe`` (the
mel filterbank energies and the frame energies), ``lmfe``, ``ssc`` and
``mfcc`` of a (rows, T) batch, as batched PyTorch in float64, computed in
blocks of rows so that it fits on the card beside the answers it judges.

It follows :mod:`speechpy_ref` (the frozen float64 numpy oracle) head by
head: speechpy's framing without zero padding, ``|rfft|^2 / N``, the
integer-bin filterbank, the float32 epsilon in place of a zero mel or frame
energy, the float64 epsilon in place of a zero power bin for ``ssc``, and
the MFCC through :func:`plain.speechpy_mfcc_of_frames`.  Every constant
(filterbank, DCT, DFT, the SSC's bin frequencies) comes from the oracle's
builders.  Departures from speechpy are the oracle's own (its docstring:
the squared power spectrum, the orthonormal DCT, real overlapping frames);
``ssc`` is the oracle's spec, as speechpy's reference code has none.

``precision="tf32"`` is the control, as in :mod:`plain`: float32 with every
product (the DFT, the mel projection, the SSC's numerator and denominator,
the DCT) on TF32-rounded inputs.  A call switches TF32 off in PyTorch's own
products (:func:`ieee_float32`), so that float32 is IEEE on the card.
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain, speechpy_ref

BLOCK_ROWS = 8


def ieee_float32() -> None:
    """TF32 off in PyTorch's own float32 products, cuBLAS and cuDNN alike.
    Left off: the measured process wants IEEE float32 throughout, as the
    configuration states, and only setters are used (reading the legacy
    flags after the program set ``fp32_precision`` may raise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _where_zero(t: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(t == 0.0, torch.full_like(t, eps), t)


def _block(x: torch.Tensor, sample_rate: int, frame_length: float, frame_stride: float,
           num_cepstral: int, num_filters: int, fft_length: int, low_frequency: float,
           high_frequency, dc_elimination: bool, precision: str) -> dict:
    """The four heads of a block of (rows, T) signals."""
    dev = x.device
    frames = plain.speechpy_frames(x.to(plain._dtype(precision)), sample_rate, frame_length,
                                   frame_stride)
    ps = plain._power(frames, fft_length, precision, dev) / fft_length
    fb = speechpy_ref.filterbanks(num_filters, fft_length // 2 + 1, sample_rate, low_frequency,
                                  high_frequency)
    fbt = plain._const(fb.T, precision, dev)
    energy = _where_zero(ps.sum(-1), speechpy_ref.EPS32)
    feat = _where_zero(plain._mm(ps, fbt, precision), speechpy_ref.EPS32)
    pz = _where_zero(ps, speechpy_ref.EPS64)
    ramp = torch.as_tensor(np.linspace(1.0, sample_rate / 2.0, ps.shape[-1]), dtype=ps.dtype,
                           device=dev)
    ssc = plain._mm(pz * ramp, fbt, precision) / plain._mm(pz, fbt, precision)
    mfcc = plain.speechpy_mfcc_of_frames(
        frames, sample_rate, num_cepstral=num_cepstral, num_filters=num_filters,
        fft_length=fft_length, low_frequency=low_frequency, high_frequency=high_frequency,
        dc_elimination=dc_elimination, precision=precision)
    return {"mfe": (feat, energy), "lmfe": feat.log(), "ssc": ssc, "mfcc": mfcc}


def speechpy_suite(x: torch.Tensor, sample_rate: int, frame_length=0.020, frame_stride=0.01,
                   num_cepstral=13, num_filters=40, fft_length=512, low_frequency=0.0,
                   high_frequency=None, dc_elimination=True, precision="float64",
                   block_rows=BLOCK_ROWS) -> dict:
    """speechpy's ``mfe``, ``lmfe``, ``ssc`` and ``mfcc`` of (rows, T)
    signals: {"mfe": ((rows, F, M), (rows, F)), "lmfe": (rows, F, M),
    "ssc": (rows, F, M), "mfcc": (rows, F, C)}, F = floor((T - fl) / hop)."""
    kw = dict(sample_rate=sample_rate, frame_length=frame_length, frame_stride=frame_stride,
              num_cepstral=num_cepstral, num_filters=num_filters, fft_length=fft_length,
              low_frequency=low_frequency, high_frequency=high_frequency,
              dc_elimination=dc_elimination, precision=precision)
    ieee_float32()
    parts = [_block(x[i:i + block_rows], **kw) for i in range(0, x.shape[0], block_rows)]
    out = {k: torch.cat([p[k] for p in parts]) for k in ("lmfe", "ssc", "mfcc")}
    out["mfe"] = tuple(torch.cat([p["mfe"][j] for p in parts]) for j in range(2))
    return out


FUNCTIONS = {"speechpy_suite": speechpy_suite}
