"""A plain PCM16 mono WAV codec: the benchmark writes its corpus with it and
the reference decodes the files with it, apart from the program's codec."""

from __future__ import annotations

import struct

import numpy as np


def write(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write int16 ``samples`` as a 44-byte-header mono PCM16 WAV."""
    data = np.ascontiguousarray(samples, dtype="<i2").tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
                         1, 1, sample_rate, 2 * sample_rate, 2, 16, b"data", len(data))
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)


def read(path) -> tuple:
    """(float64 samples in [-1, 1), sample rate) of a mono PCM16 WAV: each
    sample is its int16 value / 32768, the usual decoding."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, rate, fmt = 12, None, None
    while pos + 8 <= len(blob):
        tag, size = struct.unpack_from("<4sI", blob, pos)
        body = pos + 8
        if tag == b"fmt ":
            fmt, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", blob, body)
            if (fmt, channels, bits) != (1, 1, 16):
                raise ValueError(f"{path}: not mono PCM16")
        elif tag == b"data":
            if rate is None:
                raise ValueError(f"{path}: data before fmt")
            pcm = np.frombuffer(blob, dtype="<i2", count=size // 2, offset=body)
            return pcm.astype(np.float64) / 32768.0, rate
        pos = body + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")
