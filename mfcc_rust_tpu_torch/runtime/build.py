"""Lazy native build: compile runtime/src/*.cpp into one cached .so under
``runtime/_build/``, named by the digest of the sources."""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(_SRC_DIR.glob("*.cpp")):
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile() -> Optional[Path]:
    _BUILD_DIR.mkdir(exist_ok=True)
    out = _BUILD_DIR / f"libmfccrt_{_source_digest()}.so"
    if out.exists():
        return out
    srcs = [str(p) for p in sorted(_SRC_DIR.glob("*.cpp"))]
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-o", str(out), *srcs,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    return out


def load_native() -> Optional[ctypes.CDLL]:
    """The compiled runtime library, or None when unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        # --- wav_io ---
        lib.wav_probe.restype = ctypes.c_int
        lib.wav_probe.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.wav_read_f32.restype = ctypes.c_int
        lib.wav_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.c_int,
        ]
        lib.wav_write_pcm16.restype = ctypes.c_int
        lib.wav_write_pcm16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint16,
        ]
        # --- prefetch ---
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_native() is not None
