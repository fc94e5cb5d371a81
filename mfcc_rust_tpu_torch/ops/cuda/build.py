"""Build the port's CUDA kernels from the sources in this directory.

Each ``<name>.cu`` has a plain C interface and is compiled by one ``nvcc``
call into ``_build/lib<name>-<hash>.so`` for ``sm_90a``, then loaded with
``ctypes``.  The hash covers the source, the shared ``*.cuh`` headers it
may include and the flags, so an edited source or header builds anew.  ``nvcc`` is called directly rather than through
``torch.utils.cpp_extension.load``: that needs ``ninja`` and compiles
PyTorch's headers, which takes minutes where a plain C file takes seconds.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (HERE / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(HERE.glob("*.cuh")))  # the shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is built; returns
    (target, process or None, temporary output)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(HERE / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, proc, tmp


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all nvcc calls
    running at once; returns each name's compiler output ("" when it was
    already built).  Raises when a build fails."""
    started = {name: _start(name) for name in names}
    logs = {}
    failed = []
    for name, (target, proc, tmp) in started.items():
        if proc is None:
            logs[name] = ""
            continue
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
