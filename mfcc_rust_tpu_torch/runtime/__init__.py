"""Native runtime layer: C++ WAV codec + threaded prefetch loader (the
port's own copy of the reference package's ``runtime``; the C++ sources are
byte-identical).

Built lazily with g++ into a cached shared object and bound via ctypes (no
pybind11 needed).  A pure-Python/scipy fallback keeps everything working
when no compiler is available.
"""

from .build import native_available  # noqa: F401
from .loader import AudioLoader, ClipMeta  # noqa: F401
from .wav import read_wav, wav_info, write_wav  # noqa: F401
