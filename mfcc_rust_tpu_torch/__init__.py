"""mfcc_rust_tpu_torch — the speech feature extractor in PyTorch, with
hand-written CUDA kernels for Hopper.

The port of the JAX package ``mfcc_rust_tpu``, slice by slice; that package
stays the reference and this one imports nothing of it.  Layers:

* config/constants — :mod:`.config` (frozen hashable FeatureConfig),
  :mod:`.constants` (float64 numpy builders, tensors per device)
* primitives — :mod:`.ops` (framing, spectrum, fft, stft, mel, dct) and
  :mod:`.ops.cuda` (kernels, each with its plain PyTorch version)
* features — :mod:`.features` (functions on tensors), :mod:`.models`
  (``nn.Module`` pipelines)
* entry points — :mod:`.api` (numpy or tensor in, tensor out; CUDA unless
  the caller asks for the CPU)
"""

from . import constants, features, ops  # noqa: F401
from .api import (  # noqa: F401
    lmfe,
    log_mel_spectrogram,
    mel_spectrogram_librosa,
    mfcc,
    mfcc_librosa,
    mfe,
)
from .config import (  # noqa: F401
    FeatureConfig,
    SpeechConfigBuilder,
    from_reference,
    librosa_config,
    speechpy_config,
)
from .models import (  # noqa: F401
    LibrosaMelPipeline,
    LibrosaMFCCPipeline,
    LogMFEPipeline,
    MFCCPipeline,
    MFEPipeline,
)

__version__ = "0.1.0"
