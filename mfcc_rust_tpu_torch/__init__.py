"""mfcc_rust_tpu_torch — the speech feature extractor in PyTorch, with
hand-written CUDA kernels for Hopper.

The port of the JAX package ``mfcc_rust_tpu``, slice by slice; that package
stays the reference and this one imports nothing of it.  Layers:

* config/constants — :mod:`.config` (frozen hashable FeatureConfig),
  :mod:`.constants` (float64 numpy builders, tensors per device)
* primitives — :mod:`.ops` (framing, spectrum, fft, stft, mel, dct, ssc,
  delta, normalize, resample) and :mod:`.ops.cuda` (kernels, each with its
  plain PyTorch version)
* features — :mod:`.features` (functions on tensors), :mod:`.models`
  (``nn.Module`` pipelines), :mod:`.transforms` (torchaudio-style modules)
* entry points — :mod:`.api` (numpy or tensor in, tensor out; CUDA unless
  the caller asks for the CPU) and :mod:`.compat.speechpy`
"""

from . import constants, features, ops, transforms  # noqa: F401
from .api import (  # noqa: F401
    cmvn,
    cmvnw,
    delta,
    delta_librosa,
    derivative_extraction,
    extract,
    extract_derivative_feature,
    lmfe,
    log_mel_spectrogram,
    log_mel_spectrogram_nemo,
    log_mel_spectrogram_whisper,
    log_power_spectrum,
    mel_spectrogram,
    mel_spectrogram_librosa,
    mfcc,
    mfcc_librosa,
    mfe,
    preemphasis,
    resample,
    resample_poly,
    ssc,
    stack_frames,
)
from .config import (  # noqa: F401
    FeatureConfig,
    SpeechConfigBuilder,
    from_reference,
    librosa_config,
    speechpy_config,
    vorbis_config,
)
from .models import (  # noqa: F401
    FeatureExtractor,
    LibrosaMelPipeline,
    LibrosaMFCCPipeline,
    LogMFEPipeline,
    MelSpectrogramPipeline,
    MFCCPipeline,
    MFEPipeline,
    SSCPipeline,
)

__version__ = "0.1.0"
