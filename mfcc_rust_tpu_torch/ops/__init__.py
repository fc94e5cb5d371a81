"""DSP primitive ops on tensors (port of ``mfcc_rust_tpu.ops``)."""

from . import (  # noqa: F401
    dct, delta, fft, framing, mel, normalize, resample, spectrum, ssc, stft,
)
from .dct import dct2_ortho  # noqa: F401
from .delta import delta as time_delta  # noqa: F401
from .delta import delta_librosa, derivative_extraction, extract_derivative_feature  # noqa: F401
from .fft import ct_power_project, permute_weights_for_ct, rfft_ct  # noqa: F401
from .framing import frame_signal, pad_signal, preemphasis, stack_frames  # noqa: F401
from .mel import apply_filterbank, filterbank_matrix  # noqa: F401
from .normalize import apply_corpus_cmvn, cmvn, cmvnw, masked_moments  # noqa: F401
from .resample import resample as resample_audio  # noqa: F401
from .resample import resample_poly  # noqa: F401
from .spectrum import (  # noqa: F401
    fft_spectrum,
    log_power_spectrum,
    power_spectrum,
    power_to_db,
    rdft,
    zero_handling,
)
from .ssc import ssc_from_power  # noqa: F401
from .stft import (  # noqa: F401
    librosa_frame_count,
    stft_framed,
    stft_streaming,
    stft_vorbis,
    stft_vorbis_power,
    streaming_init,
    streaming_step,
)
