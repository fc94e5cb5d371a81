"""DSP primitive ops on tensors (port of ``mfcc_rust_tpu.ops``)."""

from . import dct, fft, framing, mel, spectrum, stft  # noqa: F401
from .dct import dct2_ortho  # noqa: F401
from .fft import ct_power_project, permute_weights_for_ct, rfft_ct  # noqa: F401
from .framing import frame_signal, pad_signal, preemphasis, stack_frames  # noqa: F401
from .mel import apply_filterbank, filterbank_matrix  # noqa: F401
from .spectrum import power_spectrum, power_to_db, rdft, zero_handling  # noqa: F401
from .stft import librosa_frame_count, stft_framed  # noqa: F401
