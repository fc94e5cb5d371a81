"""DSP primitive ops on tensors (port of ``mfcc_rust_tpu.ops``)."""

from . import dct, framing, mel, spectrum  # noqa: F401
from .dct import dct2_ortho  # noqa: F401
from .framing import frame_signal, preemphasis, stack_frames  # noqa: F401
from .mel import apply_filterbank, filterbank_matrix  # noqa: F401
from .spectrum import power_spectrum, rdft, zero_handling  # noqa: F401
