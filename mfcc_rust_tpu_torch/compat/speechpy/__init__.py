"""speechpy drop-in: ``from mfcc_rust_tpu_torch.compat import speechpy`` and
call ``speechpy.feature.mfcc`` or ``speechpy.processing.cmvn`` as with
astorfi/speechpy: the same module layout, signatures and defaults, plus a
trailing ``device`` keyword (CUDA unless ``device="cpu"``).  Results are
tensors."""

from . import feature, processing  # noqa: F401
