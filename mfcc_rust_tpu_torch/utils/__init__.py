from . import bucketing, padding, profiling  # noqa: F401
from .bucketing import bucket_batch, bucket_length, pad_to_bucket  # noqa: F401
from .device import resolve_device  # noqa: F401
