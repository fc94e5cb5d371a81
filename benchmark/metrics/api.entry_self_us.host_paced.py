"""``api.entry_self_us.host_paced``: ``api.entry_self_us``, read by
``metrics/api.entry_self_us.py``, in the cells that report
``audio_s_per_s.host_paced``."""

from benchkit import spec

read = spec.metric("api.entry_self_us").read
