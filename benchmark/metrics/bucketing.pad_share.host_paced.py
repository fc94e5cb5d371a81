"""``bucketing.pad_share.host_paced``: ``bucketing.pad_share``, read by
``metrics/bucketing.pad_share.py``, in the cells that report
``audio_s_per_s.host_paced``."""

from benchkit import spec

read = spec.metric("bucketing.pad_share").read
