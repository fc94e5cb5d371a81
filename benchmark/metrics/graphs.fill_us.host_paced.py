"""``graphs.fill_us.host_paced``: ``graphs.fill_us``, read by
``metrics/graphs.fill_us.py``, in the cells that report
``audio_s_per_s.host_paced``."""

from benchkit import spec

read = spec.metric("graphs.fill_us").read
