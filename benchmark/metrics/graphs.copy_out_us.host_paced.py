"""``graphs.copy_out_us.host_paced``: ``graphs.copy_out_us``, read by
``metrics/graphs.copy_out_us.py``, in the cells that report
``audio_s_per_s.host_paced``."""

from benchkit import spec

read = spec.metric("graphs.copy_out_us").read
