"""``graphs.run_self_us.host_paced``: ``graphs.run_self_us``, read by
``metrics/graphs.run_self_us.py``, in the cells that report
``audio_s_per_s.host_paced``."""

from benchkit import spec

read = spec.metric("graphs.run_self_us").read
