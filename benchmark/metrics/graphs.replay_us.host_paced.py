"""``graphs.replay_us.host_paced``: ``graphs.replay_us``, read by
``metrics/graphs.replay_us.py``, in the cells that report
``audio_s_per_s.host_paced``."""

from benchkit import spec

read = spec.metric("graphs.replay_us").read
