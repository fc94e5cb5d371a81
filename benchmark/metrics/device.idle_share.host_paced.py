"""``device.idle_share.host_paced``: ``device.idle_share``, read by ``metrics/device.idle_share.py``,
in the cells that report ``audio_s_per_s.host_paced``: those in which the
host's enqueue of a call reaches the device's time a call."""

from benchkit import spec

read = spec.metric("device.idle_share").read
