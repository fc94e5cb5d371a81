"""``api.glue_device_us.host_paced``: ``api.glue_device_us``, read by ``metrics/api.glue_device_us.py``,
in the cells that report ``audio_s_per_s.host_paced``: those in which the
host's enqueue of a call reaches the device's time a call."""

from benchkit import spec

read = spec.metric("api.glue_device_us").read
