"""``audio_s_per_s.host_paced``: ``audio_s_per_s``, read by ``metrics/audio_s_per_s.py``,
in the cells that report ``audio_s_per_s.host_paced``: those in which the
host's enqueue of a call reaches the device's time a call."""

from benchkit import spec

read = spec.metric("audio_s_per_s").read
