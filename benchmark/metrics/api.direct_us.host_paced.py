"""``api.direct_us.host_paced``: ``api.direct_us``, read by ``metrics/api.direct_us.py``,
in the cells that report ``audio_s_per_s.host_paced``: host µs a call in
the ``api.direct`` span, there the enqueue of the centre pad and one launch
of K2 on the caller's signal.  None where no call took the path (a commit
before it)."""

from benchkit import spec

read = spec.metric("api.direct_us").read
