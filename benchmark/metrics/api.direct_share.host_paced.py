"""``api.direct_share.host_paced``: ``api.direct_share``, read by ``metrics/api.direct_share.py``,
in the cells that report ``audio_s_per_s.host_paced``: the share of the
run's ``api`` calls that took the direct path, there the centre pad and one
launch of K2 on the caller's signal, through no graph.  None where the
program counts no librosa call (a commit before it)."""

from benchkit import spec

read = spec.metric("api.direct_share").read
