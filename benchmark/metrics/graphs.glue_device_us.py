"""``graphs.glue_device_us``: device µs a replayed call spent outside its
graph: the operations that ``graphs.fill`` (the static input's copy, the
bucket tail's zeros) and ``graphs.copy_out`` (the outputs' copies) enqueue,
each put under its span by its launch's correlation
(:mod:`benchkit.replay_split`).  Read from the spans, for a path whose
kernels no name sets apart from its glue (``api.glue_device_us`` takes the
configuration's ``kernel_events``)."""

from benchkit import replay_split


def read(ctx):
    s = replay_split.numbers(ctx)
    return None if s is None else s["us"]["graphs.fill"] + s["us"]["graphs.copy_out"]
