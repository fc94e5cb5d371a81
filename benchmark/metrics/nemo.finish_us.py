"""``nemo.finish_us``: device µs a call in the NeMo finish's kernel events
(``nemo_finish``: the statistics in parts, then the normalising transpose,
``ops/cuda/nemo_logmel.cu``), from the traced slice; None where the trace
has none."""

EVENTS = ("nemo_finish",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.count(*EVENTS):
        return None
    return 1e6 * t.device_s(*EVENTS) / t.calls
