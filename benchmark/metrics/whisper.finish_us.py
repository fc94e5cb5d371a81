"""``whisper.finish_us``: device µs a call in the Whisper finish's kernel
events (``whisper_logmel``: the rows' maxima and the finish,
``ops/cuda/whisper_logmel.cu``), from the traced slice; None where the trace
has none."""

EVENTS = ("whisper_logmel",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.count(*EVENTS):
        return None
    return 1e6 * t.device_s(*EVENTS) / t.calls
