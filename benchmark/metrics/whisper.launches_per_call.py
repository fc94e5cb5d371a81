"""``whisper.launches_per_call``: the Whisper finish's kernel launches a
call, from the program's cumulative counters over the whole run: the
finish's launch counter (``ops/cuda/whisper_logmel.py``,
``whisper_logmel.launches``, a replayed graph's launches among them) over
the ``api`` calls counted by path (``api.paths``: direct, graphed and
eager).  None where the program has no finish kernel (a commit before it)
or counted no call."""


def read(ctx):
    try:
        from mfcc_rust_tpu_torch.api import paths
        from mfcc_rust_tpu_torch.ops.cuda.whisper_logmel import whisper_logmel
    except ImportError:
        return None
    calls = sum(paths.read().values())
    return whisper_logmel.launches / calls if calls else None
