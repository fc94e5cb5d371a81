"""``nemo.launches_per_call``: the NeMo prologue's and finish's kernel
launches a call, from the program's cumulative counters over the whole run:
their launch counters (``ops/cuda/nemo_logmel.py``,
``nemo_prologue.launches`` and ``nemo_finish.launches``, a replayed graph's
launches among them) over the ``api`` calls counted by path (``api.paths``:
direct, graphed and eager).  None where the program has no such kernels (a
commit before them) or counted no call."""


def read(ctx):
    try:
        from mfcc_rust_tpu_torch.api import paths
        from mfcc_rust_tpu_torch.ops.cuda.nemo_logmel import nemo_finish, nemo_prologue
    except ImportError:
        return None
    calls = sum(paths.read().values())
    return (nemo_prologue.launches + nemo_finish.launches) / calls if calls else None
