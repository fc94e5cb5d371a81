"""``k2.reflect_share``: the share of the run's K2 launches
(``ops/cuda/ct_mel.cu``) that staged the reflect centre pad's edges
themselves, with no pad launch before them: the program's cumulative launch
counters, ``ct_mel.reflect_launches`` over ``ct_mel.ct_mel.launches``, a
replayed graph's launches among them, over the whole run.  None where the
program has no such counter (a commit before it) or launched no K2."""


def read(ctx):
    try:
        from mfcc_rust_tpu_torch.ops.cuda.ct_mel import ct_mel, reflect_launches
    except ImportError:
        return None
    return reflect_launches.launches / ct_mel.launches if ct_mel.launches else None
