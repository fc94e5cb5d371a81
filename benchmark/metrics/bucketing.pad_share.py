"""``bucketing.pad_share``: the share of the samples the ``api`` calls
computed on that are the bucket's zeros, 1 - true / bucketed, from the
program's cumulative counter (``mfcc_rust_tpu_torch.utils.bucketing.samples``)
over the whole run; a librosa call's true length includes its centre pad.
None where the program has no counter (a commit before it) or counted
nothing."""


def read(ctx):
    try:
        from mfcc_rust_tpu_torch.utils.bucketing import samples
    except ImportError:
        return None
    true, bucketed = samples.read()
    return 1.0 - true / bucketed if bucketed else None
