"""``api.direct_share``: the share of the run's speechpy-family ``api``
calls that launched K1 once on the caller's signal, through no graph, from
the program's cumulative counter (``mfcc_rust_tpu_torch.api.paths``:
``direct`` against ``graphed`` and ``eager``) over the whole run.  None
where the program has no counter (a commit before it) or counted nothing."""


def read(ctx):
    try:
        from mfcc_rust_tpu_torch.api import paths
    except ImportError:
        return None
    counts = paths.read()
    total = sum(counts.values())
    return counts["direct"] / total if total else None
