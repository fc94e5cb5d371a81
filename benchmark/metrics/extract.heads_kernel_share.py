"""``extract.heads_kernel_share``: the share of the run's chunk-GEMM
products whose heads one launch of the heads kernel wrote
(``ops/cuda/speechpy_heads.cu``): the program's cumulative launch counters,
the heads kernel's (``speechpy_heads.heads.launches``) over the edge
kernel's (``speechpy_edges.edge_sums.launches``, one a product), a replayed
graph's launches among them, over the whole run.  None where the program
has no heads kernel (a commit before it) or launched no edge kernel."""


def read(ctx):
    try:
        from mfcc_rust_tpu_torch.ops.cuda.speechpy_edges import edge_sums
        from mfcc_rust_tpu_torch.ops.cuda.speechpy_heads import heads
    except ImportError:
        return None
    return heads.launches / edge_sums.launches if edge_sums.launches else None
