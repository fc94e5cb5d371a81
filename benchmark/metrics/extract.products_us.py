"""``extract.products_us``: device µs a call in the product kernels of the
traced slice, those whose name holds ``gemm`` (cuBLAS: the chunk-GEMM wall
product, the mel, SSC and DCT products).  With ``extract.elementwise_us``
and ``graphs.glue_device_us`` it adds up to the device time a call."""

EVENTS = ("gemm",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.device:
        return None
    return 1e6 * t.device_s(*EVENTS) / t.calls
