"""gmflow_encode_ms.gmflow: median over the profiled section's chunks of the stream ms of the span vstab.flow.gmflow.encode (the backbone on the chunk's frames)."""

from h100bench.drivers import stabilize_gmflow


def read(ctx):
    return stabilize_gmflow.chunk_median_ms(ctx, "encode")
