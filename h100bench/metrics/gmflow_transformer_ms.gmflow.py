"""gmflow_transformer_ms.gmflow: median over the profiled section's chunks of the summed stream ms of the chunk's two spans vstab.flow.gmflow.transformer (1/8 and 1/4)."""

from h100bench.drivers import stabilize_gmflow


def read(ctx):
    return stabilize_gmflow.chunk_median_ms(ctx, "transformer")
