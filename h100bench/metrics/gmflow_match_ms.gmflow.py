"""gmflow_match_ms.gmflow: median over the profiled section's chunks of the summed stream ms of the chunk's spans vstab.flow.gmflow.match and vstab.flow.gmflow.propagate (global at 1/8, local at 1/4)."""

from h100bench.drivers import stabilize_gmflow


def read(ctx):
    return stabilize_gmflow.chunk_median_ms(ctx, "match")
