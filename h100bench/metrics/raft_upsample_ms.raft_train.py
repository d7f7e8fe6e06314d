"""raft_upsample_ms.raft_train: median over the profiled steps of the stream ms of a step's vstab.flow.raft.upsample spans (the mask head and the convex upsampling, one an iteration) summed."""

from h100bench import step_spans


def read(ctx):
    return step_spans.per_step_ms(ctx, "vstab.flow.raft.upsample")
