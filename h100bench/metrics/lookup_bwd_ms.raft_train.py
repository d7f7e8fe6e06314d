"""lookup_bwd_ms.raft_train: median over the profiled steps of the stream ms of a step's vstab.flow.raft.lookup_bwd spans (the correlation lookup's backward launches) summed."""

from h100bench import step_spans


def read(ctx):
    return step_spans.per_step_ms(ctx, "vstab.flow.raft.lookup_bwd")
