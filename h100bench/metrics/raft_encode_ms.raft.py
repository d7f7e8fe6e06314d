"""raft_encode_ms.raft: median over the profiled section's chunks of the stream ms between the events of the span vstab.flow.raft.encode."""

from h100bench import program_readers


def read(ctx):
    return program_readers.span_gpu_ms(ctx, "vstab.flow.raft.encode")
