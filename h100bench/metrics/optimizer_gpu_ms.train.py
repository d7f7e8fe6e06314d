"""optimizer_gpu_ms.train: median over the profiled steps of the stream ms between the events of the span vstab.train.optimizer (optimizer and schedule step)."""

from h100bench import program_readers


def read(ctx):
    return program_readers.span_gpu_ms(ctx, "vstab.train.optimizer")
