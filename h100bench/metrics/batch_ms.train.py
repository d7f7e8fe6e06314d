"""batch_ms.train: ms of device time of the trainer's batch maker a step, CUDA events around it."""

from h100bench import readers


def read(ctx):
    return readers.span_ms(ctx, "batch")
