"""device_idle.720p: % of the profiled section in which the card ran nothing."""

from h100bench import readers


def read(ctx):
    return readers.device_idle(ctx)
