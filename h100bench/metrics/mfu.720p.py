"""mfu.720p: % of the card's peak reached by the window's PWC-Net operations."""

from h100bench import readers


def read(ctx):
    return readers.mfu(ctx)
