"""pinned_mb_per_frame.blocked: MB a frame of pinned host memory the blocked calls asked for (their pinned_bytes)."""

from h100bench import program_readers


def read(ctx):
    return program_readers.blocked_pinned_mb_per_frame(ctx)
