"""pinned_alloc_ms_per_frame.blocked: ms a frame the blocked pipeline's host spends allocating pinned memory (host_s.pinned_alloc)."""

from h100bench import program_readers


def read(ctx):
    return program_readers.blocked_host_ms_per_frame(ctx, ("pinned_alloc",))
