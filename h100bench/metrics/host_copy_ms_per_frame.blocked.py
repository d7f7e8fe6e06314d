"""host_copy_ms_per_frame.blocked: ms a frame the blocked pipeline's host copies into a staging buffer or out of a fetch (host_s.stage_copy + drain_copy)."""

from h100bench import program_readers


def read(ctx):
    return program_readers.blocked_host_ms_per_frame(ctx, ("stage_copy", "drain_copy"))
