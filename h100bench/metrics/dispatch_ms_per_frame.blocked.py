"""dispatch_ms_per_frame.blocked: ms a frame the blocked pipeline's host spends uploading, launching and fetching its blocks (host_s.dispatch, self time)."""

from h100bench import program_readers


def read(ctx):
    return program_readers.blocked_host_ms_per_frame(ctx, ("dispatch",))
