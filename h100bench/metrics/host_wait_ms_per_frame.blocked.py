"""host_wait_ms_per_frame.blocked: ms a frame the blocked pipeline's host waits for a staging buffer's upload or a fetch (host_s.staging_wait + fetch_wait)."""

from h100bench import program_readers


def read(ctx):
    return program_readers.blocked_host_ms_per_frame(ctx, ("staging_wait", "fetch_wait"))
