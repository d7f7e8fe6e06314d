"""out_wait_ms_per_frame.blocked: ms a frame the blocked pipeline's render drain waits for its slice of the output to be faulted in (host_s.out_wait); read only where every call's stats carry prefault_bytes."""

from h100bench import program_readers


def read(ctx):
    if program_readers._blocked_stats(ctx, "prefault_bytes") is None:
        return None
    return program_readers.blocked_host_ms_per_frame(ctx, ("out_wait",))
