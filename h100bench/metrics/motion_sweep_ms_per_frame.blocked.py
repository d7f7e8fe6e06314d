"""motion_sweep_ms_per_frame.blocked: ms a frame of the blocked pipeline's motion sweep and solve (its logged stage_s.flow)."""

from h100bench import readers


def read(ctx):
    return readers.blocked_stage_ms_per_frame(ctx, "flow")
