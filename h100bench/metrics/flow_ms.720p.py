"""flow_ms.720p: ms a clip of `clip_flow` (PWC-Net over the clip's pairs), host clock between synchronisations, over the traced clips."""

from h100bench import readers


def read(ctx):
    return readers.span_ms(ctx, "flow")
