"""render_ms.720p: ms a clip of `path_to_flow` and `render_stabilized`, host clock between synchronisations."""

from h100bench import readers


def read(ctx):
    return readers.span_ms(ctx, "render")
