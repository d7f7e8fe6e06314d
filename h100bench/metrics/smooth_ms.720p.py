"""smooth_ms.720p: ms a clip of `smooth_paths` and `render_bucket` (the sparse-LS solve and the bucket's read-back), host clock between synchronisations."""

from h100bench import readers


def read(ctx):
    return readers.span_ms(ctx, "smooth")
