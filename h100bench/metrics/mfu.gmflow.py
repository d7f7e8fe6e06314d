"""mfu.gmflow: % of the window spent at the card's peaks: each clip's GMFlow operations at the peak of their dtype (bf16 989, f32 67 TFLOP/s; `counts/gmflow.py`) over the window's seconds."""

from h100bench import readers


def read(ctx):
    return readers.mfu(ctx)
