"""mfu.raft_train: % of the card's float32 peak (67 TFLOP/s) reached by the window's RAFT training steps, each 3 x the forward's operations of 10 pairs (`counts/raft_train.py`), over the window's seconds."""

from h100bench import readers


def read(ctx):
    return readers.mfu(ctx)
