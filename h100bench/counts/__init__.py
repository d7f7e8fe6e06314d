"""The yardstick's arithmetic: the H100's published peaks, PWC-Net's
operations from its layer shapes, and each kernel launch's bytes and
operations from its launch shape."""

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# power limit of 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
