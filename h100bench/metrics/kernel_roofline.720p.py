"""kernel_roofline.720p: % of the roofline reached by the program's CUDA kernels in the profiled section."""

from h100bench import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
