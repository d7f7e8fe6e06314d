"""Bytes and operations of each launch of the program's CUDA kernels,
from the arguments of its C entry point, and the least time it could take.

Each input byte is counted read once and each output byte written once.
Operations: the cost volume 2 (2r+1)^2 C per pixel, its backward the same
for each gradient asked for; the warps' arithmetic is far below their bytes
and is left out. The rate is the dtype's: bf16 at the tensor cores' peak,
float32 at the CUDA cores'.

Entry points and their leading arguments (pointers, then sizes):
  vstab_cost_volume      f1 f2 out n h w c r dtype stream
  vstab_cost_volume_bwd  g f1 f2 df1 df2 n h w c r dtype stream
  vstab_bilinear_warp    img flow out n h w c max_disp dt_img dt_flow stream
  vstab_bilinear_warp_bwd g img flow dimg dflow n h w c max_disp dt_img dt_flow stream
  vstab_vwarp / vstab_hwarp img field out n h w c max_disp mode stream
"""

from __future__ import annotations

from typing import Sequence, Tuple

from h100bench.counts import HBM_BYTES_PER_S, PEAK_FLOPS

# dtype codes of the entry points: 0 float32, 1 bfloat16
_SIZE = {0: 4, 1: 2}
_NAME = {0: "float32", 1: "bfloat16"}


def launch_cost(symbol: str, args: Sequence) -> Tuple[float, float, str]:
    """(bytes, operations, dtype name) of one launch."""
    if symbol == "vstab_cost_volume":
        n, h, w, c, r, dt = args[3:9]
        px, e, k = n * h * w, _SIZE[dt], (2 * r + 1) ** 2
        return px * (2 * c + k) * e, 2.0 * k * c * px, _NAME[dt]
    if symbol == "vstab_cost_volume_bwd":
        want = [args[3] is not None, args[4] is not None]
        n, h, w, c, r, dt = args[5:11]
        px, e, k = n * h * w, _SIZE[dt], (2 * r + 1) ** 2
        nbytes = px * (k + 2 * c * sum(want)) * e  # g, one map read a gradient
        return nbytes, 2.0 * k * c * px * sum(want), _NAME[dt]
    if symbol == "vstab_bilinear_warp":
        n, h, w, c, _, dti, dtf = args[3:10]
        px = n * h * w
        return px * (2 * c * _SIZE[dti] + 2 * _SIZE[dtf]), 0.0, _NAME[dti]
    if symbol == "vstab_bilinear_warp_bwd":
        dimg, dflow = args[3] is not None, args[4] is not None
        n, h, w, c, _, dti, dtf = args[5:12]
        px, ei, ef = n * h * w, _SIZE[dti], _SIZE[dtf]
        nbytes = px * (c * ei + 2 * ef)  # g and the flow
        if dflow:
            nbytes += px * (c * ei + 2 * ef)  # the image, and dflow written
        if dimg:
            nbytes += px * c * ei
        return nbytes, 0.0, _NAME[dti]
    if symbol in ("vstab_vwarp", "vstab_hwarp"):
        n, h, w, c = args[3:7]
        return n * h * w * (2 * c + 1) * 4, 0.0, "float32"
    raise KeyError(f"no count for the entry point {symbol!r}")


def bound_s(symbol: str, args: Sequence) -> float:
    """The least time of one launch on one H100: the larger of its bytes over
    the HBM rate and its operations over the dtype's peak."""
    nbytes, ops, dtype = launch_cost(symbol, args)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
