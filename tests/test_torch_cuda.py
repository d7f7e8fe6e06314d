"""vstab_torch's hand-written CUDA kernels held against their plain torch
versions on the card. Every test here needs a CUDA device and skips
without one; the file imports no JAX, so on a machine with a card and no
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: f32 outputs 1e-5 abs (same taps and weights, rounding apart);
bf16 outputs one bf16 ulp (both versions sum in f32 and round once).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from vstab_torch.kernels import (
    KERNELS,
    bilinear_warp,
    bilinear_warp_plain,
    cost_volume,
    cost_volume_plain,
    hwarp,
    hwarp_plain,
    reset_launches,
    vwarp,
    vwarp_plain,
    warp_twopass,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2**-7, atol=1e-5) if dtype == torch.bfloat16 else dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_cost_volume_matches_plain(cuda, dtype, radius):
    g = torch.Generator().manual_seed(radius)
    f1 = torch.randn((2, 33, 47, 21), generator=g).to(cuda, dtype)
    f2 = torch.randn((2, 33, 47, 21), generator=g).to(cuda, dtype)
    torch.testing.assert_close(
        cost_volume(f1, f2, radius).float(), cost_volume_plain(f1, f2, radius).float(), **_tol(dtype)
    )


# bf16 goes to the tensor-core kernel: channel counts that take the 16-byte
# (16), 8-byte (196) and 2-byte (21) staging copies and leave a channel tail;
# widths whose output runs start 16-byte aligned (320), never (47) and on
# some rows (20); N=1 keeps the tile count low, so the small tiles with dy
# split over warps run, and (2, 64, 320) reaches the large tiles.
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize(
    "shape", [(1, 9, 20, 196), (1, 33, 47, 21), (1, 12, 320, 16), (2, 64, 320, 16), (3, 41, 47, 196)]
)
def test_cost_volume_bf16_paths_match_plain(cuda, shape, radius):
    g = torch.Generator().manual_seed(radius)
    f1 = torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    f2 = torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    torch.testing.assert_close(
        cost_volume(f1, f2, radius).float(), cost_volume_plain(f1, f2, radius).float(),
        **_tol(torch.bfloat16),
    )


def test_cost_volume_bf16_takes_unaligned_views(cuda):
    """A contiguous view that starts 2 bytes into its storage: the kernel
    must pick the 2-byte staging copies from the addresses, not from C."""
    g = torch.Generator().manual_seed(7)
    flat = torch.randn((2, 1 + 2 * 17 * 24 * 16), generator=g).to(cuda, torch.bfloat16)
    f1 = flat[0, 1:].view(2, 17, 24, 16)
    f2 = flat[1, 1:].view(2, 17, 24, 16)
    assert f1.is_contiguous() and f1.data_ptr() % 4 == 2
    torch.testing.assert_close(
        cost_volume(f1, f2, 4).float(), cost_volume_plain(f1, f2, 4).float(), **_tol(torch.bfloat16)
    )


# f32 goes to cost_volume_f32_kernel, whose tile the launch picks from the
# image size: the trainer's five levels reach the 4x16 (48x64), 2x16
# (24x32), 1x8 (12x16) and 1x4 (6x8, 3x4) tiles, (1, 9, 20, 196) the 1x16
# tile and a channel tail in the last 128-channel stage, (2, 33, 47, 21) the
# 4x16 tile with odd C (4-byte staging copies, a channel tail) and ragged
# edges, (1, 3, 4, 196) an image smaller than the window, and
# (8, 48, 80, 96) the f32 serving level.
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize(
    "shape",
    [(8, 48, 64, 32), (8, 24, 32, 64), (8, 12, 16, 96), (8, 6, 8, 128), (8, 3, 4, 196),
     (1, 3, 4, 196), (2, 33, 47, 21), (1, 9, 20, 196), (8, 48, 80, 96)],
)
def test_cost_volume_f32_paths_match_plain(cuda, shape, radius):
    g = torch.Generator().manual_seed(radius)
    f1 = torch.randn(shape, generator=g).to(cuda)
    f2 = torch.randn(shape, generator=g).to(cuda)
    torch.testing.assert_close(
        cost_volume(f1, f2, radius), cost_volume_plain(f1, f2, radius), **_tol(torch.float32)
    )


@pytest.mark.parametrize("shape", [(2, 17, 24, 16), (4, 48, 64, 32)])
def test_cost_volume_f32_takes_unaligned_views(cuda, shape):
    """A contiguous view that starts 4 bytes into its storage: the kernel
    must pick the 4-byte staging copies from the addresses, not from C
    (at the 2x16 and at the 4x16 tile)."""
    g = torch.Generator().manual_seed(8)
    size = shape[0] * shape[1] * shape[2] * shape[3]
    flat = torch.randn((2, 1 + size), generator=g).to(cuda)
    f1 = flat[0, 1:].view(shape)
    f2 = flat[1, 1:].view(shape)
    assert f1.is_contiguous() and f1.data_ptr() % 16 == 4
    torch.testing.assert_close(cost_volume(f1, f2, 4), cost_volume_plain(f1, f2, 4), **_tol(torch.float32))


@pytest.mark.parametrize("shape", [(8, 48, 64, 32), (8, 24, 32, 64), (8, 6, 8, 128), (8, 3, 4, 196)])
def test_cost_volume_f32_does_not_depend_on_the_batch(cuda, shape):
    """An image's cost volume is the same to the bit whether it runs alone,
    with one other image or in a batch of 8: the kernel picks its tile, and
    with it the order of each pixel's sums, from the image size alone, so
    that two pipelines that cut the same frames into other chunks agree."""
    g = torch.Generator().manual_seed(9)
    f1 = torch.randn(shape, generator=g).to(cuda)
    f2 = torch.randn(shape, generator=g).to(cuda)
    whole = cost_volume(f1, f2, 4)
    for lo, hi in ((0, 1), (3, 5), (7, 8)):
        assert torch.equal(cost_volume(f1[lo:hi].contiguous(), f2[lo:hi].contiguous(), 4), whole[lo:hi])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
def test_bilinear_warp_matches_plain_with_clipped_flow(cuda, dtype, flow_dtype):
    g = torch.Generator().manual_seed(1)
    img = torch.randn((2, 33, 47, 5), generator=g).to(cuda, dtype)
    flow = (torch.rand((2, 33, 47, 2), generator=g) * 24 - 12).to(cuda, flow_dtype)
    torch.testing.assert_close(
        bilinear_warp(img, flow, 8).float(),
        bilinear_warp_plain(img, flow.clamp(-8, 8)).float(), **_tol(dtype),
    )


def _edge_flow(g, n, h, w):
    """Flow beyond the +-8 clip everywhere in +-12, and in each corner block
    pointing off both of that corner's edges."""
    flow = torch.rand((n, h, w, 2), generator=g) * 24 - 12
    k = 6
    flow[:, :k, :k] = -7.5
    flow[:, :k, -k:, 0], flow[:, :k, -k:, 1] = 7.5, -7.5
    flow[:, -k:, :k, 0], flow[:, -k:, :k, 1] = -7.5, 7.5
    flow[:, -k:, -k:] = 7.5
    return flow


# The vector kernel: bf16 with 4, 12 and 16 vectors a pixel (C = 32, 96, 128,
# compiled counts) and 3 (C = 24, the runtime count), f32 with 1 and 2 (C = 4,
# 8, the runtime count); the element kernel: C = 3 and C = 20 (bf16: not a
# multiple of 8). Widths whose rows fill a block's 128 positions many times
# over (320) and not once (20, 47 at C = 4).
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [20, 47, 320])
@pytest.mark.parametrize(
    "dtype,c",
    [(torch.bfloat16, 32), (torch.bfloat16, 96), (torch.bfloat16, 128), (torch.bfloat16, 24),
     (torch.float32, 4), (torch.float32, 8), (torch.float32, 3), (torch.bfloat16, 3),
     (torch.bfloat16, 20)],
)
def test_bilinear_warp_paths_match_plain(cuda, dtype, c, w, flow_dtype):
    g = torch.Generator().manual_seed(c + w)
    img = torch.randn((3, 19, w, c), generator=g).to(cuda, dtype)
    flow = _edge_flow(g, 3, 19, w).to(cuda, flow_dtype)
    torch.testing.assert_close(
        bilinear_warp(img, flow, 8).float(),
        bilinear_warp_plain(img, flow.clamp(-8, 8)).float(), **_tol(dtype),
    )


@pytest.mark.parametrize("dtype,c,skip", [(torch.bfloat16, 32, 1), (torch.bfloat16, 64, 4), (torch.float32, 8, 1)])
def test_bilinear_warp_takes_unaligned_views(cuda, dtype, c, skip):
    """A contiguous view that starts mid-storage, off any 16-byte boundary:
    the dispatch reads the addresses, so the element kernel serves it."""
    g = torch.Generator().manual_seed(11)
    flat = torch.randn((skip + 2 * 17 * 24 * c,), generator=g).to(cuda, dtype)
    img = flat[skip:].view(2, 17, 24, c)
    assert img.is_contiguous() and img.data_ptr() % 16 != 0
    flow = _edge_flow(g, 2, 17, 24).to(cuda, dtype)
    torch.testing.assert_close(
        bilinear_warp(img, flow, 8).float(),
        bilinear_warp_plain(img, flow.clamp(-8, 8)).float(), **_tol(dtype),
    )
    # an aligned image with a flow that starts between two (u, v) pairs
    flat_flow = torch.cat([flow.reshape(-1)[:1], flow.reshape(-1)])
    flow1 = flat_flow[1:].view(flow.shape)
    assert flow1.data_ptr() % (2 * flow1.element_size()) != 0
    img0 = img.clone()
    torch.testing.assert_close(
        bilinear_warp(img0, flow1, 8).float(),
        bilinear_warp_plain(img0, flow1.clamp(-8, 8)).float(), **_tol(dtype),
    )


def test_bilinear_warp_main_path_shape_matches_plain(cuda):
    """The largest shape the flow network gives the kernel at 720p."""
    g = torch.Generator(device="cuda").manual_seed(12)
    img = torch.randn((8, 192, 320, 32), generator=g, device=cuda).bfloat16()
    flow = (torch.rand((8, 192, 320, 2), generator=g, device=cuda) * 24 - 12).bfloat16()
    torch.testing.assert_close(
        bilinear_warp(img, flow, 8).float(),
        bilinear_warp_plain(img, flow.clamp(-8, 8)).float(), **_tol(torch.bfloat16),
    )


@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("c,max_disp", [(3, 16), (1, 63), (3, 127)])
def test_1d_warps_match_plain(cuda, mode, c, max_disp):
    g = torch.Generator().manual_seed(2)
    img = torch.rand((2, 37, 53, c), generator=g).to(cuda)
    field = (torch.rand((2, 37, 53), generator=g) * 2.4 - 1.2).mul(max_disp).to(cuda)
    torch.testing.assert_close(vwarp(img, field, max_disp, mode), vwarp_plain(img, field, max_disp, mode), rtol=0, atol=1e-5)
    torch.testing.assert_close(hwarp(img, field, max_disp, mode), hwarp_plain(img, field, max_disp, mode), rtol=0, atol=1e-5)


# hwarp's row kernel: rows that start 16-byte aligned (1536x3) and rows that
# do not (53x3, 53x1, 1314x1), one and three channels, and wrap with
# max_disp >= W (taps wrap more than once).
@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("max_disp", [16, 127])
@pytest.mark.parametrize("w,c", [(53, 3), (53, 1), (1536, 3), (1314, 1)])
def test_hwarp_rows_match_plain(cuda, w, c, max_disp, mode):
    g = torch.Generator().manual_seed(w + c)
    img = torch.rand((2, 5, w, c), generator=g).to(cuda)
    field = (torch.rand((2, 5, w), generator=g) * 2.4 - 1.2).mul(max_disp).to(cuda)
    torch.testing.assert_close(
        hwarp(img, field, max_disp, mode), hwarp_plain(img, field, max_disp, mode), rtol=0, atol=1e-5
    )


def _field(g, kind, n, h, w, max_disp):
    """A per-pixel random field in +-1.2 max_disp, or a smooth one: a 3x4 grid
    of such values a frame, upsampled to the frame."""
    if kind == "random":
        return (torch.rand((n, h, w), generator=g) * 2.4 - 1.2).mul(max_disp)
    coarse = (torch.rand((n, 1, 3, 4), generator=g) * 2.4 - 1.2).mul(max_disp)
    return torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bilinear", align_corners=False
    )[:, 0].contiguous()


# vwarp's row kernel: one, three and any other number of channels, rows
# shorter than a block's piece (53) and longer (1314, 1536), both fields, and
# in wrap mode both index fixes (max_disp 16 < H = 23 <= 127).
@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("max_disp", [16, 127])
@pytest.mark.parametrize("w", [53, 1314, 1536])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_vwarp_rows_match_plain(cuda, c, w, max_disp, mode, kind):
    g = torch.Generator().manual_seed(w + c)
    img = torch.rand((2, 23, w, c), generator=g).to(cuda)
    field = _field(g, kind, 2, 23, w, max_disp).to(cuda)
    torch.testing.assert_close(
        vwarp(img, field, max_disp, mode), vwarp_plain(img, field, max_disp, mode), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("mode", ["edge", "wrap"])
def test_vwarp_main_path_height_with_the_cheap_wrap(cuda, mode):
    """H = 720 > max_disp = 127: taps leave the frame at both ends and come
    back with one add or subtract."""
    g = torch.Generator().manual_seed(6)
    img = torch.rand((2, 720, 40, 3), generator=g).to(cuda)
    field = _field(g, "smooth", 2, 720, 40, 127).to(cuda)
    torch.testing.assert_close(
        vwarp(img, field, 127, mode), vwarp_plain(img, field, 127, mode), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("c", [1, 2, 3])
def test_vwarp_takes_unaligned_views(cuda, c):
    g = torch.Generator().manual_seed(c)
    flat = torch.rand((3 + 4 * 7 * 40 * c,), generator=g).to(cuda)
    img = flat[3:].view(4, 7, 40, c)  # starts 12 bytes into its storage
    field = (torch.rand((1 + 4 * 7 * 40,), generator=g) * 30 - 15).to(cuda)[1:].view(4, 7, 40)
    for mode in ("edge", "wrap"):
        torch.testing.assert_close(
            vwarp(img, field, 16, mode), vwarp_plain(img, field, 16, mode), rtol=0, atol=1e-5
        )


@pytest.mark.parametrize("mode", ["edge", "wrap"])
def test_vwarp_frames_taller_than_the_grid(cuda, mode):
    """H beyond the 65535 rows a launch grid holds: the per-element kernel."""
    g = torch.Generator().manual_seed(8)
    img = torch.rand((1, 65600, 6, 3), generator=g).to(cuda)
    field = (torch.rand((1, 65600, 6), generator=g) * 300 - 150).to(cuda)
    torch.testing.assert_close(
        vwarp(img, field, 127, mode), vwarp_plain(img, field, 127, mode), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("c", [1, 2, 3])
def test_hwarp_takes_unaligned_views_and_other_channel_counts(cuda, c):
    g = torch.Generator().manual_seed(c)
    flat = torch.rand((3 + 4 * 7 * 40 * c,), generator=g).to(cuda)
    img = flat[3:].view(4, 7, 40, c)  # starts 12 bytes into its storage
    field = (torch.rand((4, 7, 40), generator=g) * 30 - 15).to(cuda)
    torch.testing.assert_close(hwarp(img, field, 16), hwarp_plain(img, field, 16), rtol=0, atol=1e-5)


def test_hwarp_rows_too_long_for_shared_memory(cuda):
    g = torch.Generator().manual_seed(5)
    img = torch.rand((1, 2, 30000, 3), generator=g).to(cuda)  # 2 x 360 KB a row
    field = (torch.rand((1, 2, 30000), generator=g) * 30 - 15).to(cuda)
    for mode in ("edge", "wrap"):
        torch.testing.assert_close(
            hwarp(img, field, 16, mode), hwarp_plain(img, field, 16, mode), rtol=0, atol=1e-5
        )


# The long-clip and 4K sizes. The reference's contract cases of the 1-D
# warps at the wide buckets (tests/kernels/test_wide.py): one 96-row frame,
# a rotation-and-zoom-like field over most of [-d, d].
@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("d,w", [(127, 1920), (255, 1920), (255, 3840)])
def test_1d_warps_match_plain_at_the_contract_widths(cuda, d, w, mode):
    g = torch.Generator().manual_seed(30)
    img = torch.rand((1, 96, w, 3), generator=g).to(cuda)
    yy, xx = torch.arange(96.0).view(96, 1), torch.arange(float(w)).view(1, w)
    field = (0.9 * d * (2.0 * xx / w - 1.0) + 0.05 * d * torch.sin(yy / 17.0))[None].contiguous().to(cuda)
    for kern, plain in ((vwarp, vwarp_plain), (hwarp, hwarp_plain)):
        torch.testing.assert_close(kern(img, field, d, mode), plain(img, field, d, mode), rtol=0, atol=1e-5)


# The 4K render's frame at the bucket 255: 3840 + 2 * 256 = 4352 columns, a
# staged row of 3 channels 104,480 B of shared memory (hwarp's row kernel).
@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("c", [1, 3])
def test_1d_warps_match_plain_at_the_4k_render_width(cuda, c, mode, kind):
    g = torch.Generator().manual_seed(c)
    img = torch.rand((2, 8, 4352, c), generator=g).to(cuda)
    field = _field(g, kind, 2, 8, 4352, 255).to(cuda)
    for kern, plain in ((vwarp, vwarp_plain), (hwarp, hwarp_plain)):
        torch.testing.assert_close(kern(img, field, 255, mode), plain(img, field, 255, mode), rtol=0, atol=1e-5)


def test_hwarp_takes_the_row_kernel_at_the_4k_render_width(cuda):
    """One kernel node in a CUDA-graph capture of a call at 4352x3: one
    block of 256 threads a row, with the input and output rows' shared
    memory; `hwarp_row_kernel` by name where libcuda gives names."""
    from vstab_torch.kernels._build import graph_nodes

    g = torch.Generator().manual_seed(9)
    img = torch.rand((2, 8, 4352, 3), generator=g).to(cuda)
    field = (torch.rand((2, 8, 4352), generator=g) * 510 - 255).to(cuda)
    nodes = graph_nodes(lambda: hwarp(img, field, 255))
    pitch = (4352 * 3 + 3) // 4 * 4 + 4
    assert len(nodes) == 1
    assert {k: nodes[0][k] for k in ("type", "grid", "block", "shared_bytes")} == {
        "type": 0, "grid": (16, 1, 1), "block": (256, 1, 1), "shared_bytes": 2 * pitch * 4}
    assert nodes[0]["name"] is None or "hwarp_row_kernel" in nodes[0]["name"]


def test_cost_volume_at_the_4k_finest_level_matches_plain(cuda):
    """8 pairs at the finest level of a 4K frame (2160 rows padded to 2176):
    8x544x960x32 bf16, an output of 338 million values."""
    g = torch.Generator(device="cuda").manual_seed(13)
    f1 = torch.randn((8, 544, 960, 32), generator=g, device=cuda).bfloat16()
    f2 = torch.randn((8, 544, 960, 32), generator=g, device=cuda).bfloat16()
    torch.testing.assert_close(
        cost_volume(f1, f2, 4).float(), cost_volume_plain(f1, f2, 4).float(), **_tol(torch.bfloat16)
    )


def test_bilinear_warp_at_the_4k_finest_level_matches_plain(cuda):
    g = torch.Generator(device="cuda").manual_seed(14)
    img = torch.randn((8, 544, 960, 32), generator=g, device=cuda).bfloat16()
    flow = (torch.rand((8, 544, 960, 2), generator=g, device=cuda) * 24 - 12).bfloat16()
    torch.testing.assert_close(
        bilinear_warp(img, flow, 8).float(),
        bilinear_warp_plain(img, flow.clamp(-8, 8)).float(), **_tol(torch.bfloat16),
    )


def test_warp_twopass_on_card_matches_cpu(cuda):
    g = torch.Generator().manual_seed(3)
    frames = torch.rand((3, 40, 56, 3), generator=g)
    yy, xx = torch.meshgrid(torch.arange(40.0), torch.arange(56.0), indexing="ij")
    flow = torch.stack([3.0 + 0.05 * yy, -2.0 + 0.04 * xx], dim=-1).expand(3, 40, 56, 2).contiguous()
    want = warp_twopass(frames, flow, 16)
    reset_launches()
    got = warp_twopass(frames.to(cuda), flow.to(cuda), 16)
    assert KERNELS["vwarp"].launches == 1 and KERNELS["hwarp"].launches == 3
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


# The render's crop zoom: a vertical then a horizontal two-tap pass on the
# 1-D kernels, held at the configurations' 0.9 crop against the dense tent
# product it replaced (full f32, TF32 off) at the whole clip's shapes of 720p
# and 4K. Bound: one step of the f32 source coordinate at 3840 columns, the
# 4K tests' 1e-4 + 2^-12. The validity mask of a shaken 720p clip keeps its
# `> 0.999` decision on all but 0.1 per mille of its pixels.
@pytest.mark.parametrize("shape", [(48, 720, 1280, 3), (48, 720, 1280, 1), (2, 2160, 3840, 3)])
def test_zoom_resample_on_the_card_matches_the_tent_product(cuda, shape):
    from torch_zoom_tent import tent_zoom

    from vstab_torch.render.render import zoom_resample

    g = torch.Generator(device="cuda").manual_seed(24)
    img = torch.rand(shape, generator=g, device=cuda)
    s = torch.tensor(0.9, device=cuda)
    reset_launches()
    got = zoom_resample(img, s)
    assert KERNELS["vwarp"].launches == 1 and KERNELS["hwarp"].launches == 1
    torch.testing.assert_close(got, tent_zoom(img, s), rtol=0, atol=1e-4 + 2.0**-12)


def test_zoomed_mask_on_the_card_keeps_the_tent_products_validity(cuda):
    from torch_zoom_tent import tent_zoom

    from vstab_torch.kernels import twopass_validity
    from vstab_torch.render.render import affine_to_flow, zoom_resample

    t, h, w = 48, 720, 1280
    g = torch.Generator(device="cuda").manual_seed(24)
    ang = (torch.rand(t, generator=g, device=cuda) - 0.5) * 0.02
    cos, sin = torch.cos(ang), torch.sin(ang)
    shift = (torch.rand((t, 2), generator=g, device=cuda) - 0.5) * 160.0
    transforms = torch.stack(
        [torch.stack([cos, -sin, shift[:, 0]], -1), torch.stack([sin, cos, shift[:, 1]], -1)], 1
    )
    mask = twopass_validity((h, w), affine_to_flow(transforms, h, w), 63)[..., None]
    s = torch.tensor(0.9, device=cuda)
    got = zoom_resample(mask, s) > 0.999
    want = tent_zoom(mask, s) > 0.999
    differ = int((got != want).sum())
    print(f"zoomed 48x720x1280 mask: {differ} of {want.numel()} decisions differ from the tent product's "
          f"({int((~want).sum())} pixels invalid)")
    assert 0 < int((~want).sum()) and differ <= 1e-4 * want.numel()


# A render call launches vwarp once and hwarp three times (`warp_twopass` at
# d=16), and the crop zoom two more of each on the frame and the mask.
@pytest.mark.parametrize("crop_mode", ["fixed", "auto", "none"])
def test_render_launches_the_zoom_passes(cuda, crop_mode):
    from vstab_torch.core.config import RenderConfig
    from vstab_torch.render.render import render_stabilized
    from vstab_torch.utils import trace

    frames = torch.rand((3, 40, 56, 3), device=cuda)
    flow = torch.full((3, 40, 56, 2), 1.5, device=cuda)
    zoom = 0 if crop_mode == "none" else 2
    reset_launches()
    trace.clear()
    with trace.recording():
        render_stabilized(frames, flow, RenderConfig(crop_mode=crop_mode), max_disp=16)
    (rec,) = [r for r in trace.records() if r["name"] == "vstab.render"]
    trace.clear()
    assert (KERNELS["vwarp"].launches, KERNELS["hwarp"].launches) == (1 + zoom, 3 + zoom)
    assert rec["attrs"]["zoom_passes"] == 2 * zoom


def test_kernels_refuse_what_they_cannot_take(cuda):
    x = torch.zeros((1, 8, 8, 4), device=cuda)
    with pytest.raises(ValueError):
        cost_volume(x.transpose(1, 2), x, 2)  # not contiguous
    with pytest.raises(ValueError):
        cost_volume(x, x, 5)  # radius beyond the kernel's
    with pytest.raises(TypeError):
        vwarp(x.double(), x[..., 0].double())
    with pytest.raises(ValueError):
        hwarp(x, x[..., 0].cpu())
    with pytest.raises(ValueError):
        vwarp(x, x[..., 0], mode="reflect")


# The blocked pipeline's pinned staging buffers, asynchronous uploads and
# second-stream fetches exist only on the card. Blocked against whole clip,
# both on the card, tiny random network in f32: 2e-3 on every value, as on
# the CPU.
@pytest.mark.parametrize("method", ["sparse_ls", "affine"])
@pytest.mark.parametrize("as_uint8", [False, True])
def test_blocked_matches_whole_clip_on_the_card(cuda, method, as_uint8):
    import numpy as np

    import vstab_torch
    from vstab_torch.core import config as tcfg
    from vstab_torch.eval.synthetic import make_shaky_clip

    cfg = tcfg.Config(
        flow=tcfg.FlowConfig(
            pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
            compute_dtype="float32", output_level=1,
        ),
        smooth=tcfg.SmoothConfig(method=method),
        render=tcfg.RenderConfig(crop_mode="auto"),
    )
    params = vstab_torch.default_params(cfg, seed=0, ckpt_dir="/nonexistent")
    frames, _ = make_shaky_clip(t=21, h=48, w=64, seed=5)
    u8 = (np.clip(frames, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    f32 = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    want, _ = vstab_torch.stabilize(f32, params, cfg)
    reset_launches()
    got = vstab_torch.stabilize_blocked(u8 if as_uint8 else f32, params, cfg, block_len=8)
    assert all(k.launches > 0 for k in KERNELS.values())
    assert got.dtype == np.float32 and got.shape == f32.shape
    torch.testing.assert_close(torch.from_numpy(got), want.cpu(), rtol=0, atol=2e-3)


# The time-sharded pipeline on the card, through the port's backend
# (`BACKEND`: NCCL for CUDA tensors): the halo, the all_gathers and the
# all-reduces on CUDA tensors. 64 frames are a multiple of n_time *
# block_len for 1, 2 and 4 ranks, so nothing is padded and the output is
# `stabilize`'s: 2e-3 on every value, as on the CPU.
#
# Both paths flow the same 8 chunks of 8 pairs (`clip_flow` pads
# `stabilize`'s 63 pairs with a repeat of the last frame, `extend_right` does
# the same on the last rank). With cuDNN's default algorithms the f32
# convolutions are not deterministic: the same chunk flowed twice differs in
# the last bits of a third of its values or more, the affine fit's Huber
# weights and median carry that further, and the 'auto' crop's
# validity threshold (`maskz > 0.999`) can then flip a border pixel between
# image and border colour (0.6 at one pixel in some runs). Both paths
# therefore run with `cudnn.deterministic`, and
# `test_flow_of_a_chunk_does_not_depend_on_its_batch` holds the flows they
# compare.
SHARDED_METHODS = ("sparse_ls", "affine")


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for one test, the flag restored
    after it."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = was


def _sharded_case(method):
    """(config, params, clip) of the card's sharded-pipeline tests."""
    import vstab_torch
    from vstab_torch.core import config as tcfg
    from vstab_torch.eval.synthetic import make_shaky_clip

    cfg = tcfg.Config(
        flow=tcfg.FlowConfig(
            pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
            compute_dtype="float32", output_level=1,
        ),
        smooth=tcfg.SmoothConfig(method=method, grid_size=(4, 4), block_len=8),
        render=tcfg.RenderConfig(crop_mode="auto"),
    )
    params = vstab_torch.default_params(cfg, seed=0, ckpt_dir="/nonexistent")
    return cfg, params, make_shaky_clip(t=64, h=48, w=64, seed=5)[0]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_flow_of_a_chunk_does_not_depend_on_its_batch(cuda):
    """The sharded test's clip: its last real pairs (56..62) flowed as a
    chunk of 7 and inside a chunk of 8 (the last frame repeated, as both
    pipelines pad), each twice. Under `cudnn.deterministic` the four flows
    are equal to the bit. Under cuDNN's default algorithms the chunk of 8
    against itself differs as much as the chunk of 7 against the chunk of 8:
    both within 1e-6 px, the last bits of f32 sums of some hundreds of terms
    on values of a few px; the cause is the algorithms, not the batch."""
    from vstab_torch.core.precision import pin_full_f32
    from vstab_torch.flow.pwcnet import estimate_flow_pairs

    cfg, params, frames = _sharded_case("affine")
    params = {k: v.to(cuda) for k, v in params.items()}
    frames = torch.as_tensor(frames, dtype=torch.float32, device=cuda)
    eight = torch.cat([frames[56:], frames[-1:]])
    assert frames.shape[0] == 64 and eight.shape[0] == 9
    was = torch.backends.cudnn.deterministic
    try:
        for deterministic in (True, False):
            torch.backends.cudnn.deterministic = deterministic
            with torch.inference_mode():
                pin_full_f32()
                flows7 = [estimate_flow_pairs(params, frames[56:], cfg.flow) for _ in range(2)]
                flows8 = [estimate_flow_pairs(params, eight, cfg.flow)[:7] for _ in range(2)]
            pairs = [(flows7[0], flows7[1]), (flows8[0], flows8[1]), (flows7[0], flows8[0])]
            print(json.dumps({"deterministic": deterministic, "7 vs 7, 8 vs 8, 7 vs 8": [
                {"max_abs": float((a - b).abs().max()), "values_apart": int((a != b).sum())} for a, b in pairs]}))
            for a, b in pairs:
                assert a.shape == (7, 48, 64, 2)
                if deterministic:
                    assert torch.equal(a, b)
                else:
                    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    finally:
        torch.backends.cudnn.deterministic = was


@pytest.mark.parametrize("method", SHARDED_METHODS)
def test_stabilize_sharded_one_nccl_rank_matches_stabilize(cuda, deterministic_cudnn, method):
    import torch.distributed as dist

    import vstab_torch
    from vstab_torch.dist import make_mesh, stabilize_sharded
    from vstab_torch.dist.init import BACKEND

    cfg, params, frames = _sharded_case(method)
    want, _ = vstab_torch.stabilize(frames, params, cfg)
    dist.init_process_group(BACKEND, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        reset_launches()
        got, diags = stabilize_sharded(frames, params, cfg, mesh=make_mesh())
        assert all(k.launches > 0 for k in KERNELS.values())
    finally:
        dist.destroy_process_group()
    assert got.is_cuda and diags["start"] == 0 and diags["t_pad"] == 64
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


def _sharded_rank(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of the several-card test: brought up by `initialize` on card
    `rank`, it runs both methods with gather=True and saves what it got."""
    import numpy as np

    from vstab_torch.core.config import DistConfig
    from vstab_torch.dist import initialize, make_mesh, shutdown, stabilize_sharded

    torch.backends.cudnn.deterministic = True  # as for `stabilize` in the test: see above
    initialize(DistConfig(coordinator_address=f"127.0.0.1:{port}", num_processes=world, process_id=rank))
    try:
        mesh = make_mesh(DistConfig(time_axis=world))
        out = {}
        for method in SHARDED_METHODS:
            cfg, params, frames = _sharded_case(method)
            reset_launches()
            got, diags = stabilize_sharded(frames, params, cfg, mesh=mesh, gather=True)
            out[method] = got.cpu().numpy()
            out[f"{method}/launched"] = np.array([k.launches > 0 for k in KERNELS.values()])
            out[f"{method}/card"] = np.array([got.device.index, diags["n_time"], diags["t_loc"]])
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        shutdown()


# Several cards: one process a card, brought up by `initialize` with the
# port's backend, so the halo's point-to-point exchange and the Schur
# solve's messages run over NCCL between cards.
def test_stabilize_sharded_on_several_cards_matches_stabilize(cuda, deterministic_cudnn, tmp_path):
    import numpy as np

    import vstab_torch
    from vstab_torch.kernels._build import build_all

    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two CUDA devices or more: NCCL takes one rank a card")
    build_all()  # once, before the ranks load the kernels
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), port, str(tmp_path)],
                         env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert not any(p.returncode for p in procs), "\n".join(f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for method in SHARDED_METHODS:
        cfg, params, frames = _sharded_case(method)
        want = vstab_torch.stabilize(frames, params, cfg)[0].cpu().numpy()
        got = ranks[0][method]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        for r, arrays in enumerate(ranks):
            np.testing.assert_array_equal(arrays[method], got)
            assert arrays[f"{method}/launched"].all()
            assert arrays[f"{method}/card"].tolist() == [r, world, 64 // world]


def test_roll_and_wrap_pad_on_the_card(cuda):
    from vstab_torch.kernels.warp1d import _roll_and_wrap_pad

    g = torch.Generator().manual_seed(3)
    frames = torch.randn((5, 12, 17, 3), generator=g)
    mu = torch.tensor([-20.0, 3.0, 0.0, 16.0, 40.0])
    mv = torch.tensor([5.0, -13.0, 0.0, 11.0, -30.0])
    want = _roll_and_wrap_pad(frames, mu, mv, 4)
    got = _roll_and_wrap_pad(frames.to(cuda), mu.to(cuda), mv.to(cuda), 4)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# Backward kernels (the gradients of the cost volume and of the feature warp)
# against the plain backward versions and against autograd of the plain
# forward, on the card. Tolerances are relative to the largest value of the
# gradient compared: f32 1e-5 (other summation order; the image gradient is a
# sum of atomic adds whose order varies), bf16 one bf16 ulp (2^-7: both sum
# in f32 and round once). `torch.autograd.gradcheck` needs f64, which the
# kernels do not take.
# ---------------------------------------------------------------------------


def _assert_grad_close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.float().abs().max())
    tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * max(scale, 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"max error {err:.3e} over {tol:.3e} (largest value {scale:.3e})"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 9, 11, 3), (2, 13, 20, 21), (1, 6, 8, 196), (2, 12, 16, 32), (1, 3, 4, 196)])
def test_cost_volume_backward_matches_plain(cuda, shape, radius, dtype):
    from vstab_torch.kernels import KERNELS_BWD, cost_volume_backward_plain

    g = torch.Generator().manual_seed(radius + shape[3])
    f1 = torch.randn(shape, generator=g).to(cuda, dtype).requires_grad_()
    f2 = torch.randn(shape, generator=g).to(cuda, dtype).requires_grad_()
    # asymmetric in the window: a transposed shift in df2 would show
    ramp = torch.linspace(0.2, 1.8, (2 * radius + 1) ** 2)
    gout = (torch.randn(shape[:3] + ((2 * radius + 1) ** 2,), generator=g) * ramp).to(cuda, dtype)
    reset_launches()
    out = cost_volume(f1, f2, radius)
    assert out.requires_grad and KERNELS["cost_volume"].launches == 1
    df1, df2 = torch.autograd.grad(out, (f1, f2), gout)
    assert KERNELS_BWD["cost_volume_bwd"].launches == 1
    p1, p2 = cost_volume_backward_plain(gout, f1.detach(), f2.detach(), radius)
    _assert_grad_close(df1, p1, dtype)
    _assert_grad_close(df2, p2, dtype)
    a1, a2 = torch.autograd.grad(cost_volume_plain(f1, f2, radius), (f1, f2), gout)
    _assert_grad_close(df1, a1, dtype)
    _assert_grad_close(df2, a2, dtype)


# Aligned f32 and bf16 with C % 4 == 0 go to the tiled cost_volume_bwd_kernel,
# whose tile the launch picks from the image size: the trainer's five levels
# reach the 4x16 (48x64), 2x16 (24x32), 1x8 (12x16) and 1x4 (6x8, 3x4) tiles
# at r=4, (1, 33, 47, 36) ragged tile edges and a chunk of one channel vector
# after a whole one.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [1, 3, 4])
@pytest.mark.parametrize(
    "shape", [(2, 48, 64, 32), (2, 24, 32, 64), (2, 12, 16, 96), (2, 6, 8, 128), (2, 3, 4, 196), (1, 33, 47, 36)]
)
def test_cost_volume_backward_tiles_match_plain(cuda, shape, radius, dtype):
    from vstab_torch.kernels import KERNELS_BWD, cost_volume_backward, cost_volume_backward_plain

    g = torch.Generator().manual_seed(radius + shape[1])
    nd = (2 * radius + 1) ** 2
    f1 = torch.randn(shape, generator=g).to(cuda, dtype)
    f2 = torch.randn(shape, generator=g).to(cuda, dtype)
    gout = (torch.randn(shape[:3] + (nd,), generator=g) * torch.linspace(0.2, 1.8, nd)).to(cuda, dtype)
    reset_launches()
    df1, df2 = cost_volume_backward(gout, f1, f2, radius)
    assert KERNELS_BWD["cost_volume_bwd"].launches == 1
    p1, p2 = cost_volume_backward_plain(gout, f1, f2, radius)
    _assert_grad_close(df1, p1, dtype)
    _assert_grad_close(df2, p2, dtype)
    # one gradient alone: the same blocks, the same bits
    assert torch.equal(cost_volume_backward(gout, f1, f2, radius, need=(True, False))[0], df1)
    assert torch.equal(cost_volume_backward(gout, f1, f2, radius, need=(False, True))[1], df2)


@pytest.mark.parametrize(
    "shape", [(8, 48, 64, 32), (8, 24, 32, 64), (8, 12, 16, 96), (8, 6, 8, 128), (8, 3, 4, 196)]
)
def test_cost_volume_backward_does_not_depend_on_the_batch(cuda, shape):
    """An image's df1 and df2 are the same to the bit alone, with one other
    image or in a batch of 8, at the trainer's five levels: the kernel picks
    its tile, and with it the order of each pixel's sums, from the image size
    alone, so that half-batches agree with the whole batch."""
    from vstab_torch.kernels import cost_volume_backward

    g = torch.Generator().manual_seed(10)
    f1 = torch.randn(shape, generator=g).to(cuda)
    f2 = torch.randn(shape, generator=g).to(cuda)
    gout = torch.randn(shape[:3] + (81,), generator=g).to(cuda)
    whole = cost_volume_backward(gout, f1, f2, 4)
    for lo, hi in ((0, 1), (3, 5), (7, 8)):
        part = cost_volume_backward(gout[lo:hi].contiguous(), f1[lo:hi].contiguous(), f2[lo:hi].contiguous(), 4)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[lo:hi])


# Views that start 4 bytes into their storage (data_ptr % 16 == 4: f32 and
# bf16 take the element kernel) and, for bf16, 8 bytes (the tiled kernel with
# 8-byte copies from a base that is not 16-byte aligned).
@pytest.mark.parametrize(
    "dtype, offset", [(torch.float32, 1), (torch.bfloat16, 2), (torch.bfloat16, 4)]
)
@pytest.mark.parametrize("shape", [(2, 17, 24, 16), (4, 48, 64, 32)])
def test_cost_volume_backward_takes_unaligned_views(cuda, shape, dtype, offset):
    from vstab_torch.kernels import cost_volume_backward, cost_volume_backward_plain

    g = torch.Generator().manual_seed(11)
    size = shape[0] * shape[1] * shape[2] * shape[3]
    flat = torch.randn((2, offset + size), generator=g).to(cuda, dtype)
    f1 = flat[0, offset:].view(shape)
    f2 = flat[1, offset:].view(shape)
    assert f1.is_contiguous() and f1.data_ptr() % 16 == offset * f1.element_size()
    gout = torch.randn(shape[:3] + (81,), generator=g).to(cuda, dtype)
    df1, df2 = cost_volume_backward(gout, f1, f2, 4)
    p1, p2 = cost_volume_backward_plain(gout, f1, f2, 4)
    _assert_grad_close(df1, p1, dtype)
    _assert_grad_close(df2, p2, dtype)


def test_cost_volume_backward_one_input_and_strided_gradient(cuda):
    from vstab_torch.kernels import KERNELS_BWD, cost_volume_backward_plain

    g = torch.Generator().manual_seed(3)
    f1 = torch.randn((2, 10, 12, 16), generator=g).to(cuda)
    f2 = torch.randn((2, 10, 12, 16), generator=g).to(cuda).requires_grad_()
    gout = torch.randn((2, 10, 12, 81 + 7), generator=g).to(cuda)[..., 3:84]  # strided
    assert not gout.is_contiguous()
    reset_launches()
    (df2,) = torch.autograd.grad(cost_volume(f1, f2, 4), (f2,), gout)
    assert KERNELS_BWD["cost_volume_bwd"].launches == 1
    _assert_grad_close(df2, cost_volume_backward_plain(gout, f1, f2.detach(), 4)[1], torch.float32)
    f1.requires_grad_()
    (df1,) = torch.autograd.grad(cost_volume(f1, f2.detach(), 4), (f1,), gout)
    _assert_grad_close(df1, cost_volume_backward_plain(gout, f1.detach(), f2.detach(), 4)[0], torch.float32)
    with torch.no_grad():  # no graph, the bare forward launch
        assert not cost_volume(f1, f2, 4).requires_grad
    # the backward wrapper called directly: the same kernel, the same bits
    from vstab_torch.kernels import cost_volume_backward

    only1, none2 = cost_volume_backward(gout.contiguous(), f1.detach(), f2.detach(), 4, need=(True, False))
    assert none2 is None and torch.equal(only1, df1)
    with pytest.raises(ValueError):
        cost_volume_backward(gout, f1.detach(), f2.detach(), 4)  # strided g: the Function makes it contiguous
    with pytest.raises(ValueError):
        cost_volume_backward(gout.contiguous(), f1.detach(), f2.detach(), 3)  # g is not a radius-3 volume


# Flow inside +-max_disp so that the kernel's clip is not in play (the plain
# version has none), pointing off every edge in the corners; all four dtype
# pairs; channel counts on and off the vector length (4 f32, 8 bf16: 3, 21,
# bf16 4 and bf16 196 are off it); windows of max_disp 1, 4, 8 and 15 (the
# largest the gather takes); an image that starts 4 bytes into its storage;
# dimg under UNBOUNDED (flow in +-12); and max_disp 15 on a tall image 8
# pixels wide, where one vector a pixel (f32 C = 4, bf16 C = 8) would want a
# tile of 4 rounds larger than a block's shared memory: it takes the largest
# that fits. The gather serves all but the unaligned image and UNBOUNDED
# where C allows; the scatter those two.
_WARP_BWD_CASES = [
    (1, 0, (19, 24)), (4, 0, (19, 24)), (8, 0, (19, 24)), (8, 4, (19, 24)), ("unbounded", 0, (19, 24)),
    (15, 0, (19, 24)), (15, 0, (8192, 8)),
]


@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 4, 8, 21, 32, 64, 96, 128, 196])
@pytest.mark.parametrize("max_disp,offset,hw", _WARP_BWD_CASES)
def test_bilinear_warp_backward_matches_plain(cuda, c, dtype, flow_dtype, max_disp, offset, hw):
    from vstab_torch.kernels import KERNELS_BWD, bilinear_warp_backward, bilinear_warp_backward_plain
    from vstab_torch.kernels import warp as W

    g = torch.Generator().manual_seed(c)
    n, (h, w) = 2, hw
    if max_disp == "unbounded":
        max_disp, flow = W.UNBOUNDED, _edge_flow(g, n, h, w)
    else:
        amp = 0.99 * max_disp
        flow = (_edge_flow(g, n, h, w) * (amp / 12)).clamp(-amp, amp)
    flow = flow.to(cuda, flow_dtype).requires_grad_()
    size = n * h * w * c
    skip = offset // torch.tensor([], dtype=dtype).element_size()
    img = torch.empty(skip + size, dtype=dtype, device=cuda)[skip:].view(n, h, w, c)
    img.copy_(torch.randn((n, h, w, c), generator=g)).requires_grad_()
    assert img.data_ptr() % 16 == offset
    gout = torch.randn((n, h, w, c), generator=g).to(cuda, dtype)
    vector = c % (4 if dtype == torch.float32 else 8) == 0
    want_route = W.ROUTE_GATHER if vector and max_disp <= 15 and offset == 0 else W.ROUTE_SCATTER
    assert W.backward_route(gout, img.detach(), flow.detach(), max_disp, (True, True)) == want_route
    reset_launches()
    out = bilinear_warp(img, flow, max_disp)
    dimg, dflow = torch.autograd.grad(out, (img, flow), gout)
    assert KERNELS["bilinear_warp"].launches == 1 and KERNELS_BWD["bilinear_warp_bwd"].launches == 1
    pimg, pflow = bilinear_warp_backward_plain(gout, img.detach(), flow.detach())
    _assert_grad_close(dimg, pimg, dtype)
    _assert_grad_close(dflow, pflow, flow_dtype)
    # autograd of the plain forward on f32 copies of the same values: on bf16
    # leaves autograd would add the image gradient up in bf16
    img32, flow32 = img.detach().float().requires_grad_(), flow.detach().float().requires_grad_()
    aimg, aflow = torch.autograd.grad(bilinear_warp_plain(img32, flow32), (img32, flow32), gout.float())
    _assert_grad_close(dimg, aimg.to(dtype), dtype)
    _assert_grad_close(dflow, aflow.to(flow_dtype), flow_dtype)
    # one gradient at a time: dflow alone through the first version with no
    # image gradient (a gather there), dimg alone through the same route as
    # both (on the gather, the same bits)
    args = (gout, img.detach(), flow.detach(), max_disp)
    assert W.backward_route(*args, (False, True)) == W.ROUTE_SCATTER
    none_img, only_flow = bilinear_warp_backward(*args, need=(False, True))
    only_img, none_flow = bilinear_warp_backward(*args, need=(True, False))
    assert none_img is None and none_flow is None
    _assert_grad_close(only_flow, pflow, flow_dtype)
    _assert_grad_close(only_img, pimg, dtype)
    if want_route == W.ROUTE_GATHER:
        assert torch.equal(only_img, dimg)


_TRAIN_WARP_LEVELS = [(8, 48, 64, 32), (8, 24, 32, 64), (8, 12, 16, 96), (8, 6, 8, 128)]


def _train_warp_inputs(cuda, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    n, h, w, _ = shape
    img = torch.randn(shape, generator=g).to(cuda, dtype)
    flow = ((torch.rand((n, h, w, 2), generator=g) * 2 - 1) * 7.9).to(cuda, dtype)
    gout = torch.randn(shape, generator=g).to(cuda, dtype)
    return gout, img, flow


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _TRAIN_WARP_LEVELS)
def test_bilinear_warp_backward_is_deterministic(cuda, shape, dtype):
    """Two calls at the trainer's four warp levels give dimg and dflow equal
    to the bit: the gather adds each source pixel's contributors in
    increasing output index, with no atomics."""
    from vstab_torch.kernels import bilinear_warp_backward
    from vstab_torch.kernels import warp as W

    gout, img, flow = _train_warp_inputs(cuda, shape, dtype, 12)
    assert W.backward_route(gout, img, flow, 8, (True, True)) == W.ROUTE_GATHER
    first = bilinear_warp_backward(gout, img, flow, 8)
    second = bilinear_warp_backward(gout, img, flow, 8)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", _TRAIN_WARP_LEVELS)
def test_bilinear_warp_backward_does_not_depend_on_the_batch(cuda, shape):
    """An image's dimg and dflow are the same to the bit alone, with one
    other image or in a batch of 8, at the trainer's four f32 warp levels:
    the order of each sum follows from the flow alone, not from the tile or
    the batch, so that half-batches agree with the whole batch."""
    from vstab_torch.kernels import bilinear_warp_backward

    gout, img, flow = _train_warp_inputs(cuda, shape, torch.float32, 13)
    whole = bilinear_warp_backward(gout, img, flow, 8)
    for lo, hi in ((0, 1), (3, 5), (7, 8)):
        part = bilinear_warp_backward(
            gout[lo:hi].contiguous(), img[lo:hi].contiguous(), flow[lo:hi].contiguous(), 8)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[lo:hi])


def test_bilinear_warp_backward_is_zero_where_the_flow_was_clipped(cuda):
    from vstab_torch.kernels import bilinear_warp_backward_plain

    g = torch.Generator().manual_seed(5)
    img = torch.randn((2, 19, 24, 32), generator=g).to(cuda).requires_grad_()
    flow = _edge_flow(g, 2, 19, 24).to(cuda).requires_grad_()  # +-12: much of it clipped
    gout = torch.randn((2, 19, 24, 32), generator=g).to(cuda)
    dimg, dflow = torch.autograd.grad(bilinear_warp(img, flow, 8), (img, flow), gout)
    inside = (flow.detach().abs() <= 8).float()
    assert 0.2 < float(inside.mean()) < 0.95
    pimg, pflow = bilinear_warp_backward_plain(gout, img.detach(), flow.detach().clamp(-8, 8))
    _assert_grad_close(dimg, pimg, torch.float32)
    _assert_grad_close(dflow, pflow * inside, torch.float32)
    assert float((dflow * (1 - inside)).abs().max()) == 0.0


def test_bilinear_warp_unbounded_is_the_plain_warp(cuda):
    from vstab_torch.kernels.warp import UNBOUNDED

    g = torch.Generator().manual_seed(6)
    img = torch.rand((2, 33, 47, 3), generator=g).to(cuda)
    flow = (torch.rand((2, 33, 47, 2), generator=g) * 60 - 30).to(cuda)
    torch.testing.assert_close(
        bilinear_warp(img, flow, UNBOUNDED), bilinear_warp_plain(img, flow), rtol=0, atol=1e-5
    )


def test_bilinear_warp_backward_flow_only(cuda):
    """The photometric loss's warp: a constant image, the gradient to the flow."""
    from vstab_torch.kernels import bilinear_warp_backward_plain
    from vstab_torch.kernels.warp import UNBOUNDED

    g = torch.Generator().manual_seed(7)
    img = torch.rand((2, 16, 24, 3), generator=g).to(cuda)
    flow = (torch.rand((2, 16, 24, 2), generator=g) * 30 - 15).to(cuda).requires_grad_()
    gout = torch.randn((2, 16, 24, 3), generator=g).to(cuda)
    (dflow,) = torch.autograd.grad(bilinear_warp(img, flow, UNBOUNDED), (flow,), gout)
    _assert_grad_close(dflow, bilinear_warp_backward_plain(gout, img, flow.detach())[1], torch.float32)
    from vstab_torch.kernels import bilinear_warp_backward

    none_img, direct = bilinear_warp_backward(gout, img, flow.detach(), UNBOUNDED, need=(False, True))
    assert none_img is None and torch.equal(direct, dflow)  # no atomics on this side: the same bits
    with pytest.raises(TypeError):
        bilinear_warp_backward(gout.bfloat16(), img, flow.detach())  # g must have the image's dtype


# The trainer on the card with a tiny network in f32: the steps go through
# the forward and backward kernels (two estimated levels: 2 cost volumes and 1
# feature warp a pass; the photometric loss adds its own unclipped warp, whose
# backward gives the flow's gradient only), the loss of a fixed batch falls,
# and the first step's loss equals the CPU run's of the plain versions.
@pytest.mark.parametrize("mode", ["supervised", "photometric"])
def test_train_steps_on_the_card_go_through_the_kernels(cuda, mode):
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow import train as T
    from vstab_torch.flow.pwcnet import init_params
    from vstab_torch.kernels import KERNELS_BWD

    cfg = FlowConfig(
        pyramid_channels=(8, 16, 24), estimator_channels=(16, 16), context_dilations=(1, 2, 1),
        search_radius=2, compute_dtype="float32", output_level=2,
    )
    params = init_params(0, cfg, "cpu")
    batch = T.synthetic_batch(torch.Generator().manual_seed(1), 2, 64, 64, max_disp=2.0)
    if mode == "photometric":
        batch = {"im1": batch["im1"], "im2": batch["im2"]}
    want = float(T.make_loss(T._trainable(params, cfg, torch.device("cpu")), mode)(batch)[0].detach())

    net = T._trainable(params, cfg, cuda)
    opt = T.make_optimizer(net.parameters(), lr=3e-4)
    step = T.make_train_step(net, opt, mode)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    reset_launches()
    losses = [float(step(on_card)["loss"]) for _ in range(8)]
    extra = 1 if mode == "photometric" else 0
    assert KERNELS["cost_volume"].launches == 8 * 2 and KERNELS_BWD["cost_volume_bwd"].launches == 8 * 2
    assert KERNELS["bilinear_warp"].launches == 8 * (1 + extra)
    assert KERNELS_BWD["bilinear_warp_bwd"].launches == 8 * (1 + extra)
    assert KERNELS["vwarp"].launches == KERNELS["hwarp"].launches == 0
    assert abs(losses[0] - want) <= 1e-4 * abs(want)
    assert all(l == l for l in losses) and losses[-1] < losses[0]
    assert bool(torch.isfinite(opt.grad_norm))


def test_train_entry_points_run_on_the_card(cuda, tmp_path, capsys):
    """`train` (host-made scenes) and the module's command line (`train_fast`
    and the two `eval_epe` gates), a few steps each at a small size."""
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow import train as T
    from vstab_torch.utils.checkpoint import load_params, params_from_jax

    cfg = FlowConfig(
        pyramid_channels=(8, 16, 24), estimator_channels=(16, 16), context_dilations=(1, 2, 1),
        search_radius=2, compute_dtype="float32", output_level=2,
    )
    p = T.train(cfg, steps=3, batch_size=2, hw=(64, 64), log_every=1, ckpt_dir=str(tmp_path), mode="photometric")
    assert all(v.is_cuda for v in p.values()) and "step 2:" in capsys.readouterr().out
    back = params_from_jax(load_params(str(tmp_path / "flow_000003.msgpack")))
    assert all(torch.equal(back[k], p[k].cpu()) for k in p)
    assert T._main(["--steps", "4", "--scan-len", "2", "--batch", "2", "--hw", "64", "64", "--n-scenes", "4",
                    "--ckpt-dir", str(tmp_path / "full")]) == 0
    out = capsys.readouterr().out
    assert "step 4/4" in out and "held-out EPE [in-dist]" in out and "held-out EPE [cross-dist]" in out
    assert (tmp_path / "full" / "flow_000004.msgpack").exists()


# Data parallelism through one NCCL rank: a sum over one rank divided by one
# is the identity, so under `cudnn.deterministic` the step with the group
# and the step without it are equal to the bit, after the parameters'
# broadcast, the size check and the two all-reduces have run.
def test_dp_train_step_one_nccl_rank_equals_the_plain_step(cuda, deterministic_cudnn):
    import torch.distributed as dist

    from vstab_torch.core.config import FlowConfig
    from vstab_torch.dist.init import BACKEND
    from vstab_torch.flow import train as T
    from vstab_torch.flow.pwcnet import init_params
    from vstab_torch.kernels import KERNELS_BWD

    cfg = FlowConfig(
        pyramid_channels=(8, 16, 24), estimator_channels=(16, 16), context_dilations=(1, 2, 1),
        search_radius=2, compute_dtype="float32", output_level=2,
    )
    params = init_params(0, cfg, cuda)
    batch = {k: v.to(cuda) for k, v in T.synthetic_batch(torch.Generator().manual_seed(1), 4, 64, 64, 2.0).items()}

    def run(group):
        net = T._trainable(params, cfg, cuda)
        step = T.make_train_step(net, T.make_optimizer(net.parameters(), 3e-4), "supervised", group=group)
        reset_launches()
        metrics = [step(batch) for _ in range(3)]
        launched = [k.launches for k in (*KERNELS.values(), *KERNELS_BWD.values())]
        return metrics, T._state(net), launched

    plain = run(None)
    dist.init_process_group(BACKEND, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        dp = run(dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    for got, want in zip(dp[0], plain[0]):
        assert set(got) == set(want) == {"loss", "grad_norm", "epe_finest"}
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(dp[1][k], plain[1][k]) for k in plain[1])
    assert dp[2] == plain[2] == [3 * 2, 3 * 1, 0, 0, 3 * 2, 3 * 1]


# `stabilize_checked` runs the kernels on the card, its checks between them.
def test_stabilize_checked_on_the_card_equals_stabilize(cuda, deterministic_cudnn):
    import vstab_torch
    from vstab_torch.utils.debug import _smooth_and_render_checked, stabilize_checked

    cfg, params, frames = _sharded_case("sparse_ls")
    frames = frames[:9]
    reset_launches()
    got, _ = stabilize_checked(frames, params, cfg)
    assert all(k.launches > 0 for k in KERNELS.values())
    assert torch.equal(got, vstab_torch.stabilize(frames, params, cfg)[0])
    flow = torch.zeros((8, 48, 64, 2), device=cuda)
    flow[3, 5, 6, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="1 nan values in the flow"):
        _smooth_and_render_checked(torch.as_tensor(frames, device=cuda), flow, cfg)
    frames = frames.copy()
    frames[4, 7, 9, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="1 nan values in the input frames"):
        stabilize_checked(frames, params, cfg)


if __name__ == "__main__":
    _sharded_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])


# The spans of `vstab_torch.utils.trace` on the card: a 720p clip of the
# default Config with the checkpoint under ckpts/, drawn on the card (a
# smooth random scene shifted a few pixels a frame).
@pytest.fixture(scope="module")
def clip_720p():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    import torch.nn.functional as F

    import vstab_torch

    g = torch.Generator(device="cuda").manual_seed(0)
    scene = F.interpolate(torch.rand((1, 3, 90, 160), generator=g, device="cuda"),
                          size=(720 + 32, 1280 + 32), mode="bicubic", align_corners=False)
    shifts = torch.randint(0, 33, (48, 2), generator=g, device="cuda").tolist()
    frames = torch.stack([scene[0, :, y : y + 720, x : x + 1280] for y, x in shifts])
    frames = frames.permute(0, 2, 3, 1).clamp(0, 1).contiguous()
    cfg = vstab_torch.Config()
    ckpts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ckpts")
    params = vstab_torch.default_params(cfg, ckpt_dir=ckpts)
    vstab_torch.stabilize(frames, params, cfg)  # builds the kernels, warms cuDNN
    return frames, params, cfg


def test_stage_spans_cover_a_720p_call(clip_720p):
    """The stream ms of the flow, smooth, warp-field and render spans sum to
    within 5% of the call's wall time between two synchronisations: what
    `bench.measure(stages=True)` reports covers the call."""
    import time

    import vstab_torch
    from vstab_torch.utils import trace

    frames, params, cfg = clip_720p
    trace.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace.recording():
        vstab_torch.stabilize(frames, params, cfg)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    ms = {r["name"]: r["device_ms"] for r in trace.records()}
    trace.clear()
    staged = sum(ms[k] for k in ("vstab.flow", "vstab.smooth", "vstab.warp_field", "vstab.render"))
    print(f"720p call {wall_ms:.2f} ms, spans {ms}")
    assert abs(staged - wall_ms) <= 0.05 * wall_ms, (staged, wall_ms, ms)


def _syncs(fn):
    """fn() under `set_sync_debug_mode("warn")` and `trace.recording()`: each
    synchronising call made from vstab_torch's code, as (its innermost line
    there, the innermost open span)."""
    import traceback
    import warnings

    from vstab_torch.utils import trace

    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1] if os.sep + "vstab_torch" + os.sep in f.filename]
            if ours:
                stack = [s.name for s in trace._THREAD.stack if s.record]
                where = ours[-1].filename.split(os.sep + "vstab_torch" + os.sep)[-1]
                found.append((f"{where}:{ours[-1].lineno}", stack[-1] if stack else None))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.recording():
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    trace.clear()
    return found


# Host syncs counted on the card (NVIDIA H100 80GB HBM3, torch 2.11): each
# one's line and enclosing span are listed in PERF.md. A clip's are uploads
# of host-made constants (pageable memory) and the bucket's read-back; a
# training step reads nothing back.
STABILIZE_SYNCS = 13
TRAIN_STEP_SYNCS = 0


def test_host_syncs_of_a_clip_and_a_training_step(clip_720p):
    import vstab_torch
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow import train as T
    from vstab_torch.flow.pwcnet import init_params

    frames, params, cfg = clip_720p
    clip_syncs = _syncs(lambda: vstab_torch.stabilize(frames, params, cfg))

    fcfg = FlowConfig(compute_dtype="float32")
    net = T._trainable(init_params(0, fcfg, "cuda"), fcfg, torch.device("cuda"))
    opt = T.make_optimizer(net.parameters(), lr=1e-4)
    step = T.make_train_step(net, opt, "supervised", T.cosine_schedule(opt, 8000, 0.02))
    gen = torch.Generator(device="cuda").manual_seed(0)
    scenes = torch.rand((16, 192, 256, 3), device="cuda")
    step(T._sample_batch(gen, scenes, 8, 12.0))  # the optimizer's state is made on the first step
    batch = T._sample_batch(gen, scenes, 8, 12.0)
    step_syncs = _syncs(lambda: step(batch))
    print(f"stabilize syncs {clip_syncs}; train step syncs {step_syncs}")
    assert (len(clip_syncs), len(step_syncs)) == (STABILIZE_SYNCS, TRAIN_STEP_SYNCS), (
        clip_syncs, step_syncs)


def test_blocked_pinned_bytes_are_its_buffers(cuda):
    """`pinned_bytes` is the two staging buffers of each sweep, every motion
    fetch and the render fetches of every frame; `host_s` has its seven keys."""
    import numpy as np

    import vstab_torch
    from vstab_torch import pipeline_blocked as pb
    from vstab_torch.core import config as tcfg
    from vstab_torch.eval.synthetic import make_shaky_clip

    cfg = tcfg.Config(flow=tcfg.FlowConfig(pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
                                           compute_dtype="float32", output_level=1))
    params = vstab_torch.default_params(cfg, seed=0, ckpt_dir="/nonexistent")
    frames, _ = make_shaky_clip(t=21, h=48, w=64, seed=5)
    u8 = (np.clip(frames, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    stats = pb._run_blocked(lambda: ((u8[i : i + 8], i) for i in range(0, 21, 8)),
                            lambda blk, start: None, 21, params, cfg, 8, torch.device("cuda"))
    motion = pb._block_motion(params, torch.from_numpy(u8[:9]).cuda(), cfg)
    frame = 48 * 64 * 3
    want = 2 * 9 * frame + 3 * motion.numel() * 4 + 2 * 8 * frame + 21 * frame * 4
    assert stats["pinned_bytes"] == want
    assert set(stats["host_s"]) == {"prefetch_wait", "staging_wait", "stage_copy", "dispatch",
                                    "pinned_alloc", "fetch_wait", "drain_copy", "out_wait"}
    assert stats["host_s"]["pinned_alloc"] > 0 and stats["host_s"]["dispatch"] > 0


# RAFT's correlation lookup (`csrc/corr_lookup.cu`) against its plain
# `grid_sample` version: the same four taps, and weights from coordinates
# that differ by a few float32 ulps (the plain version maps each coordinate to
# [-1, 1] and back: ~1e-5 px at 160 columns), so samples of a unit-scale
# random level differ by up to ~1e-4 (7.7e-5 seen at the 720p chunk): 2e-4
# abs, plus one bf16 ulp in bfloat16 (both round the f32 sum once).
LOOKUP_ATOL = 2e-4
def _corr_pyramid(cuda, n, h8, w8, levels=4, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn((n * h8 * w8, 1, h8, w8), generator=g, device=cuda)
    pyr = [base]
    for _ in range(levels - 1):
        pyr.append(torch.nn.functional.avg_pool2d(pyr[-1], 2, stride=2))
    return [p[:, 0].contiguous() for p in pyr]


def _coords(cuda, n, h8, w8, spread, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h8, device=cuda), torch.arange(w8, device=cuda), indexing="ij")
    base = torch.stack([xx, yy], dim=-1).float()[None].expand(n, h8, w8, 2)
    return (base + spread * torch.randn((n, h8, w8, 2), generator=g, device=cuda)).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_lookup_matches_plain_at_the_720p_chunk(cuda, dtype):
    """8 pairs at 90x160, levels 90x160 / 45x80 / 22x40 / 11x20, flow of a
    few pixels at 1/8 (the 720p cell's shape), radius 4."""
    from vstab_torch.kernels import KERNELS_RAFT, corr_lookup, corr_lookup_plain

    pyr = _corr_pyramid(cuda, 8, 90, 160)
    assert [tuple(p.shape[1:]) for p in pyr] == [(90, 160), (45, 80), (22, 40), (11, 20)]
    coords = _coords(cuda, 8, 90, 160, 3.0)
    reset_launches()
    got = corr_lookup(pyr, coords, 4, dtype)
    assert KERNELS_RAFT["corr_lookup"].launches == 1
    assert got.shape == (8, 90, 160, 324) and got.dtype == dtype
    want = corr_lookup_plain(pyr, coords, 4, torch.float32)
    rtol = 2**-7 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=rtol, atol=LOOKUP_ATOL)


@pytest.mark.parametrize("radius,levels", [(4, 4), (3, 4), (1, 2), (4, 1)])
@pytest.mark.parametrize("where", ["left", "right", "top", "bottom", "far", "last_row_and_column"])
def test_corr_lookup_past_every_border_matches_plain(cuda, radius, levels, where):
    """Coordinates pushed past each border (samples partly and wholly
    outside read 0), far beyond it, and on the last row and column."""
    from vstab_torch.kernels import corr_lookup, corr_lookup_plain

    n, h8, w8 = 2, 13, 21
    pyr = _corr_pyramid(cuda, n, h8, w8, levels)
    coords = _coords(cuda, n, h8, w8, 0.5).clone()
    shift = {"left": (-w8 / 2 - 3.3, 0.0), "right": (w8 / 2 + 2.7, 0.0), "top": (0.0, -h8 / 2 - 4.1),
             "bottom": (0.0, h8 / 2 + 3.6), "far": (1e6, -3e7), "last_row_and_column": (0.0, 0.0)}[where]
    coords[..., 0] += shift[0]
    coords[..., 1] += shift[1]
    if where == "last_row_and_column":
        coords[:, -1, :, 1] = h8 - 1.0
        coords[:, :, -1, 0] = w8 - 1.0
    got = corr_lookup(pyr, coords, radius, torch.float32)
    want = corr_lookup_plain(pyr, coords, radius, torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=LOOKUP_ATOL)
    if where == "far":
        assert float(got.abs().max()) == 0.0


def test_corr_lookup_refuses_what_it_cannot_take(cuda):
    from vstab_torch.kernels import corr_lookup

    pyr = _corr_pyramid(cuda, 1, 8, 12)  # four levels down to 1x1
    coords = _coords(cuda, 1, 8, 12, 1.0)
    with pytest.raises(ValueError):
        corr_lookup(pyr * 2, coords)  # 8 levels
    with pytest.raises(ValueError):
        corr_lookup(pyr, coords, radius=5)
    with pytest.raises(TypeError):
        corr_lookup([p.double() for p in pyr], coords.double())
    with pytest.raises(ValueError):
        corr_lookup(pyr, coords[:, :, :3].contiguous())  # a pixel count the levels do not have
    with pytest.raises(ValueError):
        corr_lookup([p.cpu() for p in pyr], coords)


def test_raft_stabilize_on_the_card_matches_the_cpu(cuda):
    """`stabilize` with RAFT through `clip_flow` on the card (cuBLAS, cuDNN,
    the lookup kernel) against the same call on the CPU, in float32 with
    TF32 off: 20 launches a chunk, flow within 1e-3 px, the same render
    bucket and the output within 1e-3 on 99.9% of the values."""
    import vstab_torch
    from vstab_torch.core import config as tcfg
    from vstab_torch.flow import raft
    from vstab_torch.kernels import KERNELS_RAFT
    from vstab_torch.pipeline import clip_flow

    cfg = tcfg.Config(flow=tcfg.RaftConfig(compute_dtype="float32"))
    params = raft.init_params(0, cfg.flow, device="cpu")
    g = torch.Generator().manual_seed(3)
    frames = torch.rand((10, 64, 96, 3), generator=g)
    want_flow = clip_flow(params, frames, cfg)
    reset_launches()
    got_flow = clip_flow({k: v.to(cuda) for k, v in params.items()}, frames.to(cuda), cfg)
    assert KERNELS_RAFT["corr_lookup"].launches == 2 * 20  # 9 pairs: two chunks of 8
    torch.testing.assert_close(got_flow.cpu(), want_flow, rtol=0, atol=1e-3)
    want, _ = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    got, _ = vstab_torch.stabilize(frames, params, cfg)
    close = ((got.cpu() - want).abs() <= 1e-3).float().mean()
    assert float(close) >= 0.999


# RAFT's correlation pyramid is stated in float32 with TF32 off. Held as the
# timed path makes it: the features and the pyramid of the chunk's first
# pair, caught at `raft.corr_pyramid` inside `estimate_flow_pairs` on a 720p
# chunk (8 pairs, 90x160, levels to 11x20), against a float64 matmul and
# pooling of the same features; the reading is the largest error over the
# RMS of the float64 volume. The bound sits between the path in float32 and
# two lower precisions, each of which the test also reads and requires to
# fail it: the pyramid rounded to bfloat16 (both compute dtypes) and, for
# float32 features, the product under TF32. Under the bfloat16 compute dtype
# the features are bfloat16 values, which TF32 holds exactly: there TF32
# changes nothing but the order of the sums, and is not a fault. Read on an
# H100 (700 W): the path 1.6e-6 (bfloat16 features) and 2.3e-6 (float32),
# TF32 3.7e-4, the pyramid in bfloat16 6.6e-3; the bound lies about 13
# times from the path and from TF32.
PYRAMID_RTOL = 3e-5


def _pyramid_error(got, f1, f2):
    c = f1.shape[1]
    a = f1[0].double().flatten(1)
    b = f2[0].double().flatten(1)
    want = (a.T @ b / c**0.5).view(-1, 1, *f1.shape[2:])
    err, scale = 0.0, float(want.pow(2).mean().sqrt())
    for lvl, g in enumerate(got):
        if lvl:
            want = torch.nn.functional.avg_pool2d(want, 2, stride=2)
        err = max(err, float((g.double() - want[:, 0]).abs().max()))
    return err / scale


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_raft_corr_pyramid_is_float32_on_the_timed_path(cuda, monkeypatch, compute_dtype):
    from vstab_torch.core.config import RaftConfig
    from vstab_torch.flow import raft

    cfg = RaftConfig(iters=1, compute_dtype=compute_dtype)
    params = raft.prepare(raft.init_params(0, cfg, cuda), cfg)
    real, seen = raft.corr_pyramid, []

    def spy(f1, f2, levels):
        out = real(f1, f2, levels)
        hw = f1.shape[2] * f1.shape[3]
        seen.append((f1[:1].clone(), f2[:1].clone(), [t[:hw].clone() for t in out]))
        return out

    monkeypatch.setattr(raft, "corr_pyramid", spy)
    g = torch.Generator(device=cuda).manual_seed(11)
    frames = torch.rand((9, 720, 1280, 3), generator=g, device=cuda)
    raft.estimate_flow_pairs(params, frames, cfg)
    (f1, f2, got), = seen
    assert f1.shape == (1, 256, 90, 160) and [tuple(t.shape[1:]) for t in got] == [
        (90, 160), (45, 80), (22, 40), (11, 20)]
    assert all(t.dtype == torch.float32 for t in got)
    readings = {"path": _pyramid_error(got, f1, f2),
                "pyramid_bf16": _pyramid_error([t.bfloat16() for t in got], f1, f2)}
    if compute_dtype == "float32":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            readings["tf32"] = _pyramid_error([t[: got[0].shape[0]] for t in real(f1, f2, 4)], f1, f2)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    print(f"corr pyramid error / rms ({compute_dtype} features): {readings}")
    assert readings["path"] < PYRAMID_RTOL
    assert all(v > PYRAMID_RTOL for k, v in readings.items() if k != "path")


def _kernels_in_spans(prof, span: str, tmp_path) -> list:
    """Names of the kernels launched inside the spans named `span` of a
    profiled run, each found by the correlation id of its launch."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans, launches, kernels = [], {}, []
    for e in json.loads(path.read_text())["traceEvents"]:
        cat, args = e.get("cat"), e.get("args", {})
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if cat == "user_annotation" and e.get("name") == span:
            spans.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = e["ts"]
        elif cat == "kernel" and "correlation" in args:
            kernels.append((args["correlation"], e["name"]))
    return [name for c, name in kernels if c in launches and any(a <= launches[c] <= b for a, b in spans)]


def _is_sgemm(name: str) -> bool:
    return "f32f32_f32f32" in name or "sgemm" in name.lower()


# The route of RAFT's correlation product (`raft.corr_gemm`), held on the 720p
# chunk of the test above: bfloat16 features take one bf16 product with
# float32 sums and a float32 volume, the scale in its alpha, so the span
# launches no f32 SGEMM and no elementwise kernel (the division over the
# volume, the features' upcasts): the product and the three poolings alone.
# Float32 features, and RAFT's training pass under autograd, keep the f32
# SGEMM. The pyramid's error is read as in the test above.
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_raft_corr_takes_the_tensor_cores_for_bf16_features(cuda, monkeypatch, tmp_path, compute_dtype):
    from torch.profiler import ProfilerActivity, profile

    from vstab_torch.core.config import RaftConfig
    from vstab_torch.flow import raft
    from vstab_torch.utils import trace

    cfg = RaftConfig(iters=1, compute_dtype=compute_dtype)
    params = raft.prepare(raft.init_params(0, cfg, cuda), cfg)
    real, seen = raft.corr_pyramid, []

    def spy(f1, f2, levels):
        out = real(f1, f2, levels)
        hw = f1.shape[2] * f1.shape[3]
        seen.append((f1[:1].clone(), f2[:1].clone(), [t[:hw].clone() for t in out]))
        return out

    monkeypatch.setattr(raft, "corr_pyramid", spy)
    g = torch.Generator(device=cuda).manual_seed(11)
    frames = torch.rand((9, 720, 1280, 3), generator=g, device=cuda)
    raft.estimate_flow_pairs(params, frames, cfg)  # cuBLAS's and cuDNN's first calls at these shapes
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        raft.estimate_flow_pairs(params, frames, cfg)
        torch.cuda.synchronize()
    (rec,) = [r for r in trace.records() if r["name"] == "vstab.flow.raft.corr"]
    trace.clear()
    names = _kernels_in_spans(prof, "vstab.flow.raft.corr", tmp_path)
    f1, f2, got = seen[-1]
    err = _pyramid_error(got, f1, f2)
    print(f"corr span ({compute_dtype} features): gemm={rec['attrs']['gemm']}, pyramid error / rms {err:.3e}, "
          f"kernels {names}")
    assert err < PYRAMID_RTOL
    pools = [k for k in names if "avg_pool2d" in k]
    assert len(pools) == 3
    if compute_dtype == "bfloat16":
        assert rec["attrs"]["gemm"] == "bf16_f32acc"
        assert len(names) == 4 and not any(_is_sgemm(k) or "elementwise" in k for k in names), names
    else:
        assert rec["attrs"]["gemm"] == "f32"
        assert any(_is_sgemm(k) for k in names), names

    train = RaftConfig(iters=2, compute_dtype="float32")
    net = raft.build_net(raft.init_params(0, train, cuda), train, cuda)
    im = torch.rand((4, 64, 96, 3), generator=g, device=cuda)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        preds = net(im[:2], im[2:])
        torch.cuda.synchronize()
    (rec,) = [r for r in trace.records() if r["name"] == "vstab.flow.raft.corr"]
    trace.clear()
    assert preds[-1].requires_grad and rec["attrs"]["gemm"] == "f32"
    assert any(_is_sgemm(k) for k in _kernels_in_spans(prof, "vstab.flow.raft.corr", tmp_path))


# The lookup's backward (`vstab_corr_lookup_bwd`) against autograd of the
# plain `grid_sample` version at the `train_raft_chairs` cell's shape: 10
# pairs at 46x62, levels 46x62 / 23x31 / 11x15 / 5x7, radius 4, coordinates
# drifted up to +-40 px (many windows partly or wholly outside a level), a
# unit-scale random gradient. Both place the same four weights of each
# sample; the plain version's weights come from coordinates mapped to
# [-1, 1] and back (a few float32 ulps), so a window entry may differ by
# about 1e-5 of the gradient rows' scale: LOOKUP_ATOL, as for the forward.
# The written-out plain backward is held to the same bound.
def test_corr_lookup_backward_matches_plain_autograd_at_the_train_cell(cuda):
    from vstab_torch.kernels import KERNELS_RAFT, corr_lookup, corr_lookup_backward_plain, corr_lookup_plain

    n, h8, w8 = 10, 46, 62
    pyr = _corr_pyramid(cuda, n, h8, w8)
    assert [tuple(p.shape[1:]) for p in pyr] == [(46, 62), (23, 31), (11, 15), (5, 7)]
    g = torch.Generator(device=cuda).manual_seed(2)
    coords = _coords(cuda, n, h8, w8, 0.0)
    coords = (coords + 40.0 * (2.0 * torch.rand(coords.shape, generator=g, device=cuda) - 1.0)).contiguous()
    leaves = [p.clone().requires_grad_(True) for p in pyr]
    reset_launches()
    out = corr_lookup(leaves, coords, 4)
    grad = torch.randn(out.shape, generator=g, device=cuda)
    got = torch.autograd.grad(out, leaves, grad)
    assert KERNELS_RAFT["corr_lookup"].launches == 1 and KERNELS_RAFT["corr_lookup_bwd"].launches == 1
    plain = [p.clone().requires_grad_(True) for p in pyr]
    want = torch.autograd.grad(corr_lookup_plain(plain, coords, 4), plain, grad)
    written = corr_lookup_backward_plain(grad, [tuple(p.shape[1:]) for p in pyr], coords, 4)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    print(f"lookup backward at 10x46x62, r=4, +-40 px: max error by level {errs} (bound {LOOKUP_ATOL})")
    for a, b, c in zip(got, want, written):
        torch.testing.assert_close(a, b, rtol=0, atol=LOOKUP_ATOL)
        torch.testing.assert_close(c, b, rtol=0, atol=LOOKUP_ATOL)
    with pytest.raises(ValueError, match="no gradient"):
        corr_lookup(pyr, coords.clone().requires_grad_(True), 4)
    with pytest.raises(TypeError, match="float32"):
        low = corr_lookup(leaves, coords, 4, torch.bfloat16)
        torch.autograd.grad(low, leaves, torch.ones_like(low))


def test_raft_train_steps_on_the_card_match_the_reference(cuda):
    """3 steps shaped as the `train_raft_chairs` cell's (RAFT's weights from
    the configuration's seed, batch 10 at 368x496 from its scene pool, 12
    iterations) against `h100bench/reference/raft_train.py`, judged as the
    cell judges them, under the cell's limits; the lookup and its backward
    launched 12 times a step each."""
    import time

    from h100bench import harness
    from h100bench.drivers import common
    from h100bench.drivers import train_raft as drv
    from h100bench.drivers.stabilize_raft import params as raft_params
    from vstab_torch.kernels import KERNELS_RAFT

    cell = harness.Cell.find("train_raft_chairs")
    run = harness.Run(cell=cell, seed=2**31 + 5, seconds=0.0, trace=False, device=cuda,
                      t_start=time.perf_counter())
    cfg_dict, recipe = cell.config["program"], cell.config["recipe"]
    params0 = raft_params(run)
    traffic = harness.generator(cell.traffic["generator"]).generate(cell.traffic, run.seed, cuda)
    gen = torch.Generator(device=cuda).manual_seed(traffic["batch_seed"])
    net, opt, step = drv.build_step(params0, common.program_config(cell.config), recipe, cuda)
    reset_launches()
    first = drv.first_steps(step, net, opt, gen, traffic["scenes"], recipe, 3)
    assert KERNELS_RAFT["corr_lookup"].launches == KERNELS_RAFT["corr_lookup_bwd"].launches == 3 * 12
    del net, opt, step
    r = drv.readings(first, params0, traffic["scenes"], traffic["batch_seed"], cfg_dict, recipe, 3)
    print(f"RAFT training, 3 steps against the reference: {r} (limits {cell.spec['limits']})")
    assert all(r[k] <= limit for k, limit in cell.spec["limits"].items()), r


# The f32 prediction head's GEMM form (`layers.conv3x3_to2`) against cuDNN's
# f32 convolution with TF32 off, at the 720p chunk's level-2 head: max error
# over the largest output. Both sum 5085 f32 products, each in its own order.
# Read on an H100 (700 W): the path 3.2e-6, the same GEMM with TF32 allowed
# 2.1e-4 (its weights rounded to 10 bits; the bf16 stack is exact in TF32);
# the bound lies about 8 times from each.
HEAD_RTOL = 2.5e-5


def test_flow_head_gemm_form_matches_cudnn_f32_and_a_tf32_product_would_not(cuda):
    import torch.nn.functional as F

    from vstab_torch.core.precision import pin_full_f32
    from vstab_torch.flow import layers

    pin_full_f32()
    g = torch.Generator(device=cuda).manual_seed(20)
    stack = torch.randn((8, 192, 320, 565), generator=g, device=cuda, dtype=torch.bfloat16)
    x = F.leaky_relu(stack, 0.1).float()  # the estimator's bf16 stack, upcast
    del stack
    head = layers.Conv(565, 2, dtype=torch.float32, device=cuda)
    head.reset_parameters(g)
    w, b = head.weight.detach(), torch.randn(2, generator=g, device=cuda)
    with torch.no_grad():
        want = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)
        scale = float(want.abs().max())
        readings = {"path": float((layers.conv3x3_to2(x, w, b) - want).abs().max()) / scale}
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            readings["tf32"] = float((layers.conv3x3_to2(x, w, b) - want).abs().max()) / scale
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    print(f"flow head max error / max |out| against cuDNN f32: {readings}")
    assert readings["path"] < HEAD_RTOL < readings["tf32"]


def test_aligned_dense_stack_launches_no_channel_padding(clip_720p):
    """One 8-pair chunk of the 720p clip. Its five estimators and the context
    network, each called under torch.profiler on the input it took in the
    chunk's forward: in `prepare`'s layout cuDNN launches no
    `nhwcAddPaddingKernel`; in the published layout it does (the control).
    The two layouts' flows of the chunk differ by a mean |difference| under
    a fifth of the cell's `step_mean_px` limit of 0.065, which pools the
    same flows per grid cell (read on an H100, 700 W: 6.2e-3 px, max 0.14:
    cuDNN picks other bf16 kernels for the wider inputs, which round
    otherwise; the program reads up to 0.023 against the f32 reference)."""
    from torch.profiler import ProfilerActivity, profile

    from vstab_torch.flow import pwcnet

    frames, params, cfg = clip_720p
    flows, pads = {}, {}
    with torch.inference_mode():
        chunk, _ = pwcnet.pad_to_multiple(frames[:9], 2 ** len(cfg.flow.pyramid_channels))
        for name, p in (("published", dict(params)), ("aligned", pwcnet.prepare(params, cfg.flow))):
            net = pwcnet.build_net(p, cfg.flow)
            stack = [getattr(net, f"estimator{i}") for i in net.levels()] + [net.context]
            taken = []
            hooks = [m.register_forward_pre_hook(lambda m, args: taken.append((m, args))) for m in stack]
            feats = net.pyramid(chunk)
            pair = (tuple(f[:-1] for f in feats), tuple(f[1:] for f in feats))
            flows[name] = net(chunk[:-1], chunk[1:], feats=pair)["flow"]
            for h in hooks:
                h.remove()
            for m, args in taken:  # cuDNN's first calls at these shapes
                m(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for m, args in taken:
                    m(*args)
                torch.cuda.synchronize()
            pads[name] = sum(1 for e in prof.events() if "nhwcAddPaddingKernel" in e.name)
    diff = (flows["aligned"] - flows["published"]).abs()
    print(f"nhwcAddPaddingKernel launches of the estimators and the context {pads}; flow "
          f"|aligned - published| mean {float(diff.mean()):.3e} px, max {float(diff.max()):.3e} px")
    assert len(taken) == 6
    assert pads["published"] > 0 and pads["aligned"] == 0, pads
    assert float(diff.mean()) < 0.065 / 5


def _gmflow_params(device):
    """GMFlow's seeded weights as the benchmark's configuration draws them
    (layer-norm gains x 0.1, the trident weight x 0.15; see
    `tests/test_torch_gmflow.py`)."""
    from h100bench.reference import gmflow as ref_gmflow

    return ref_gmflow.init_params(0, device, norm_gain=0.1, feature_scale=0.15)


def test_gmflow_stabilize_on_the_card_matches_the_cpu(cuda):
    """`stabilize` with GMFlow through `clip_flow` on the card (cuBLAS, cuDNN,
    the attention kernels, the cost volume for the local matching and
    propagation) against the same call on the CPU. In float32 with TF32 off:
    2 cost-volume launches a chunk, flow within 1e-3 px (ten times the CPU
    tests' bound against the reference: cuBLAS, cuDNN and the attention
    kernels sum in other orders), the output within 1e-3 on 99.9% of the
    values. In bfloat16 (the configuration's precision): the mean gap to the
    float32 CPU flow under 5% of the mean flow, as the CPU tests hold the
    bf16 port to the reference."""
    import vstab_torch
    from vstab_torch.core import config as tcfg
    from vstab_torch.pipeline import clip_flow

    cfg = tcfg.Config(flow=tcfg.GmflowConfig(compute_dtype="float32"))
    params = _gmflow_params("cpu")
    g = torch.Generator().manual_seed(3)
    frames = torch.rand((10, 64, 96, 3), generator=g)
    want_flow = clip_flow(params, frames, cfg)
    reset_launches()
    got_flow = clip_flow({k: v.to(cuda) for k, v in params.items()}, frames.to(cuda), cfg)
    assert KERNELS["cost_volume"].launches == 2 * 2  # 9 pairs: two chunks of 8
    torch.testing.assert_close(got_flow.cpu(), want_flow, rtol=0, atol=1e-3)
    want, _ = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    got, _ = vstab_torch.stabilize(frames, params, cfg)
    close = ((got.cpu() - want).abs() <= 1e-3).float().mean()
    assert float(close) >= 0.999
    bf16 = tcfg.Config(flow=tcfg.GmflowConfig())
    gap = (clip_flow({k: v.to(cuda) for k, v in params.items()}, frames.to(cuda), bf16).cpu() - want_flow).abs()
    print(f"gmflow bf16 on the card against f32 on the CPU: mean {float(gap.mean()):.4f} px, "
          f"max {float(gap.max()):.4f} px, mean flow {float(want_flow.abs().mean()):.4f} px")
    assert float(gap.mean()) < 0.05 * float(want_flow.abs().mean())


# GMFlow's global matching and propagation logits are stated in float32
# with TF32 off. Held as the timed path makes them: the operands and the
# logits of the chunk's first pair, caught at `gmflow.logits` inside
# `estimate_flow_pairs` on a 720p chunk (8 pairs, 92x160 = 14,720 tokens),
# against a float64 product of the same operands; the reading is the largest
# error over the RMS of the float64 logits. The bound sits between the path
# and two lower precisions, each of which the test also reads and requires
# to fail it: the logits rounded to bfloat16 (every call) and the product
# under TF32, where an operand is not a bfloat16 value (the propagation's
# projections always; the matching's features under the float32 compute
# dtype: TF32 holds bfloat16 features exactly and only changes the order
# of the sums there). The local matching's and propagation's operands go to
# the cost volume in float32. The bound is RAFT's pyramid bound.
GMFLOW_LOGITS_RTOL = 3e-5


def _logits_error(got, a, b):
    want = a.double() @ b.double().T / a.shape[-1] ** 0.5
    return float((got.double() - want).abs().max()) / float(want.pow(2).mean().sqrt())


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_gmflow_matching_is_float32_on_the_timed_path(cuda, monkeypatch, compute_dtype):
    from vstab_torch.core.config import GmflowConfig
    from vstab_torch.flow import gmflow

    cfg = GmflowConfig(compute_dtype=compute_dtype)
    params = gmflow.prepare(_gmflow_params(cuda), cfg)
    real_logits, real_cv, seen, cv_dtypes = gmflow.logits, gmflow.cost_volume, [], []

    def spy(a, b):
        out = real_logits(a, b)
        seen.append((a[0].clone(), b[0].clone(), out[0].clone()))
        return out

    def cv_spy(f1, f2, radius):
        cv_dtypes.append((f1.dtype, f2.dtype, radius))
        return real_cv(f1, f2, radius)

    monkeypatch.setattr(gmflow, "logits", spy)
    monkeypatch.setattr(gmflow, "cost_volume", cv_spy)
    g = torch.Generator(device=cuda).manual_seed(11)
    frames = torch.rand((9, 720, 1280, 3), generator=g, device=cuda)
    gmflow.estimate_flow_pairs(params, frames, cfg)
    assert [t[2].shape for t in seen] == [(14720, 14720)] * 2  # global matching, then propagation
    assert all(x.dtype == torch.float32 for t in seen for x in t)
    assert cv_dtypes == [(torch.float32, torch.float32, 4), (torch.float32, torch.float32, 1)]
    for call, (a, b, got) in zip(("match", "propagate"), seen):
        readings = {"path": _logits_error(got, a, b),
                    "logits_bf16": _logits_error(got.bfloat16(), a, b)}
        exact_in_tf32 = call == "match" and compute_dtype == "bfloat16"
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            readings["tf32"] = _logits_error(real_logits(a[None], b[None])[0], a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        print(f"gmflow {call} logits error / rms ({compute_dtype}): {readings}")
        assert readings["path"] < GMFLOW_LOGITS_RTOL
        assert readings["logits_bf16"] > GMFLOW_LOGITS_RTOL
        if not exact_in_tf32:
            assert readings["tf32"] > GMFLOW_LOGITS_RTOL
