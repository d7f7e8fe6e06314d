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


if __name__ == "__main__":
    _sharded_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
