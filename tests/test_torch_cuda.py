"""vstab_torch's hand-written CUDA kernels held against their plain torch
versions on the card. Every test here needs a CUDA device and skips
without one; the file imports no JAX, so on a machine with a card and no
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: f32 outputs 1e-5 abs (same taps and weights, rounding apart);
bf16 outputs one bf16 ulp (both versions sum in f32 and round once).
"""

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


def test_roll_and_wrap_pad_on_the_card(cuda):
    from vstab_torch.kernels.warp1d import _roll_and_wrap_pad

    g = torch.Generator().manual_seed(3)
    frames = torch.randn((5, 12, 17, 3), generator=g)
    mu = torch.tensor([-20.0, 3.0, 0.0, 16.0, 40.0])
    mv = torch.tensor([5.0, -13.0, 0.0, 11.0, -30.0])
    want = _roll_and_wrap_pad(frames, mu, mv, 4)
    got = _roll_and_wrap_pad(frames.to(cuda), mu.to(cuda), mv.to(cuda), 4)
    assert torch.equal(got.cpu(), want)
