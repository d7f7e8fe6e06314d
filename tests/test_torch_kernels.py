"""vstab_torch kernels: the plain torch versions held against the JAX
package's XLA twins on the CPU, and the wrappers' dispatch. The hand-written
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: 1e-5 abs for plain vs XLA (same f32 arithmetic, sums in another
order); the same for the plain backward versions against `torch.autograd.grad`
of the plain forward and against `jax.vjp` of the XLA twins.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstab.kernels.cost_volume import cost_volume_xla
from vstab.kernels.warp import bilinear_warp_xla, warp_validity as warp_validity_ref
from vstab.kernels.warp1d import (
    hwarp_xla,
    twopass_validity as twopass_validity_ref,
    vwarp_xla,
    warp_twopass as warp_twopass_ref,
)
from vstab_torch.kernels import (
    KERNELS,
    KERNELS_BWD,
    bilinear_warp,
    bilinear_warp_backward_plain,
    bilinear_warp_plain,
    cost_volume,
    cost_volume_backward_plain,
    cost_volume_plain,
    hwarp,
    hwarp_plain,
    reset_launches,
    twopass_validity,
    vwarp,
    vwarp_plain,
    warp_twopass,
    warp_validity,
)

torch.set_num_threads(1)
ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, shape, lo=-1.0, hi=1.0):
    return (rng.random(shape) * (hi - lo) + lo).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


# The third to fifth are the shapes at which the card's bf16 kernel takes its
# other paths (196 and 21 channels: 8-byte and 2-byte staging copies, a
# channel tail; W=20 and 47: output runs that start unaligned); the last five
# are the trainer's pyramid levels at N=1 in f32, the channel counts of the
# f32 kernel's tiles, the coarsest an image smaller than the window. So the
# oracle the card's kernels are held to there is itself held to the
# reference here.
@pytest.mark.parametrize(
    "shape,radius",
    [((2, 33, 47, 24), 2), ((1, 12, 20, 19), 4), ((1, 6, 20, 196), 4), ((2, 9, 47, 21), 3), ((1, 5, 11, 21), 1),
     ((1, 48, 64, 32), 4), ((1, 24, 32, 64), 4), ((1, 12, 16, 96), 4), ((1, 6, 8, 128), 4), ((1, 3, 4, 196), 4)],
)
def test_cost_volume_plain_matches_xla(shape, radius):
    rng = np.random.default_rng(0)
    f1, f2 = _rand(rng, shape), _rand(rng, shape)
    want = cost_volume_xla(jnp.asarray(f1), jnp.asarray(f2), radius)
    got = cost_volume(torch.from_numpy(f1), torch.from_numpy(f2), radius)
    assert got.shape == shape[:3] + ((2 * radius + 1) ** 2,)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 33, 47, 3), (1, 16, 24, 8)])
def test_bilinear_warp_plain_matches_xla(shape):
    rng = np.random.default_rng(1)
    img = _rand(rng, shape)
    flow = _rand(rng, shape[:3] + (2,), -12.0, 12.0)
    want = bilinear_warp_xla(jnp.asarray(img), jnp.asarray(flow))
    # On the CPU the wrapper runs the plain version, unclipped, as the JAX
    # package's CPU path calls bilinear_warp_xla unclipped.
    got = bilinear_warp(torch.from_numpy(img), torch.from_numpy(flow), max_disp=8)
    _close(got, want)
    _close(bilinear_warp_plain(torch.from_numpy(img), torch.from_numpy(flow)), want)


# Channel counts at which the card's kernel takes its two paths (96: twelve
# 16-byte vectors a pixel; 20: not a multiple of 8, the per-element kernel),
# with flow beyond the +-8 clip and, in the corners, off both edges at once:
# the oracle the kernel is held to there is itself held to the reference here.
@pytest.mark.parametrize("shape", [(2, 19, 24, 96), (2, 19, 47, 20), (1, 24, 40, 128)])
def test_bilinear_warp_plain_matches_xla_off_every_edge(shape):
    rng = np.random.default_rng(5)
    n, h, w, _ = shape
    img = _rand(rng, shape)
    flow = _rand(rng, (n, h, w, 2), -12.0, 12.0)
    k = 6
    flow[:, :k, :k] = -7.5
    flow[:, :k, -k:] = (7.5, -7.5)
    flow[:, -k:, :k] = (-7.5, 7.5)
    flow[:, -k:, -k:] = 7.5
    clipped = np.clip(flow, -8.0, 8.0)  # what the card's kernel warps by
    for fl in (flow, clipped):
        want = bilinear_warp_xla(jnp.asarray(img), jnp.asarray(fl))
        _close(bilinear_warp_plain(torch.from_numpy(img), torch.from_numpy(fl)), want)


def test_warp_validity_matches_reference():
    rng = np.random.default_rng(2)
    flow = _rand(rng, (2, 33, 47, 2), -6.0, 6.0)
    want = warp_validity_ref((33, 47), jnp.asarray(flow))
    np.testing.assert_array_equal(warp_validity((33, 47), torch.from_numpy(flow)).numpy(), want)


@pytest.mark.parametrize("mode", ["edge", "wrap"])
# (2, 5, 13, c) with max_disp 16 >= W: in wrap mode the taps wrap more than
# once, which the card's row kernel is checked for against the plain version.
@pytest.mark.parametrize(
    "shape,max_disp",
    [((2, 33, 47, 3), 16), ((2, 40, 33, 1), 63), ((2, 5, 13, 3), 16), ((2, 5, 13, 1), 127)],
)
def test_1d_warps_plain_match_xla(mode, shape, max_disp):
    rng = np.random.default_rng(3)
    img = _rand(rng, shape)
    field = _rand(rng, shape[:3], -1.3 * max_disp, 1.3 * max_disp)  # some clipped
    ti, tf = torch.from_numpy(img), torch.from_numpy(field)
    ji, jf = jnp.asarray(img), jnp.asarray(field)
    _close(vwarp(ti, tf, max_disp, mode), vwarp_xla(ji, jf, max_disp, mode))
    _close(hwarp(ti, tf, max_disp, mode), hwarp_xla(ji, jf, max_disp, mode))
    _close(vwarp_plain(ti, tf, max_disp, mode), vwarp_xla(ji, jf, max_disp, mode))
    _close(hwarp_plain(ti, tf, max_disp, mode), hwarp_xla(ji, jf, max_disp, mode))


def _smooth_field(rng, n, h, w, amp):
    """A 3x4 grid of values in +-amp a frame, upsampled bilinearly to the
    frame: the kind of field the render gives the vertical pass."""
    coarse = _rand(rng, (n, 3, 4), -amp, amp)
    ys = np.clip((np.arange(h) + 0.5) * 3 / h - 0.5, 0, 2)
    xs = np.clip((np.arange(w) + 0.5) * 4 / w - 0.5, 0, 3)
    y0, x0 = np.minimum(ys.astype(int), 1), np.minimum(xs.astype(int), 2)
    fy, fx = (ys - y0)[None, :, None], (xs - x0)[None, None, :]
    c = lambda dy, dx: coarse[:, y0 + dy][:, :, x0 + dx]
    out = (1 - fy) * ((1 - fx) * c(0, 0) + fx * c(0, 1)) + fy * ((1 - fx) * c(1, 0) + fx * c(1, 1))
    return out.astype(np.float32)


# vwarp on a smooth field, where the card's kernel coalesces: in wrap mode
# with max_disp below the height (one add or subtract fixes a row index on
# the card) and at or beyond it (taps wrap more than once: floored modulo).
@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize(
    "shape,max_disp", [((2, 23, 53, 3), 16), ((2, 23, 53, 3), 127), ((2, 7, 40, 1), 16), ((1, 9, 31, 2), 63)]
)
def test_vwarp_plain_matches_xla_on_smooth_fields(mode, shape, max_disp):
    rng = np.random.default_rng(6)
    img = _rand(rng, shape)
    field = _smooth_field(rng, *shape[:3], 1.2 * max_disp)
    want = vwarp_xla(jnp.asarray(img), jnp.asarray(field), max_disp, mode)
    _close(vwarp_plain(torch.from_numpy(img), torch.from_numpy(field), max_disp, mode), want)
    _close(vwarp(torch.from_numpy(img), torch.from_numpy(field), max_disp, mode), want)


def _smooth_flow(rng, n, h, w, amp, offset):
    """Smooth random flow: a per-frame offset plus a low-frequency field."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 2), np.float32)
    for i in range(n):
        for c in range(2):
            a, b, ph = rng.normal(size=3)
            out[i, ..., c] = offset[i, c] + amp * np.sin(a * gx / w * 3 + b * gy / h * 3 + ph)
    return out


@pytest.mark.parametrize("max_disp", [16, 127])
def test_warp_twopass_and_validity_match_reference(max_disp):
    rng = np.random.default_rng(4)
    n, h, w = 3, 33, 47
    frames = _rand(rng, (n, h, w, 3), 0.0, 1.0)
    flow = _smooth_flow(rng, n, h, w, 5.0, np.array([[2.2, -3.7], [-11.4, 6.3], [0.6, 0.2]]))
    tfr, tfl = torch.from_numpy(frames), torch.from_numpy(flow)
    want = warp_twopass_ref(jnp.asarray(frames), jnp.asarray(flow), max_disp, impl="xla")
    _close(warp_twopass(tfr, tfl, max_disp), want, atol=1e-4)
    np.testing.assert_array_equal(
        twopass_validity((h, w), tfl, max_disp).numpy(),
        twopass_validity_ref((h, w), jnp.asarray(flow), max_disp),
    )


def test_twopass_validity_masks_large_residuals():
    flow = np.zeros((1, 8, 10, 2), np.float32)
    flow[0, 2, 3, 0] = 30.0  # residual beyond max_disp=16
    mask = twopass_validity((8, 10), torch.from_numpy(flow), 16).numpy()
    want = twopass_validity_ref((8, 10), jnp.asarray(flow), 16)
    np.testing.assert_array_equal(mask, want)
    assert mask[0, 2, 3] == 0.0


def test_wrappers_raise_on_other_devices():
    meta = torch.empty((1, 4, 4, 2), device="meta")
    field = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        cost_volume(meta, meta, 1)
    with pytest.raises(ValueError):
        bilinear_warp(meta, meta)
    with pytest.raises(ValueError):
        vwarp(meta, field)
    with pytest.raises(ValueError):
        hwarp(meta, field)


def test_cpu_path_launches_no_kernel():
    reset_launches()
    x = torch.zeros((1, 4, 5, 2))
    cost_volume(x, x, 1)
    bilinear_warp(x, x)
    vwarp(x, x[..., 0])
    hwarp(x, x[..., 0])
    assert all(k.launches == 0 for k in KERNELS.values())


# The plain backward versions are the oracle of the backward kernels on the
# card, so they are held here to autograd of the plain forward and to the
# reference's own gradient. g is scaled by a ramp over the window, so that a
# transposed shift in df2 would show. (1, 3, 4, 196) and (1, 6, 8, 128) are
# the trainer's two coarsest levels, where the window is wider than the image.
@pytest.mark.parametrize("radius", [1, 2, 4])
@pytest.mark.parametrize(
    "shape", [(2, 9, 11, 3), (2, 7, 20, 21), (1, 12, 10, 32), (1, 3, 4, 196), (1, 6, 8, 128)]
)
def test_cost_volume_backward_plain_matches_autograd_and_jax_vjp(shape, radius):
    rng = np.random.default_rng(radius)
    nd = (2 * radius + 1) ** 2
    f1, f2 = _rand(rng, shape), _rand(rng, shape)
    g = _rand(rng, shape[:3] + (nd,)) * np.linspace(0.2, 1.8, nd, dtype=np.float32)
    df1, df2 = cost_volume_backward_plain(*(torch.from_numpy(a) for a in (g, f1, f2)), radius)
    t1, t2 = torch.from_numpy(f1).requires_grad_(), torch.from_numpy(f2).requires_grad_()
    a1, a2 = torch.autograd.grad(cost_volume(t1, t2, radius), (t1, t2), torch.from_numpy(g))
    _close(df1, a1.numpy())
    _close(df2, a2.numpy())
    _, vjp = jax.vjp(lambda a, b: cost_volume_xla(a, b, radius), jnp.asarray(f1), jnp.asarray(f2))
    j1, j2 = vjp(jnp.asarray(g))
    _close(df1, j1)
    _close(df2, j2)
    # the gradients are not symmetric in f1 and f2
    assert np.abs(df1.numpy() - cost_volume_backward_plain(
        torch.from_numpy(g), torch.from_numpy(f2), torch.from_numpy(f1), radius)[1].numpy()).max() > 1e-3


def _edge_flow(rng, n, h, w, amp):
    """Flow in +-amp that points off both edges in every corner block; the
    blocks leave the middle rows and columns alone (at 6x8 too)."""
    flow = _rand(rng, (n, h, w, 2), -amp, amp)
    k = min(4, (h - 1) // 2, (w - 1) // 2)
    flow[:, :k, :k] = -0.6 * amp
    flow[:, :k, -k:] = (0.6 * amp, -0.6 * amp)
    flow[:, -k:, :k] = (-0.6 * amp, 0.6 * amp)
    flow[:, -k:, -k:] = 0.6 * amp
    return flow


# The last two are the trainer's coarse warp levels, where a source pixel's
# window of contributors covers the whole image and many taps clamp onto the
# border.
@pytest.mark.parametrize("amp", [3.0, 12.0])
@pytest.mark.parametrize(
    "shape", [(2, 13, 17, 3), (2, 9, 20, 21), (1, 12, 10, 32), (1, 6, 8, 128), (1, 12, 16, 96)]
)
def test_bilinear_warp_backward_plain_matches_autograd_and_jax_vjp(shape, amp):
    rng = np.random.default_rng(shape[3])
    n, h, w, _ = shape
    img, g = _rand(rng, shape), _rand(rng, shape)
    flow = _edge_flow(rng, n, h, w, amp)
    dimg, dflow = bilinear_warp_backward_plain(*(torch.from_numpy(a) for a in (g, img, flow)))
    ti, tf = torch.from_numpy(img).requires_grad_(), torch.from_numpy(flow).requires_grad_()
    ai, af = torch.autograd.grad(bilinear_warp(ti, tf), (ti, tf), torch.from_numpy(g))
    _close(dimg, ai.numpy())
    _close(dflow, af.numpy(), atol=1e-5 * max(1.0, float(af.abs().max())))
    _, vjp = jax.vjp(bilinear_warp_xla, jnp.asarray(img), jnp.asarray(flow))
    ji, jf = vjp(jnp.asarray(g))
    _close(dimg, ji)
    _close(dflow, jf, atol=1e-5 * max(1.0, float(np.abs(np.asarray(jf)).max())))
    assert float(dflow.abs().max()) > 0.1


def test_bilinear_warp_backward_plain_taps_clamped_onto_one_pixel_give_no_flow_gradient():
    """Far outside the image both taps of an axis clamp onto the border
    pixel, their difference is zero, and so is that component's gradient."""
    rng = np.random.default_rng(0)
    img, g = _rand(rng, (1, 6, 8, 4)), _rand(rng, (1, 6, 8, 4))
    flow = np.zeros((1, 6, 8, 2), np.float32)
    flow[..., 0] = 20.5  # every x tap beyond the right edge
    _, dflow = bilinear_warp_backward_plain(*(torch.from_numpy(a) for a in (g, img, flow)))
    assert float(dflow[..., 0].abs().max()) == 0.0
    assert float(dflow[0, :-1, :, 1].abs().min()) > 0.0  # rows y and y+1 differ
    assert float(dflow[0, -1, :, 1].abs().max()) == 0.0  # but not in the last row: y+1 clamps onto y
    flow[..., 0] = 0.5
    _, dflow = bilinear_warp_backward_plain(*(torch.from_numpy(a) for a in (g, img, flow)))
    assert float(dflow[..., 0].abs().max()) > 0.0


def test_cpu_tensors_that_require_a_gradient_go_through_autograd_not_a_kernel():
    reset_launches()
    f1 = torch.randn(1, 5, 6, 4, requires_grad=True)
    flow = torch.zeros(1, 5, 6, 2, requires_grad=True)
    out = cost_volume(bilinear_warp(f1, flow), f1, 2)
    out.sum().backward()
    assert f1.grad is not None and flow.grad is not None
    assert all(k.launches == 0 for k in (*KERNELS.values(), *KERNELS_BWD.values()))
    assert set(KERNELS_BWD) == {"cost_volume_bwd", "bilinear_warp_bwd"} and not set(KERNELS) & set(KERNELS_BWD)


def test_backward_wrappers_run_the_plain_versions_on_cpu_tensors_and_raise_elsewhere():
    from vstab_torch.kernels import bilinear_warp_backward, cost_volume_backward

    rng = np.random.default_rng(0)
    f1, f2, g = (torch.from_numpy(_rand(rng, s)) for s in ((1, 5, 6, 4), (1, 5, 6, 4), (1, 5, 6, 25)))
    flow = torch.from_numpy(_rand(rng, (1, 5, 6, 2), -3, 3))
    reset_launches()
    df1, df2 = cost_volume_backward(g, f1, f2, 2)
    want = cost_volume_backward_plain(g, f1, f2, 2)
    assert torch.equal(df1, want[0]) and torch.equal(df2, want[1])
    assert cost_volume_backward(g, f1, f2, 2, need=(False, True))[0] is None
    dimg, dflow = bilinear_warp_backward(f2, f1, flow, max_disp=1)  # on the CPU nothing is clipped
    want = bilinear_warp_backward_plain(f2, f1, flow)
    assert torch.equal(dimg, want[0]) and torch.equal(dflow, want[1])
    assert bilinear_warp_backward(f2, f1, flow, need=(True, False))[1] is None
    assert all(k.launches == 0 for k in KERNELS_BWD.values())
    meta = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError):
        cost_volume_backward(torch.empty((1, 4, 4, 9), device="meta"), meta, meta, 1)
    with pytest.raises(ValueError):
        bilinear_warp_backward(meta, meta, meta)


def _imports(path):
    """(module, inside a function?) for every absolute import of a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in inside) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in inside


def test_port_imports_no_jax_flax_msgpack_or_vstab():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vstab_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    rels = {os.path.relpath(p, REPO).replace(os.sep, "/") for p in files}
    assert {"vstab_torch/flow/train.py", "vstab_torch/eval/metrics.py", "vstab_torch/eval/deepstab.py"} <= rels
    assert {f"vstab_torch/dist/{n}.py" for n in ("__init__", "mesh", "init", "halo", "schur_dist", "pipeline_dist")} <= rels
    banned = {"jax", "jaxlib", "flax", "optax", "msgpack", "vstab"}
    # OpenCV only where video files are read and written and where the eval
    # harness tracks features, and only inside functions: importing the
    # package must not need it.
    cv2_ok = {"vstab_torch/io/video.py", "vstab_torch/pipeline_blocked.py", "vstab_torch/eval/metrics.py",
              "vstab_torch/eval/deepstab.py"}
    bad = []
    for p in files:
        rel = os.path.relpath(p, REPO).replace(os.sep, "/")
        for m, in_function in _imports(p):
            top = m.split(".")[0]
            if top in banned or (top == "cv2" and not (rel in cv2_ok and in_function)):
                bad.append((rel, m))
    assert not bad, bad


@pytest.mark.parametrize("shape,dpad", [((5, 12, 17, 3), 4), ((3, 8, 9, 1), 17), ((2, 6, 7, 3), 1)])
def test_roll_and_wrap_pad_is_the_per_frame_roll_bit_for_bit(shape, dpad):
    """The device-side gather against a roll of every frame by its own shift
    followed by a wrap-pad of the columns: pure data movement, so equal."""
    from vstab_torch.kernels.warp1d import _roll_and_wrap_pad

    rng = np.random.default_rng(dpad)
    n, h, w, _ = shape
    frames = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    mu = torch.from_numpy(rng.integers(-3 * w, 3 * w, size=n).astype(np.float32))
    mv = torch.from_numpy(rng.integers(-3 * h, 3 * h, size=n).astype(np.float32))
    rolled = torch.stack([
        torch.roll(f, shifts=(-int(sy), -int(sx)), dims=(0, 1)) for f, sy, sx in zip(frames, mv, mu)
    ])
    want = rolled.index_select(2, torch.arange(-dpad, w + dpad) % w)
    got = _roll_and_wrap_pad(frames, mu, mv, dpad)
    assert got.shape == (n, h, w + 2 * dpad, shape[3])
    assert torch.equal(got, want)
