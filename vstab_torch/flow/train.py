"""Flow-network training, the port of `vstab/flow/train.py`.

Two loss modes:

  * supervised: multi-scale endpoint error against ground-truth flow,
    PWC-Net's objective, with the paper's level weights; the ground truth is
    resized (antialiased, as `jax.image.resize` shrinks) and rescaled to each
    level. Synthetic warped-scene pairs provide the labels.
  * photometric: Charbonnier loss on im1 against warp(im2, flow) plus
    edge-aware first-order smoothness, at the finest estimated level.

On a CUDA device the network's forward goes through the hand-written cost
volume and feature warp kernels and its backward through their backward
kernels (`vstab_torch.kernels`); on the CPU autograd differentiates the plain
versions. The optimizer is optax's `clip_by_global_norm` then `adamw` in
torch: `ClippedAdamW`. Training computes in f32 with TF32 off unless the
config asks for bf16.

Random numbers: a `torch.Generator` cannot reproduce `jax.random`'s streams,
so every batch maker is split in two: `_draw_*` takes the generator and
returns the named draws, and `_*_from_draws` does everything else
deterministically (and is what the tests hold against the JAX package, fed
with draws made by `jax.random`).

    python -m vstab_torch.flow.train --steps 4000 [--hw 192 256] [--device cuda]
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vstab_torch.core.config import FlowConfig
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.flow.pwcnet import PWCNet, build_net, estimate_flow, init_params
from vstab_torch.kernels import bilinear_warp
from vstab_torch.kernels.warp import UNBOUNDED

Batch = Dict[str, torch.Tensor]
Draws = Dict[str, Any]

# PWC-Net per-level loss weights, coarsest -> finest.
LEVEL_WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)


# ---------------------------------------------------------------------------
# Resizes, as jax.image.resize computes them
# ---------------------------------------------------------------------------


def _resize_linear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[N,H,W,C] -> [N,h,w,C] as `jax.image.resize(..., "linear")`: half-pixel
    centres, and a triangle kernel widened by the shrink factor (antialiased)
    when shrinking. `F.interpolate(mode="bilinear")` alone does not widen it."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
        antialias=True, align_corners=False,
    )
    return y.permute(0, 2, 3, 1)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (torch's `bicubic` uses a = -0.75)."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


@functools.lru_cache(maxsize=None)
def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of `jax.image.resize(..., "bicubic")` along one
    axis when enlarging: Keys' kernel at half-pixel centres, each output's
    weights renormalised to sum to one over the taps that lie inside the
    input (torch clamps the index instead)."""
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    wts = _keys_cubic(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :])
    return (wts / wts.sum(axis=1, keepdims=True)).astype(np.float32)


# Small constants live on the device and are uploaded once: an upload from
# pageable memory makes the host wait for the device, which a trainer that
# made them anew would do several times a step.
@functools.lru_cache(maxsize=None)
def _cubic_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_cubic_matrix(n_in, n_out)).to(device)


@functools.lru_cache(maxsize=None)
def _pair_on(x: float, y: float, device: torch.device) -> torch.Tensor:
    return torch.tensor([x, y], dtype=torch.float32, device=device)


def _resize_cubic(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[N,gh,gw,C] -> [N,h,w,C] as `jax.image.resize(..., "bicubic")` enlarges."""
    mh = _cubic_on(x.shape[1], hw[0], x.device)
    mw = _cubic_on(x.shape[2], hw[1], x.device)
    pin_full_f32()
    return torch.einsum("hi,niwc->nhwc", mh, torch.einsum("wj,nijc->niwc", mw, x))


def _warp_unclipped(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The unbounded bilinear warp (`bilinear_warp_xla` in the JAX package):
    on CUDA the kernel under a bound that clips nothing, on the CPU the plain
    version, which has no bound."""
    return bilinear_warp(img.contiguous(), flow.contiguous(), max_disp=UNBOUNDED)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _pool_flow_to(flow: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize ground-truth flow [N,H,W,2] to (h,w), rescaling the values by
    the resolution change (flow is in pixels of its own grid)."""
    _, h0, w0, _ = flow.shape
    h, w = hw
    return _resize_linear(flow, (h, w)) * _pair_on(w / w0, h / h0, flow.device)


def multiscale_epe(
    flow_pyramid: Sequence[torch.Tensor], gt_flow: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-scale L2 loss over the pyramid (coarsest first) + final EPE."""
    nlev = len(flow_pyramid)
    weights = LEVEL_WEIGHTS[-nlev:] if nlev <= len(LEVEL_WEIGHTS) else (
        (0.32,) * (nlev - len(LEVEL_WEIGHTS)) + LEVEL_WEIGHTS
    )
    total = 0.0
    for wgt, fl in zip(weights, flow_pyramid):
        gt_l = _pool_flow_to(gt_flow, (fl.shape[1], fl.shape[2]))
        err = torch.sum((fl.float() - gt_l) ** 2, dim=-1)
        total = total + wgt * torch.mean(torch.sqrt(err + 1e-8))
    fin = flow_pyramid[-1].float()
    gt_f = _pool_flow_to(gt_flow, (fin.shape[1], fin.shape[2]))
    epe = torch.mean(torch.sqrt(torch.sum((fin - gt_f) ** 2, -1) + 1e-8))
    return total, {"epe_finest": epe.detach()}


def _charbonnier(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.sqrt(x * x + eps * eps)


def photometric_loss(
    im1: torch.Tensor, im2: torch.Tensor, flow_pyramid: Sequence[torch.Tensor],
    cfg: FlowConfig, smooth_weight: float = 0.05,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-supervised: Charbonnier photometric + edge-aware smoothness, at
    the finest level (downsampled images). The warp is the unclipped one and
    carries the gradient to the flow."""
    fl = flow_pyramid[-1].float()
    _, h, w, _ = fl.shape
    im1_l = _resize_linear(im1, (h, w))
    im2_l = _resize_linear(im2, (h, w))
    warped = _warp_unclipped(im2_l, fl)
    photo = torch.mean(_charbonnier(im1_l - warped))

    dfx = fl[:, :, 1:] - fl[:, :, :-1]
    dfy = fl[:, 1:] - fl[:, :-1]
    dix = torch.mean(torch.abs(im1_l[:, :, 1:] - im1_l[:, :, :-1]), -1, keepdim=True)
    diy = torch.mean(torch.abs(im1_l[:, 1:] - im1_l[:, :-1]), -1, keepdim=True)
    sm = torch.mean(torch.abs(dfx) * torch.exp(-10.0 * dix)) + torch.mean(
        torch.abs(dfy) * torch.exp(-10.0 * diy)
    )
    return photo + smooth_weight * sm, {"photo": photo.detach(), "smooth": sm.detach()}


# ---------------------------------------------------------------------------
# Optimizer and step
# ---------------------------------------------------------------------------


class ClippedAdamW(torch.optim.AdamW):
    """optax's `chain(clip_by_global_norm(clip), adamw(lr, weight_decay))`:
    `step` first scales every gradient by `clip / max(norm, clip)` (torch's
    `clip_grad_norm_` divides by `norm + 1e-6`), then takes the AdamW step
    (betas 0.9 / 0.999, eps 1e-8, every parameter decayed, biases too).
    `grad_norm` holds the global norm before clipping, a tensor on the
    parameters' device; nothing is read back to the host."""

    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 4e-4, clip: float = 1.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.clip = clip
        self.grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self):
        grads = [p.grad for group in self.param_groups for p in group["params"] if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.grad_norm = norm
        torch._foreach_mul_(grads, self.clip / torch.clamp(norm, min=self.clip))
        return super().step()


def make_optimizer(
    params, lr: float = 1e-4, weight_decay: float = 4e-4, clip: float = 1.0
) -> ClippedAdamW:
    """Global-norm clip + AdamW over `params` (an iterable of parameters), one
    parameter group. A schedule is applied by the caller (`cosine_schedule`)."""
    return ClippedAdamW(params, lr=lr, weight_decay=weight_decay, clip=clip)


def cosine_decay(step: int, steps: int, alpha: float) -> float:
    """optax's `cosine_decay_schedule(1.0, steps, alpha)` at `step`."""
    t = min(step, steps) / steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha


def cosine_schedule(optimizer: torch.optim.Optimizer, steps: int, alpha: float):
    """The same as a scheduler: step it once after every optimizer step."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: cosine_decay(s, steps, alpha))


def make_loss(net: PWCNet, mode: str = "supervised") -> Callable[[Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """loss_fn(batch) -> (loss, aux) of `net` on a batch: dict with 'im1',
    'im2' [N,H,W,3] (+ 'flow' [N,H,W,2] if supervised)."""
    if mode not in ("supervised", "photometric"):
        raise ValueError(f"unknown training mode: {mode}")

    def loss_fn(batch: Batch):
        pyr = net(batch["im1"], batch["im2"])["flow_pyramid"]
        if mode == "supervised":
            # ground truth at input resolution; the finest level is H / 2**output_level
            return multiscale_epe(pyr, batch["flow"])
        return photometric_loss(batch["im1"], batch["im2"], pyr, net.cfg)

    return loss_fn


def make_train_step(
    net: PWCNet, optimizer: ClippedAdamW, mode: str = "supervised", scheduler=None
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics, which updates `net`'s parameters in
    place (and steps `scheduler`, if given, once after the optimizer).
    metrics: 'loss', 'grad_norm' (before clipping) and the loss's own
    entries, tensors on the device (nothing is read back)."""
    loss_fn = make_loss(net, mode)

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach(), "grad_norm": optimizer.grad_norm, **aux}

    return train_step


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _draw_synthetic(gen: torch.Generator, n: int) -> Draws:
    """The draws of `synthetic_batch`: a scene seed per sample and the coarse
    flow grid in +-1."""
    return {
        "scene_seeds": torch.randint(0, 2**31 - 1, (n,), generator=gen, device=gen.device),
        "coarse": _uniform(gen, (n, 4, 5, 2)),
    }


def _synthetic_from_draws(draws: Draws, h: int, w: int, max_disp: float = 8.0) -> Batch:
    from vstab_torch.eval.synthetic import checker_scene

    dev = draws["coarse"].device
    seeds = draws["scene_seeds"].tolist()
    im1 = torch.from_numpy(np.stack([checker_scene(h, w, seed=int(s)) for s in seeds])).to(dev)
    flow = _resize_cubic(max_disp * draws["coarse"], (h, w))
    return {"im1": im1, "im2": _warp_unclipped(im1, flow), "flow": flow}


@torch.no_grad()
def synthetic_batch(gen: torch.Generator, n: int, h: int, w: int, max_disp: float = 8.0) -> Batch:
    """Labeled training pairs from random smooth warps of procedural scenes:
    im2 = backward-warp(im1, flow_gt) with flow_gt a random low-frequency
    field, on the generator's device."""
    return _synthetic_from_draws(_draw_synthetic(gen, n), h, w, max_disp)


def make_scene_pool(
    n_scenes: int, h: int, w: int, seed: int = 0,
    kinds: Tuple[str, ...] = ("checker", "shapes"),
) -> np.ndarray:
    """[S,h,w,3] pool of procedural scenes, generated on the host once.
    `kinds` round-robins over the scene families of `eval/synthetic.py`;
    'perlin' is left out of the default so that it can serve as the family
    the trainer never saw."""
    from vstab_torch.eval.synthetic import make_scene

    return np.stack(
        [make_scene(kinds[i % len(kinds)], h, w, seed=seed * 1000 + i) for i in range(n_scenes)]
    )


def _draw_occluders(
    gen: torch.Generator, n: int, n_scenes: int, h: int, w: int, n_occ: int = 3
) -> List[Draws]:
    """Per occluder: texture index, centre, radii (pixels), motion in +-1 and
    the on-selector in [0,1)."""
    return [
        {
            "tex": torch.randint(0, n_scenes, (n,), generator=gen, device=gen.device),
            "cy": _uniform(gen, (n,), 0.15 * h, 0.85 * h),
            "cx": _uniform(gen, (n,), 0.15 * w, 0.85 * w),
            "ry": _uniform(gen, (n,), h / 7.0, h / 3.5),
            "rx": _uniform(gen, (n,), w / 7.0, w / 3.5),
            "move": _uniform(gen, (n, 2)),
            "on": _uniform(gen, (n,), 0.0, 1.0),
        }
        for _ in range(n_occ)
    ]


def _add_occluders(
    occ_draws: Sequence[Draws], im1: torch.Tensor, im2: torch.Tensor, flow: torch.Tensor,
    scenes: torch.Tensor, max_disp: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dynamic-scene augmentation: paste independently translating textured
    ellipses over a warped pair, with exact ground-truth flow.

    Under the batch convention im2(p) = im1(p + flow(p)), an occluder shows
    texture tex inside the ellipse E1 (centre c) in im1 and the same texture
    shifted by d inside E2 (centre c - d) in im2, so for p in E2 the flow is
    d exactly. Disoccluded background keeps the background label. Occluders
    are drawn in the same order in both frames, so overlaps stay consistent;
    each is active on about 60% of the samples."""
    n, h, w, _ = im1.shape
    dev = im1.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    for dr in occ_draws:
        tex = scenes[dr["tex"]]
        ry, rx = dr["ry"].view(n, 1, 1), dr["rx"].view(n, 1, 1)
        d = 0.75 * max_disp * dr["move"]
        on = (dr["on"] < 0.6).float().view(n, 1, 1)

        def ell(cy, cx):
            dy = (yy - cy.view(n, 1, 1)) / ry
            dx = (xx - cx.view(n, 1, 1)) / rx
            return ((dy * dy + dx * dx < 1.0).float() * on)[..., None]

        m1 = ell(dr["cy"], dr["cx"])
        m2 = ell(dr["cy"] - d[:, 1], dr["cx"] - d[:, 0])
        dfull = d[:, None, None, :].expand(n, h, w, 2)
        im1 = im1 * (1.0 - m1) + tex * m1
        im2 = im2 * (1.0 - m2) + _warp_unclipped(tex, dfull) * m2
        flow = flow * (1.0 - m2) + dfull * m2
    return im1, im2, flow


def _draw_sample(
    gen: torch.Generator, n_scenes: int, n: int, hw: Tuple[int, int], occluders: bool = True
) -> Draws:
    """The draws of `_sample_batch`: scene indices, blur selector (0..7),
    angle, scale, translation and coarse grid in +-1, the occluders' draws,
    gain and offset in +-1."""
    dev = gen.device
    return {
        "idx": torch.randint(0, n_scenes, (n,), generator=gen, device=dev),
        "blur": torch.randint(0, 8, (n,), generator=gen, device=dev),
        "angle": _uniform(gen, (n,)),
        "scale": _uniform(gen, (n,)),
        "txy": _uniform(gen, (n, 2)),
        "coarse": _uniform(gen, (n, 4, 5, 2)),
        "occluders": _draw_occluders(gen, n, n_scenes, *hw) if occluders else [],
        "gain": _uniform(gen, (n, 1, 1, 1)),
        "offset": _uniform(gen, (n, 1, 1, 1)),
    }


def _blur3(x: torch.Tensor) -> torch.Tensor:
    x = 0.25 * torch.roll(x, 1, 1) + 0.5 * x + 0.25 * torch.roll(x, -1, 1)
    return 0.25 * torch.roll(x, 1, 2) + 0.5 * x + 0.25 * torch.roll(x, -1, 2)


def _batch_from_draws(
    scenes: torch.Tensor, draws: Draws, max_disp: float, blur: bool = True
) -> Batch:
    """Everything of `_sample_batch` but the random numbers: scene pick,
    blur blend, (global similarity + low-frequency) flow, the warp, the
    occluders of `draws["occluders"]`, and the photometric jitter of im1."""
    _, h, w, _ = scenes.shape
    dev = scenes.device
    n = draws["idx"].shape[0]
    im1 = scenes[draws["idx"]]

    # Random smoothness augmentation (training only): per sample one of four
    # progressively blurred copies, P(clean) = 5/8. Blurring the scene before
    # the warp leaves the ground-truth flow exact.
    if blur:
        levels = [im1]
        for _ in range(3):
            levels.append(_blur3(_blur3(levels[-1])))
        sel = torch.clamp(draws["blur"] - 4, min=0)
        im1 = torch.stack(levels, dim=0)[sel, torch.arange(n, device=dev)]

    ang = 0.02 * draws["angle"]
    sc = 1.0 + 0.02 * draws["scale"]
    txy = max_disp * draws["txy"]
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w) - (w - 1) / 2.0
    ca, sa = (sc * torch.cos(ang)).view(n, 1, 1), (sc * torch.sin(ang)).view(n, 1, 1)
    # displacement of the affine map (sc R - I) p + t at each pixel
    dx = (ca - 1.0) * xx - sa * yy
    dy = sa * xx + (ca - 1.0) * yy
    aff = torch.stack([dx + txy[:, 0].view(n, 1, 1), dy + txy[:, 1].view(n, 1, 1)], dim=-1)

    flow = aff + _resize_cubic(0.4 * max_disp * draws["coarse"], (h, w))
    im2 = _warp_unclipped(im1, flow)
    if draws["occluders"]:
        im1, im2, flow = _add_occluders(draws["occluders"], im1, im2, flow, scenes, max_disp)
    # photometric jitter on im1 only (robustness to brightness change)
    gain = 1.0 + 0.08 * draws["gain"]
    off = 0.04 * draws["offset"]
    return {"im1": torch.clamp(im1 * gain + off, 0.0, 1.0), "im2": im2, "flow": flow}


@torch.no_grad()
def _sample_batch(
    gen: torch.Generator, scenes: torch.Tensor, n: int, max_disp: float,
    blur: bool = True, occluders: bool = True,
) -> Batch:
    """A labeled batch made on the scenes' device: scene pick + (global
    affine o low-frequency) flow + independently moving occluders. The
    ground-truth flow mixes a global similarity (translation +-max_disp,
    rotation +-0.02 rad, scale +-2%) with a low-frequency residual field,
    which covers the inference regime (shake is a global affine per pair)."""
    s, h, w, _ = scenes.shape
    draws = _draw_sample(gen, s, n, (h, w), occluders)
    return _batch_from_draws(scenes, draws, max_disp, blur)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _trainable(params: Mapping[str, torch.Tensor], cfg: FlowConfig, dev: torch.device) -> PWCNet:
    """A PWCNet on `dev` over f32 copies of `params` (the caller's stay as they are)."""
    return build_net(
        {k: v.detach().to(dev, torch.float32, copy=True) for k, v in params.items()}, cfg
    ).train()


def _state(net: PWCNet) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in net.state_dict().items()}


def _save(ckpt_dir: str, steps: int, params: Mapping[str, torch.Tensor]) -> None:
    from vstab_torch.utils.checkpoint import params_to_jax, save_params

    os.makedirs(ckpt_dir, exist_ok=True)
    save_params(os.path.join(ckpt_dir, f"flow_{steps:06d}.msgpack"), params_to_jax(params))


def train_fast(
    cfg: FlowConfig,
    steps: int = 4000,
    batch_size: int = 8,
    hw: Tuple[int, int] = (192, 256),
    lr: float = 2e-4,
    seed: int = 0,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    scan_len: int = 100,
    n_scenes: int = 64,
    max_disp: float = 12.0,
    ckpt_dir: Optional[str] = "ckpts",
    mode: str = "supervised",
    kinds: Tuple[str, ...] = ("checker", "shapes"),
    device=None,
) -> Dict[str, torch.Tensor]:
    """The trainer: batches are made on the device from a scene pool that is
    uploaded once, and the metrics of `scan_len` steps are summed on the
    device and read back once for one log line (the JAX package scans
    `scan_len` steps in one dispatch; here it is a plain loop with no read
    inside a chunk). Cosine schedule to 2% of `lr`. Saves
    `flow_{steps:06d}.msgpack` in the JAX package's format and returns the
    state dict."""
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    pin_full_f32()
    h, w = hw
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_params(gen, cfg, dev)
    net = _trainable(params, cfg, dev)
    opt = make_optimizer(net.parameters(), lr)
    step = make_train_step(net, opt, mode, cosine_schedule(opt, steps, alpha=0.02))
    scenes = torch.from_numpy(make_scene_pool(n_scenes, h, w, seed=seed, kinds=kinds)).to(dev)

    done = 0
    while done < steps:
        chunk = min(scan_len, steps - done)
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(chunk):
            ms = step(_sample_batch(gen, scenes, batch_size, max_disp))
            for k, v in ms.items():
                sums[k] = v if k not in sums else sums[k] + v
        done += chunk
        m = {k: round(float(v) / chunk, 4) for k, v in sums.items()}  # the chunk's one read
        print(f"step {done}/{steps}: {m}", flush=True)

    out = _state(net)
    if ckpt_dir is not None:
        _save(ckpt_dir, steps, out)
    return out


def eval_epe(
    params: Mapping[str, torch.Tensor], cfg: FlowConfig, hw: Tuple[int, int] = (192, 256),
    n: int = 16, seed: int = 999, max_disp: float = 12.0,
    kinds: Tuple[str, ...] = ("checker", "shapes"),
    occluders: bool = False, device=None,
) -> float:
    """Held-out synthetic EPE at full input resolution, on clean (unblurred)
    scenes. kinds=('perlin',) is the cross-distribution gate: a family the
    trainer never saw. occluders=True measures the dynamic-scene regime.
    Batch i draws from a generator seeded by `seed` and i."""
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    scenes = torch.from_numpy(make_scene_pool(8, hw[0], hw[1], seed=seed, kinds=kinds)).to(dev)
    epes = []
    for i in range(-(-n // 8)):
        gen = torch.Generator(device=dev).manual_seed(seed * 65537 + i)
        batch = _sample_batch(gen, scenes, 8, max_disp, blur=False, occluders=occluders)
        fl = estimate_flow(params, batch["im1"], batch["im2"], cfg)
        err = torch.sqrt(torch.sum((fl - batch["flow"]) ** 2, -1) + 1e-12)
        epes.append(float(torch.mean(err)))
    return sum(epes) / len(epes)


def train(
    cfg: FlowConfig,
    steps: int = 1000,
    batch_size: int = 4,
    hw: Tuple[int, int] = (192, 256),
    lr: float = 1e-4,
    seed: int = 0,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    log_every: int = 50,
    ckpt_dir: Optional[str] = "ckpts",
    mode: str = "supervised",
    device=None,
) -> Dict[str, torch.Tensor]:
    """Single-device training loop on `synthetic_batch` pairs (a fresh
    checker scene per sample, made on the host), cosine schedule to 5%."""
    import logging

    from vstab_torch.pipeline import resolve_device

    log = logging.getLogger("vstab_torch.train")
    dev = resolve_device(device)
    pin_full_f32()
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_params(gen, cfg, dev)
    net = _trainable(params, cfg, dev)
    opt = make_optimizer(net.parameters(), lr)
    step_fn = make_train_step(net, opt, mode, cosine_schedule(opt, steps, alpha=0.05))
    h, w = hw
    for step in range(steps):
        metrics = step_fn(synthetic_batch(gen, batch_size, h, w))
        if step % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log.info("step %d: %s", step, m)
            print(f"step {step}: {m}", flush=True)
    out = _state(net)
    if ckpt_dir is not None:
        _save(ckpt_dir, steps, out)
    return out


def _main(argv=None) -> int:
    """python -m vstab_torch.flow.train --steps 4000 [--hw 192 256] ..."""
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="python -m vstab_torch.flow.train")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(192, 256))
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan-len", type=int, default=100)
    ap.add_argument("--max-disp", type=float, default=12.0)
    ap.add_argument(
        "--n-scenes", type=int, default=256,
        help="procedural scene pool size (too small -> the net memorizes it)",
    )
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--resume", default=None, help="msgpack to warm-start from")
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument(
        "--scenes", default="checker,shapes",
        help="comma-separated training scene families (eval/synthetic)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    from vstab_torch.utils.checkpoint import load_params, params_from_jax

    kinds = tuple(args.scenes.split(","))
    cfg = FlowConfig(compute_dtype=args.compute_dtype, kernel_impl="auto")
    params = params_from_jax(load_params(args.resume)) if args.resume else None
    params = train_fast(
        cfg, steps=args.steps, batch_size=args.batch, hw=tuple(args.hw),
        lr=args.lr, seed=args.seed, params=params, scan_len=args.scan_len,
        max_disp=args.max_disp, ckpt_dir=args.ckpt_dir, kinds=kinds,
        n_scenes=args.n_scenes, device=args.device,
    )
    for gate_kinds, label in ((kinds, "in-dist"), (("perlin",), "cross-dist")):
        epe = eval_epe(
            params, cfg, hw=tuple(args.hw), max_disp=args.max_disp,
            kinds=gate_kinds, device=args.device,
        )
        print(f"held-out EPE [{label}] @ {tuple(args.hw)}: {epe:.3f} px", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())


__all__ = [
    "LEVEL_WEIGHTS",
    "ClippedAdamW",
    "cosine_decay",
    "cosine_schedule",
    "eval_epe",
    "make_loss",
    "make_optimizer",
    "make_scene_pool",
    "make_train_step",
    "multiscale_epe",
    "photometric_loss",
    "synthetic_batch",
    "train",
    "train_fast",
]
