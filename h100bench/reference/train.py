"""The flow trainer written out plainly: the labelled batch from the
generator's draws, PWC-Net's multiscale endpoint-error loss, its gradient by
autograd through the plain network, and a global-norm clip followed by AdamW.

The batch: a scene from the pool, blurred with probability 3/8, warped by a
global similarity (rotation +-0.02 rad, scale +-2%, translation
+-max_disp) plus a low-frequency field (a 4x5 grid in +-0.4 max_disp,
enlarged by Keys' cubic, a = -0.5, half-pixel centres), three textured
ellipses that translate on their own (each on with probability 0.6) and a
gain and offset on the first image. The draws come from a torch.Generator
in the order the program's batch maker draws them, so one seed gives both
sides the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import pwcnet, warps

LEVEL_WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)
BETAS, EPS = (0.9, 0.999), 1e-8


def _uniform(gen: torch.Generator, shape, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def draw(gen: torch.Generator, n_scenes: int, n: int, hw: Tuple[int, int]) -> Dict:
    """One batch's random numbers, in the order they are drawn."""
    h, w = hw
    dev = gen.device
    d = {
        "idx": torch.randint(0, n_scenes, (n,), generator=gen, device=dev),
        "blur": torch.randint(0, 8, (n,), generator=gen, device=dev),
        "angle": _uniform(gen, (n,)),
        "scale": _uniform(gen, (n,)),
        "txy": _uniform(gen, (n, 2)),
        "coarse": _uniform(gen, (n, 4, 5, 2)),
    }
    d["occluders"] = [
        {
            "tex": torch.randint(0, n_scenes, (n,), generator=gen, device=dev),
            "cy": _uniform(gen, (n,), 0.15 * h, 0.85 * h),
            "cx": _uniform(gen, (n,), 0.15 * w, 0.85 * w),
            "ry": _uniform(gen, (n,), h / 7.0, h / 3.5),
            "rx": _uniform(gen, (n,), w / 7.0, w / 3.5),
            "move": _uniform(gen, (n, 2)),
            "on": _uniform(gen, (n,), 0.0, 1.0),
        }
        for _ in range(3)
    ]
    d["gain"] = _uniform(gen, (n, 1, 1, 1))
    d["offset"] = _uniform(gen, (n, 1, 1, 1))
    return d


def _keys_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] cubic enlargement weights (Keys, a = -0.5, half-pixel
    centres), each row renormalised over the taps inside the input."""
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x = np.abs(x[:, None] - np.arange(n_in, dtype=np.float64)[None, :])
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    wts = np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))
    return torch.from_numpy((wts / wts.sum(axis=1, keepdims=True)).astype(np.float32)).to(device)


def _enlarge(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    mh = _keys_matrix(x.shape[1], hw[0], x.device)
    mw = _keys_matrix(x.shape[2], hw[1], x.device)
    return torch.einsum("hi,niwc->nhwc", mh, torch.einsum("wj,nijc->niwc", mw, x))


def _blur3(x: torch.Tensor) -> torch.Tensor:
    x = 0.25 * torch.roll(x, 1, 1) + 0.5 * x + 0.25 * torch.roll(x, -1, 1)
    return 0.25 * torch.roll(x, 1, 2) + 0.5 * x + 0.25 * torch.roll(x, -1, 2)


def batch(scenes: torch.Tensor, d: Mapping, max_disp: float) -> Dict[str, torch.Tensor]:
    """{'im1', 'im2', 'flow'} from the pool and one batch's draws, with
    im2(p) = im1(p + flow(p)) outside the occluders."""
    _, h, w, _ = scenes.shape
    dev = scenes.device
    n = d["idx"].shape[0]
    im1 = scenes[d["idx"]]
    levels = [im1]
    for _ in range(3):
        levels.append(_blur3(_blur3(levels[-1])))
    im1 = torch.stack(levels)[torch.clamp(d["blur"] - 4, min=0), torch.arange(n, device=dev)]

    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w) - (w - 1) / 2.0
    ang, sc, txy = 0.02 * d["angle"], 1.0 + 0.02 * d["scale"], max_disp * d["txy"]
    ca, sa = (sc * torch.cos(ang)).view(n, 1, 1), (sc * torch.sin(ang)).view(n, 1, 1)
    aff = torch.stack([(ca - 1.0) * xx - sa * yy + txy[:, 0].view(n, 1, 1),
                       sa * xx + (ca - 1.0) * yy + txy[:, 1].view(n, 1, 1)], dim=-1)
    flow = aff + _enlarge(0.4 * max_disp * d["coarse"], (h, w))
    im2 = warps.bilinear_warp(im1, flow)

    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    for o in d["occluders"]:
        tex = scenes[o["tex"]]
        ry, rx = o["ry"].view(n, 1, 1), o["rx"].view(n, 1, 1)
        mv = 0.75 * max_disp * o["move"]
        on = (o["on"] < 0.6).float().view(n, 1, 1)

        def ellipse(cy, cx):
            e = ((ys - cy.view(n, 1, 1)) / ry) ** 2 + ((xs - cx.view(n, 1, 1)) / rx) ** 2
            return ((e < 1.0).float() * on)[..., None]

        m1 = ellipse(o["cy"], o["cx"])
        m2 = ellipse(o["cy"] - mv[:, 1], o["cx"] - mv[:, 0])
        shift = mv[:, None, None, :].expand(n, h, w, 2)
        im1 = im1 * (1.0 - m1) + tex * m1
        im2 = im2 * (1.0 - m2) + warps.bilinear_warp(tex, shift) * m2
        flow = flow * (1.0 - m2) + shift * m2
    im1 = torch.clamp(im1 * (1.0 + 0.08 * d["gain"]) + 0.04 * d["offset"], 0.0, 1.0)
    return {"im1": im1, "im2": im2, "flow": flow}


def _shrink(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize (half-pixel centres) of [N,H,W,C]."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                         antialias=True, align_corners=False).permute(0, 2, 3, 1)


def loss(params: Mapping[str, torch.Tensor], b: Mapping[str, torch.Tensor], cfg: Mapping,
         policy: str) -> torch.Tensor:
    """Multiscale endpoint error: per level the mean of sqrt(|flow - gt|^2 +
    1e-8), the ground truth resized to the level and rescaled, weighted
    0.32 / 0.08 / 0.02 / 0.01 / 0.005 from the coarsest."""
    n_levels = len(cfg["pyramid_channels"])
    f1 = pwcnet.pyramid(params, b["im1"], n_levels, policy)
    f2 = pwcnet.pyramid(params, b["im2"], n_levels, policy)
    flows = pwcnet.flow_pyramid(params, f1, f2, cfg, policy)
    gt = b["flow"]
    _, h0, w0, _ = gt.shape
    total = 0.0
    for wgt, fl in zip(LEVEL_WEIGHTS[-len(flows):], flows):
        h, w = fl.shape[1], fl.shape[2]
        gt_l = _shrink(gt, (h, w)) * torch.tensor([w / w0, h / h0], device=gt.device)
        total = total + wgt * torch.mean(torch.sqrt(torch.sum((fl - gt_l) ** 2, dim=-1) + 1e-8))
    return total


def cosine(step: int, steps: int, alpha: float) -> float:
    """The learning-rate factor at `step` of a cosine decay to `alpha` over `steps`."""
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps)) + alpha


class AdamW:
    """Global-norm clip, then AdamW (decoupled weight decay on every leaf)."""

    def __init__(self, params: Dict[str, torch.Tensor], recipe: Mapping):
        self.p = params
        self.r = recipe
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates the parameters; returns the clipped gradients."""
        r = self.r
        lr = r["lr"] * cosine(self.t, r["schedule_steps"], r["schedule_alpha"])
        self.t += 1
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        f = r["clip"] / torch.clamp(norm, min=r["clip"])
        clipped = {k: g * f for k, g in grads.items()}
        b1, b2 = BETAS
        for k, g in clipped.items():
            p = self.p[k]
            p.mul_(1.0 - lr * r["weight_decay"])
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1**self.t)
            v_hat = self.v[k] / (1.0 - b2**self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
        return clipped


def run(params0: Mapping[str, torch.Tensor], scenes: torch.Tensor, seed: int, cfg: Mapping,
        recipe: Mapping, steps: int, policy: str = "f32", loss_rows: int = None) -> Dict[str, object]:
    """`steps` steps from params0 on the batches of `seed`: {'batches',
    'losses', 'grad1' (the first step's clipped gradient by leaf),
    'params' (after the last step)}. `loss_rows` takes the loss over the
    first rows of each batch only (a fault, for the limits' readings)."""
    params = {k: v.detach().float().clone() for k, v in params0.items()}
    opt = AdamW(params, recipe)
    gen = torch.Generator(device=scenes.device).manual_seed(seed)
    out: Dict[str, List] = {"batches": [], "losses": []}
    n, hw = recipe["batch"], tuple(recipe["hw"])
    for i in range(steps):
        b = batch(scenes, draw(gen, scenes.shape[0], n, hw), recipe["max_disp"])
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        rows = {k: v[:loss_rows] for k, v in b.items()} if loss_rows else b
        value = loss(leaves, rows, cfg, policy)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        clipped = opt.step(grads)
        if i == 0:
            out["grad1"] = clipped
        out["batches"].append(b)
        out["losses"].append(float(value.detach()))
    out["params"] = params
    return out
