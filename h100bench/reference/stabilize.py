"""The stabilizer written out plainly: pair flow -> vertex paths -> their
smoothed solution -> dense warp -> two-pass render with the adaptive
displacement bucket -> fixed crop.

Sparse least squares over a GH x GW vertex grid (the configuration's
`smooth` group): data, temporal smoothness, acceleration and spatial
rigidity terms; the normal equations split into one pentadiagonal system in
time per eigenmode of the grid Laplacian, solved here densely in float64
(the program solves them in float32; the two differ by well under 1e-3 px at
48 and 256 frames). Everything else is float32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import pwcnet, warps

DISP_BUCKETS = (16, 24, 32, 48, 63, 127, 255)


def _pool_matrix(n: int, g: int) -> np.ndarray:
    """[g, n] row-normalised selector of the linspace partition of n into g cells."""
    edges = np.linspace(0, n, g + 1).astype(np.int64)
    m = np.zeros((g, n), np.float32)
    for i in range(g):
        m[i, edges[i] : edges[i + 1]] = 1.0 / max(edges[i + 1] - edges[i], 1)
    return m


def vertex_motion(flow: torch.Tensor, grid: Tuple[int, int], robust_iters: int) -> torch.Tensor:
    """[N,H,W,2] -> [N,GH,GW,2]: the flow pooled over each cell, re-weighted
    robust_iters times by Geman-McClure weights with a per-cell scale of 1.5
    times the mean absolute residual plus 0.25."""
    _, h, w, _ = flow.shape
    gh, gw = grid
    dev = flow.device
    by = torch.from_numpy(_pool_matrix(h, gh)).to(dev)
    bx = torch.from_numpy(_pool_matrix(w, gw)).to(dev)
    byb, bxb = (by > 0).float(), (bx > 0).float()

    def pool(f):
        return torch.einsum("xw,ngwc->ngxc", bx, torch.einsum("gh,nhwc->ngwc", by, f))

    def spread(cell):
        return torch.einsum("hg,ngwc->nhwc", byb.T, torch.einsum("wx,ngxc->ngwc", bxb.T, cell))

    est = pool(flow)
    for _ in range(robust_iters):
        r2 = ((flow - spread(est)) ** 2).sum(dim=-1, keepdim=True)
        c_pix = spread(1.5 * pool(torch.sqrt(r2)) + 0.25)
        wgt = c_pix**2 / (c_pix**2 + r2)
        est = pool(wgt * flow) / torch.clamp(pool(wgt), min=1e-6)
    return est


def _grid_laplacian_modes(gh: int, gw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    g = gh * gw
    lap = np.zeros((g, g), np.float64)
    for i in range(gh):
        for j in range(gw):
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ni, nj = i + di, j + dj
                if 0 <= ni < gh and 0 <= nj < gw:
                    lap[i * gw + j, i * gw + j] += 1.0
                    lap[i * gw + j, ni * gw + nj] -= 1.0
    mu, v = np.linalg.eigh(lap)
    return torch.from_numpy(v), torch.from_numpy(np.maximum(mu, 0.0))


def _temporal_operator(t: int, lam_s: float, lam_a: float) -> torch.Tensor:
    """lam_s D1^T D1 + lam_a D2^T D2 as a dense [T,T] float64 matrix."""
    d1 = torch.zeros(max(t - 1, 0), t, dtype=torch.float64)
    d2 = torch.zeros(max(t - 2, 0), t, dtype=torch.float64)
    for r in range(t - 1):
        d1[r, r], d1[r, r + 1] = -1.0, 1.0
    for r in range(t - 2):
        d2[r, r], d2[r, r + 1], d2[r, r + 2] = 1.0, -2.0, 1.0
    return lam_s * d1.T @ d1 + lam_a * d2.T @ d2


def smooth_profiles(c: torch.Tensor, s: Mapping) -> torch.Tensor:
    """Smoothed vertex paths P [T,GH,GW,2] of the paths C: the minimiser of
    lam_d |P-C|^2 + lam_s |D1 P|^2 + lam_a |D2 P|^2 + lam_r |L^(1/2) (P-C)|^2
    (+ damping |P|^2), solved per eigenmode of the grid Laplacian L."""
    t, gh, gw, _ = c.shape
    v, mu = _grid_laplacian_modes(gh, gw)
    alpha = s["lambda_data"] + s["lambda_rigid"] * mu  # [G]
    ctil = torch.einsum("ig,tic->gtc", v, c.double().cpu().reshape(t, gh * gw, 2))
    a = _temporal_operator(t, s["lambda_smooth"], s["lambda_accel"])[None] + (
        alpha[:, None, None] + s["damping"]
    ) * torch.eye(t, dtype=torch.float64)[None]
    ptil = torch.linalg.solve(a, alpha[:, None, None] * ctil)
    p = torch.einsum("ig,gtc->tic", v, ptil).reshape(t, gh, gw, 2)
    return p.float().to(c.device)


def _resize_mean_weights(g: int, n: int) -> torch.Tensor:
    """[g] mean over the n outputs of each control point's weight in a
    bilinear (half-pixel) resize from g points to n samples."""
    eye = torch.eye(g, dtype=torch.float64)[None]
    return F.interpolate(eye, size=n, mode="linear", align_corners=False)[0].mean(dim=1)


def residual_bound(disp: torch.Tensor, h: int, w: int) -> float:
    """max over frames and vertices of |disp - its pixel mean| (px): the
    extremes of a bilinear up-sampling sit at its control points."""
    d = disp.double().cpu()
    _, gh, gw, _ = d.shape
    mean = torch.einsum("g,q,tgqc->tc", _resize_mean_weights(gh, h), _resize_mean_weights(gw, w), d)
    return float((d - mean[:, None, None, :]).abs().amax())


def bucket(bound: float, r: Mapping) -> int:
    """The smallest displacement bucket covering the bound + 0.5 px, floored at
    max_residual_disp and capped at max_disp_limit."""
    need = max(int(np.ceil(bound + 0.5)), r["max_residual_disp"])
    limit = min(r["max_disp_limit"], DISP_BUCKETS[-1])
    return next((min(b, limit) for b in DISP_BUCKETS if b >= need), limit)


def _tent(n: int, scale: float, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    ctr = (n - 1) / 2.0
    src = torch.clamp(ctr + scale * (i - ctr), 0.0, n - 1.0)
    return torch.clamp(1.0 - torch.abs(src[:, None] - i[None, :]), min=0.0)


def _zoom(img: torch.Tensor, scale: float) -> torch.Tensor:
    _, h, w, _ = img.shape
    tmp = torch.einsum("yr,trwc->tywc", _tent(h, scale, img.device), img)
    return torch.einsum("xq,tyqc->tyxc", _tent(w, scale, img.device), tmp)


def render(frames: torch.Tensor, disp: torch.Tensor, d: int, r: Mapping) -> torch.Tensor:
    """Frames [T,H,W,3] warped by the dense flow of their vertex
    displacements, masked where the warp is not exact, zoomed about the
    centre by fixed_crop_ratio and masked again (border_value outside)."""
    if r["crop_mode"] != "fixed":
        raise ValueError("the reference renders the configuration's fixed crop only")
    _, h, w, _ = frames.shape
    flow = F.interpolate(disp.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    warped = warps.warp_twopass(frames.float(), flow, d)
    mask = warps.twopass_validity((h, w), flow, d)[..., None]
    out = _zoom(warped, r["fixed_crop_ratio"])
    valid = (_zoom(mask, r["fixed_crop_ratio"]) > 0.999).float()
    return out * valid + r["border_value"] * (1.0 - valid)


def solve(frames: torch.Tensor, params: Dict[str, torch.Tensor], cfg: Mapping,
          policy: str = "f32") -> Dict[str, object]:
    """Everything before the render: {'profiles' C, 'disp' C - P, 'bucket'}."""
    t, h, w, _ = frames.shape
    s = cfg["smooth"]
    m = torch.cat([
        vertex_motion(fl, tuple(s["grid_size"]), s["robust_iters"])
        for fl in pwcnet.pair_flow_blocks(params, frames, cfg["flow"], policy)
    ])
    c = torch.cat([torch.zeros_like(m[:1]), torch.cumsum(m, dim=0)], dim=0)
    disp = c - smooth_profiles(c, s)
    return {"profiles": c, "disp": disp, "bucket": bucket(residual_bound(disp, h, w), cfg["render"])}


def render_blocks(frames, solved: Mapping, cfg: Mapping, device, block: int = 16
                  ) -> Iterator[Tuple[int, torch.Tensor]]:
    """(start, rendered frames [<=block,H,W,3]) over the clip, a block at a
    time; `frames` may be on the host (uint8 ones are scaled by 1/255)."""
    t = frames.shape[0]
    for s in range(0, t, block):
        blk = pwcnet.unit(torch.as_tensor(frames[s : s + block]).to(device))
        yield s, render(blk, solved["disp"][s : s + block], solved["bucket"], cfg["render"])
