"""PWC-Net assembly, the port of `vstab/flow/pwcnet.py`.

Coarse-to-fine flow over the feature pyramid. At every level the flow is in
pixels of that level (upsampling doubles grid and values); the output is
upsampled x2**output_level to the input resolution with bilinear,
half-pixel (`align_corners=False`) sampling, as `jax.image.resize` does.

The feature warp and the cost volume go through `vstab_torch.kernels`: the
CUDA kernels for CUDA tensors, the plain versions for CPU tensors. `forward`
is differentiable on both: on CUDA the two wrappers route through their
`torch.autograd.Function`s (backward kernels of the same sources), on the
CPU autograd differentiates the plain versions. `estimate_flow*` run without a graph.

`params` everywhere is the port's state dict (`vstab_torch.utils.
checkpoint.params_from_jax`, or `PWCNet(cfg).state_dict()`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vstab_torch.core.config import FlowConfig
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.flow.context import ContextNet
from vstab_torch.flow.encoder import FeaturePyramid
from vstab_torch.flow.estimator import FlowEstimator, UpBlock
from vstab_torch.flow.layers import Conv, ConvTranspose, leaky
from vstab_torch.kernels import bilinear_warp, cost_volume

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: FlowConfig) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


class PWCNet(nn.Module):
    """forward(im1, im2, feats=None) -> {'flow': [N,H,W,2] f32,
    'flow_pyramid': per-level flows, coarsest first}. H and W must be
    divisible by 2**len(pyramid_channels); `estimate_flow` pads."""

    def __init__(self, cfg: FlowConfig = FlowConfig(), device: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        pc = cfg.pyramid_channels
        nd = (2 * cfg.search_radius + 1) ** 2
        self.pyramid = FeaturePyramid(pc, dtype=dtype, device=device)
        feat_ch = None
        for idx in self.levels():
            cin = nd + pc[idx]
            if feat_ch is not None:
                self.add_module(f"up{idx}", UpBlock(feat_ch, dtype=dtype, device=device))
                cin += 4
            est = FlowEstimator(cin, cfg.estimator_channels, dtype=dtype, device=device)
            self.add_module(f"estimator{idx}", est)
            feat_ch = est.out_channels
        self.context = ContextNet(feat_ch + 2, cfg.context_dilations, dtype=dtype, device=device)

    def levels(self):
        """Pyramid indices estimated, coarsest first (index = level - 1)."""
        return range(len(self.cfg.pyramid_channels) - 1, self.cfg.output_level - 2, -1)

    def forward(
        self, im1: torch.Tensor, im2: torch.Tensor,
        feats: Optional[Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]] = None,
    ) -> Dict[str, object]:
        pin_full_f32()
        cfg, dtype = self.cfg, self.dtype
        if feats is None:
            feats1, feats2 = self.pyramid(im1), self.pyramid(im2)
        else:
            feats1, feats2 = feats
        flows = []
        flow = feat = upflow = None
        for idx in self.levels():
            f1, f2 = feats1[idx], feats2[idx]
            if flow is None:
                f2w = f2
                up_inputs = []
            else:
                upflow, upfeat = getattr(self, f"up{idx}")(flow, feat)
                upflow = 2.0 * upflow  # level change doubles pixel units
                f2w = bilinear_warp(
                    f2.contiguous(), upflow.to(f2.dtype).contiguous(),
                    max_disp=cfg.warp_max_disp,
                )
                up_inputs = [upflow.to(dtype), upfeat]
            cv = cost_volume(
                f1.to(dtype).contiguous(), f2w.to(dtype).contiguous(),
                radius=cfg.search_radius,
            )
            cv = leaky(cv.to(dtype))
            inp = torch.cat([cv, f1.to(dtype)] + up_inputs, dim=-1)
            flow_l, feat = getattr(self, f"estimator{idx}")(inp)
            if flow is not None:
                flow_l = flow_l + upflow
            flow = flow_l
            flows.append(flow)

        flow = self.context(feat, flow)
        flows[-1] = flow
        scale = 2 ** cfg.output_level
        n, h, w, _ = flow.shape
        full = F.interpolate(
            flow.permute(0, 3, 1, 2), size=(h * scale, w * scale),
            mode="bilinear", align_corners=False,
        ).permute(0, 2, 3, 1) * float(scale)
        return {"flow": full.float(), "flow_pyramid": tuple(flows)}


def build_net(params: Mapping[str, torch.Tensor], cfg: FlowConfig) -> PWCNet:
    """A PWCNet whose parameters are the tensors of `params` (no copy)."""
    net = PWCNet(cfg, device="meta")
    net.load_state_dict(params, strict=True, assign=True)
    return net.eval()


def init_params(
    seed: Union[int, torch.Generator], cfg: FlowConfig, device=None
) -> Dict[str, torch.Tensor]:
    """A fresh state dict of `PWCNet(cfg)` on `device` (CUDA unless told
    otherwise): flax's default initialisers, drawn layer by layer from
    `seed`, an integer or a `torch.Generator` that lies on the device. The
    numbers are torch's, not those of the JAX package's `init_params`."""
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=dev).manual_seed(seed)
    net = PWCNet(cfg, device="meta").to_empty(device=dev)
    for m in net.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.reset_parameters(gen)
    return {k: v.detach() for k, v in net.state_dict().items()}


def pad_to_multiple(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pad H, W (axes 1, 2) of [N,H,W,C] up to a multiple of `mult`."""
    h, w = x.shape[1], x.shape[2]
    ph = (-h) % mult
    pw = (-w) % mult
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
        x = x.permute(0, 2, 3, 1).contiguous()
    return x, (ph, pw)


@torch.no_grad()
def estimate_flow(params, im1: torch.Tensor, im2: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """Flow for a batch of frame pairs, any H/W: [N,H,W,3]x2 -> [N,H,W,2]."""
    mult = 2 ** len(cfg.pyramid_channels)
    h, w = im1.shape[1], im1.shape[2]
    im1p, _ = pad_to_multiple(im1, mult)
    im2p, _ = pad_to_multiple(im2, mult)
    return build_net(params, cfg)(im1p, im2p)["flow"][:, :h, :w]


@torch.no_grad()
def estimate_flow_pairs(params, frames: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """Consecutive-pair flow over a clip, [T,H,W,3] -> [T-1,H,W,2]: each
    frame is encoded once and its pyramid is shared by the two pairs it
    belongs to."""
    net = build_net(params, cfg)
    mult = 2 ** len(cfg.pyramid_channels)
    h, w = frames.shape[1], frames.shape[2]
    fp, _ = pad_to_multiple(frames, mult)
    feats = net.pyramid(fp)
    feats1 = tuple(f[:-1] for f in feats)
    feats2 = tuple(f[1:] for f in feats)
    out = net(fp[:-1], fp[1:], feats=(feats1, feats2))
    return out["flow"][:, :h, :w]


__all__ = [
    "PWCNet",
    "build_net",
    "compute_dtype",
    "estimate_flow",
    "estimate_flow_pairs",
    "init_params",
    "pad_to_multiple",
]
