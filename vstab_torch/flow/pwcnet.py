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
checkpoint.params_from_jax`, or `PWCNet(cfg).state_dict()`), or `prepare`'s
aligned layout of it: every estimator's input and the context network's
padded with zero channels to a multiple of `ALIGN`, each weight given the
matching zero columns. cuDNN's NHWC tensor-core convolutions copy a bf16
input whose channels are not a multiple of 8 into a padded buffer before
every call (`nhwcAddPaddingKernel`); the dense stacks (117 to 725 channels
at the published widths) then reach them as they are. The zero channels'
products are exact zeros. `build_net` takes either layout, by the widths of
the tensors it is given.
"""

from __future__ import annotations

import functools
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
ALIGN = 8  # channels a bf16 NHWC input of cuDNN's tensor-core convolutions takes as it is


def compute_dtype(cfg: FlowConfig) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


def _levels(cfg: FlowConfig) -> range:
    return range(len(cfg.pyramid_channels) - 1, cfg.output_level - 2, -1)


def _layout(cfg: FlowConfig, align: int) -> Tuple[Dict[int, Tuple[int, int]], Tuple[int, int]]:
    """The inputs' widths: {pyramid index: (channels, zero channels that
    follow them)} of each estimator, coarsest first, and the same pair for
    the context network. The zeros bring each input to a multiple of
    `align` (none where `align` is 1, the published layout)."""
    nd = (2 * cfg.search_radius + 1) ** 2
    ests, feat = {}, None
    for idx in _levels(cfg):
        cin = nd + cfg.pyramid_channels[idx] + (0 if feat is None else 4)
        ests[idx] = (cin, (-cin) % align)
        feat = sum(ests[idx]) + sum(cfg.estimator_channels)
    return ests, (feat + 2, (-(feat + 2)) % align)


class PWCNet(nn.Module):
    """forward(im1, im2, feats=None) -> {'flow': [N,H,W,2] f32,
    'flow_pyramid': per-level flows, coarsest first}. H and W must be
    divisible by 2**len(pyramid_channels); `estimate_flow` pads.

    With `align` > 1 the net takes `prepare`'s layout: each estimator's
    input [cost volume, f1, upflow, upfeat] ends in `pads[idx]` zero
    channels that bring it to a multiple of `align`, and the context
    network's input [feat, flow] in `context.pad` more."""

    def __init__(self, cfg: FlowConfig = FlowConfig(), device: Optional[str] = None, align: int = 1):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        self.pyramid = FeaturePyramid(cfg.pyramid_channels, dtype=dtype, device=device)
        ests, (ctx_in, ctx_pad) = _layout(cfg, align)
        self.pads = {idx: pad for idx, (_, pad) in ests.items()}
        feat_ch = None
        for idx, (cin, pad) in ests.items():
            if feat_ch is not None:
                self.add_module(f"up{idx}", UpBlock(feat_ch, dtype=dtype, device=device))
            est = FlowEstimator(cin + pad, cfg.estimator_channels, dtype=dtype, device=device)
            self.add_module(f"estimator{idx}", est)
            feat_ch = est.out_channels
        self.context = ContextNet(ctx_in, cfg.context_dilations, dtype=dtype, device=device, pad=ctx_pad)

    def levels(self):
        """Pyramid indices estimated, coarsest first (index = level - 1)."""
        return _levels(self.cfg)

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
            parts = [cv, f1.to(dtype)] + up_inputs
            if self.pads[idx]:
                parts.append(cv.new_zeros((*cv.shape[:-1], self.pads[idx])))
            inp = torch.cat(parts, dim=-1)
            flow, feat = getattr(self, f"estimator{idx}")(inp, upflow)
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


def _align(params: Mapping[str, torch.Tensor]) -> int:
    """The `align` of `params`' layout, read from the widths of the
    estimators' and the context network's first convolutions: all are
    multiples of ALIGN in `prepare`'s layout. Where the published widths
    are too, both layouts are one."""
    widths = [v.shape[1] for k, v in params.items() if k.endswith("conv0.weight")]
    return ALIGN if all(w % ALIGN == 0 for w in widths) else 1


def build_net(params: Mapping[str, torch.Tensor], cfg: FlowConfig) -> PWCNet:
    """A PWCNet whose parameters are the tensors of `params` (no copy), in
    the published layout or in `prepare`'s, as their widths say."""
    net = PWCNet(cfg, device="meta", align=_align(params))
    net.load_state_dict(params, strict=True, assign=True)
    return net.eval()


def aligned_pad(params: Mapping[str, torch.Tensor], cfg: FlowConfig) -> int:
    """Zero channels `params`' layout adds to the estimators' and the
    context network's inputs: 0 in the published layout."""
    ests, (_, ctx_pad) = _layout(cfg, _align(params))
    return sum(pad for _, pad in ests.values()) + ctx_pad


@functools.lru_cache(maxsize=16)
def _compute_dtype_layers(cfg: FlowConfig) -> Tuple[str, ...]:
    """Names of the convolutions that compute in the net's compute dtype
    (all but the f32 heads and `upflow`)."""
    net = PWCNet(cfg, device="meta")
    return tuple(name for name, m in net.named_modules()
                 if isinstance(m, (Conv, ConvTranspose)) and m.dtype == net.dtype)


def _widen(w: torch.Tensor, dim: int, at: int, n: int) -> torch.Tensor:
    """`w` with `n` zero slices inserted along `dim` before index `at`."""
    if not n:
        return w
    zeros = w.new_zeros((*w.shape[:dim], n, *w.shape[dim + 1 :]))
    return torch.cat([w.narrow(dim, 0, at), zeros, w.narrow(dim, at, w.shape[dim] - at)], dim)


def aligned_params(params: Mapping[str, torch.Tensor], cfg: FlowConfig) -> Dict[str, torch.Tensor]:
    """`params` (published layout) in `PWCNet(cfg, align=ALIGN)`'s layout,
    each tensor in its dtype: every weight that reads a zero channel gets a
    zero column there (each estimator's convolutions and `predict_flow` at
    the end of their input, the next level's `upfeat` at the end of its
    rows, the context's `dconv0` after the stack and after the flow)."""
    ests, (_, ctx_pad) = _layout(cfg, ALIGN)
    out = dict(params)
    pad = 0  # zero channels at the end of the previous level's stack
    for idx, (_, est_pad) in ests.items():
        if pad:
            k = f"up{idx}.upfeat.weight"
            out[k] = _widen(out[k], 0, out[k].shape[0], pad)
        pad = est_pad
        for name in [f"conv{i}" for i in range(len(cfg.estimator_channels))] + ["predict_flow"]:
            k = f"estimator{idx}.{name}.weight"
            out[k] = _widen(out[k], 1, out[k].shape[1], pad)
    k = "context.dconv0.weight"
    feat = out[k].shape[1] - 2  # the published [feat, flow] columns
    out[k] = _widen(_widen(out[k], 1, feat, pad), 1, feat + pad + 2, ctx_pad)
    return out


def prepare(params: Mapping[str, torch.Tensor], cfg: FlowConfig) -> Dict[str, torch.Tensor]:
    """The state dict as the forward pass takes it, made once per call of
    `clip_flow`. For a bf16 net where autograd records no graph (cuDNN's
    NHWC tensor-core route): `aligned_params`, with the bf16 layers'
    weights and biases cast once to bf16, the weights in channels-last
    memory, as `Conv` would cast them on every call. Anything else:
    `params` as given. The input is not modified."""
    if compute_dtype(cfg) != torch.bfloat16 or torch.is_grad_enabled():
        return dict(params)
    out = aligned_params(params, cfg)
    for name in _compute_dtype_layers(cfg):
        out[name + ".weight"] = out[name + ".weight"].to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        out[name + ".bias"] = out[name + ".bias"].to(torch.bfloat16)
    return out


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
    "ALIGN",
    "PWCNet",
    "aligned_pad",
    "aligned_params",
    "build_net",
    "compute_dtype",
    "estimate_flow",
    "estimate_flow_pairs",
    "init_params",
    "pad_to_multiple",
    "prepare",
]
