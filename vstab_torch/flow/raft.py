"""RAFT, the port's second flow network (Teed & Deng, "RAFT: Recurrent
All-Pairs Field Transforms for Optical Flow", ECCV 2020, arXiv 2003.12039;
princeton-vl/RAFT `core/raft.py`, `extractor.py`, `corr.py`, `update.py`),
the "large" model.

Two `BasicEncoder`s (`fnet`: instance norm, 256 features; `cnet`: batch norm
in eval mode, 128 hidden + 128 context channels) at 1/8 resolution; the
all-pairs correlation of the two frames' features, pooled into a 4-level
pyramid; `iters` recurrent updates, each a pyramid lookup around the current
coordinates (`vstab_torch.kernels.corr_lookup`), the motion encoder, a
separable ConvGRU and the flow head; convex upsampling x8 with a learned
3x3 mask.

The state dict has RAFT's own names and shapes (its module tree without the
`module.` prefix of its checkpoints), so a published checkpoint loads
without a converter. Precision follows RAFT's `--mixed_precision`: the
encoders and the update block (motion encoder, GRU, flow head, mask head) in
the compute dtype with float32 parameters; the correlation, its pyramid, the
lookup, the coordinates and the convex upsampling in float32; TF32 off. On
the card the correlation of bfloat16 features is one bf16 product with
float32 sums and a float32 volume (`corr_gemm`).

One departure from the published code: in `test_mode` RAFT upsamples after
every iteration and returns only the last result, so here the mask head and
the upsampling run once, after the last iteration. No output changes.

Training (`RAFT.forward`, `train_forward`): RAFT's `forward(...,
test_mode=False)` over the module's parameters, in float32 with TF32 off:
`cnet`'s batch norm in training mode (momentum 0.1, eps 1e-5, its running
statistics updated), `coords1` detached at every iteration, the mask head
and the convex upsampling after every iteration; it returns every
iteration's full-resolution flow. `flow/train.py` trains it.

Layout: the port's frames [T,H,W,3] in [0, 1] and flow [T-1,H,W,2] (x, y);
inside, NCHW tensors in channels-last memory, as cuDNN takes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vstab_torch.core.config import RaftConfig
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.flow.pwcnet import compute_dtype
from vstab_torch.kernels.corr_lookup import corr_lookup
from vstab_torch.utils import trace

_CL = torch.channels_last


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1, self.norm2 = _norm(norm, cout), _norm(norm, cout)
        if stride != 1:
            self.norm3 = _norm(norm, cout)
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride), self.norm3)


class BasicEncoder(nn.Module):
    def __init__(self, out_dim: int, norm: str):
        super().__init__()
        self.norm1 = _norm(norm, 64)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm), ResidualBlock(64, 64, norm))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2), ResidualBlock(96, 96, norm))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2), ResidualBlock(128, 128, norm))
        self.conv2 = nn.Conv2d(128, out_dim, 1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RaftConfig):
        super().__init__()
        cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, inp: int):
        super().__init__()
        for name, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{name}", nn.Conv2d(hidden + inp, hidden, k, padding=pad))


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RaftConfig):
        super().__init__()
        self.encoder = BasicMotionEncoder(cfg)
        # the GRU's input: the context features and the motion encoder's 128
        self.gru = SepConvGRU(cfg.hidden, cfg.context + 128)
        self.flow_head = FlowHead(cfg.hidden, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(cfg.hidden, 256, 3, padding=1), nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1)
        )


class RAFT(nn.Module):
    """RAFT's module tree: its parameter names and shapes, and its
    initialisers. Inference is `estimate_flow_pairs`, over a state dict;
    `forward` is the training pass over the module's own tensors."""

    def __init__(self, cfg: RaftConfig = RaftConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden + cfg.context, "batch")
        self.update_block = BasicUpdateBlock(cfg)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> List[torch.Tensor]:
        """`train_forward` over the parameters and buffers, `cnet`'s batch
        norm in training mode while the module is."""
        p = {**dict(self.named_parameters()), **dict(self.named_buffers())}
        return train_forward(p, im1, im2, self.cfg, train_bn=self.training)


def _norm(kind: str, ch: int) -> nn.Module:
    return nn.BatchNorm2d(ch) if kind == "batch" else nn.InstanceNorm2d(ch)


def init_params(
    seed: Union[int, torch.Generator], cfg: RaftConfig = RaftConfig(), device=None
) -> Dict[str, torch.Tensor]:
    """A fresh state dict of RAFT on `device` (CUDA unless told otherwise),
    with RAFT's initialisers drawn module by module from `seed`, an integer
    or a `torch.Generator` that lies on the device: the encoders'
    convolutions kaiming-normal (fan_out, relu) with torch's default biases,
    norm weights 1 and biases 0 and batch-norm statistics 0 / 1, the update
    block torch's default `Conv2d` initialisation."""
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        net = RAFT(cfg)
    net = net.to_empty(device=dev)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                if name.startswith("update_block."):
                    # torch's default, kaiming_uniform_(a=sqrt(5)): U(-1/sqrt(fan_in), ..)
                    m.weight.uniform_(-bound, bound, generator=gen)
                else:
                    fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
                m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
    return {k: v.detach() for k, v in net.state_dict().items()}


def build_net(params: Mapping[str, torch.Tensor], cfg: RaftConfig, device=None) -> RAFT:
    """A RAFT module in training mode on `device` (the tensors' own if
    None) over float32 copies of `params` (the caller's stay as they are),
    its convolution weights in channels-last memory as the activations are."""
    dev = next(iter(params.values())).device if device is None else torch.device(device)
    with torch.device("meta"):
        net = RAFT(cfg)
    state = {k: v.detach().to(dev, torch.float32 if v.is_floating_point() else v.dtype, copy=True)
             for k, v in params.items()}
    net.load_state_dict(state, strict=True, assign=True)
    return net.to(memory_format=_CL).train()


def prepare(params: Mapping[str, torch.Tensor], cfg: RaftConfig) -> Dict[str, torch.Tensor]:
    """The state dict as the forward pass takes it, cast once per call of
    `clip_flow`: convolution weights and biases in the compute dtype (the
    weights in channels-last memory), norms and everything else as given.
    GMFlow's `prepare` casts its convolutions here too."""
    dtype = compute_dtype(cfg)
    out = dict(params)
    for k, v in params.items():
        if v.dim() == 4:  # a convolution's weight, and its bias where it has one
            out[k] = v.to(dtype).contiguous(memory_format=_CL)
            bias = k[: -len("weight")] + "bias"
            if bias in params:
                out[bias] = params[bias].to(dtype)
    return out


def _conv(p, name: str, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """Convolution `name`, with its bias where the state dict has one."""
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"), stride=stride, padding=padding)


def _norm_apply(p, name: str, x: torch.Tensor, kind: str, train: bool = False) -> torch.Tensor:
    """Instance norm, or batch norm: in eval mode, or with `train` in
    training mode (the batch's statistics, the running ones updated with
    momentum 0.1 and the count of batches raised, as `nn.BatchNorm2d`)."""
    if kind == "instance":
        y = F.instance_norm(x, eps=1e-5)
    else:
        y = F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                         p[name + ".weight"], p[name + ".bias"], train, 0.1 if train else 0.0, 1e-5)
        if train:
            p[name + ".num_batches_tracked"].add_(1)
    return y.contiguous(memory_format=_CL)


def _residual(p, name: str, x: torch.Tensor, kind: str, stride: int, train: bool = False) -> torch.Tensor:
    """`ResidualBlock` `name` of RAFT or GMFlow: its convolutions with or
    without bias, and the 1x1 shortcut wherever the state dict has one (RAFT:
    where the stride is not 1; GMFlow: also where the widths differ)."""
    y = F.relu(_norm_apply(p, name + ".norm1", _conv(p, name + ".conv1", x, stride, 1), kind, train))
    y = F.relu(_norm_apply(p, name + ".norm2", _conv(p, name + ".conv2", y, 1, 1), kind, train))
    if name + ".downsample.0.weight" in p:
        x = _norm_apply(p, name + ".norm3", _conv(p, name + ".downsample.0", x, stride), kind, train)
    return F.relu(x + y)


def encode(p: Mapping[str, torch.Tensor], name: str, x: torch.Tensor, kind: str,
           strides: Tuple[int, int, int] = (1, 2, 2), train: bool = False) -> torch.Tensor:
    """`BasicEncoder` `name` ('fnet' or 'cnet') on images [N,3,H,W] in
    [-1, 1] -> [N,C,H/8,W/8]: instance norm (per image, affine-free) or
    batch norm, in eval mode unless `train`. `strides` are the three layers'
    (GMFlow's `CNNEncoder` at two scales: (1, 2, 1), to 1/4)."""
    x = F.relu(_norm_apply(p, name + ".norm1", _conv(p, name + ".conv1", x, 2, 3), kind, train))
    for layer, stride in zip(("layer1", "layer2", "layer3"), strides):
        x = _residual(p, f"{name}.{layer}.0", x, kind, stride, train)
        x = _residual(p, f"{name}.{layer}.1", x, kind, 1, train)
    return _conv(p, name + ".conv2", x)


def corr_gemm(f1: torch.Tensor, f2: torch.Tensor) -> str:
    """The route of `corr_pyramid`'s product for these feature maps:
    'bf16_f32acc' for bfloat16 CUDA tensors that need no gradient (one
    batched bf16 x bf16 product on the tensor cores, float32 sums and
    float32 out, the 1/sqrt(C) scale in its alpha: a product of two bfloat16
    values is exact in float32, so only the order of the sums differs from
    the f32 route), else 'f32' (both upcast, an f32 product with TF32 off,
    then the division)."""
    fast = (f1.dtype == f2.dtype == torch.bfloat16 and f1.is_cuda and f2.is_cuda
            and not (f1.requires_grad or f2.requires_grad))
    return "bf16_f32acc" if fast else "f32"


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """All-pairs correlation f1^T f2 / sqrt(C) of [N,C,H,W] feature maps in
    float32, [N H W, H, W], and its `levels - 1` 2x2 average poolings over
    the second frame's axes (RAFT's `CorrBlock`); the product by the route
    `corr_gemm` gives."""
    n, c, h, w = f1.shape
    bf16 = corr_gemm(f1, f2) == "bf16_f32acc"
    a, b = ((f if bf16 else f.float()).permute(0, 2, 3, 1).reshape(n, h * w, c) for f in (f1, f2))
    if bf16:
        # The volume is its own addend: with beta 0 nothing is read or copied
        # into it before the product (a separate addend is copied in first).
        corr = torch.empty((n, h * w, h * w), dtype=torch.float32, device=f1.device)
        torch.baddbmm(corr, a, b.transpose(1, 2), out_dtype=torch.float32, beta=0,
                      alpha=1 / math.sqrt(c), out=corr)
    else:
        corr = torch.bmm(a, b.transpose(1, 2)).div_(math.sqrt(c))
    corr = corr.view(n * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return [t.view(n * h * w, *t.shape[-2:]) for t in pyramid]


def pyramid_bytes(h8: int, w8: int, levels: int) -> int:
    """Bytes of one pair's float32 correlation pyramid at an h8 x w8 grid."""
    return 4 * h8 * w8 * sum((h8 >> i) * (w8 >> i) for i in range(levels))


def _conv3x3_gemm(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """Convolution `name` (3x3, stride 1, padding 1) as one matrix product
    of x's 3x3 patches (`F.unfold`, each patch channel-major as the weight)
    with the weight [O, 9 C], plus the bias, written [N,O,H,W] in
    channels-last memory. Only the order of the float32 sums differs from
    the convolution's."""
    w = p[name + ".weight"]
    n, _, h, wd = x.shape
    cols = F.unfold(x, 3, padding=1)  # [N, C 9, H W]
    out = torch.matmul(cols.transpose(1, 2), w.reshape(w.shape[0], -1).t()) + p[name + ".bias"]
    return out.view(n, h, wd, -1).permute(0, 3, 1, 2)


def update(p: Mapping[str, torch.Tensor], net: torch.Tensor, inp: torch.Tensor,
           corr: torch.Tensor, flow: torch.Tensor,
           gemm_wide: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One `BasicUpdateBlock` step without its mask: (new hidden state,
    delta flow [N,2,H,W] float32). corr [N,C,H,W] and net, inp in the
    compute dtype; flow float32. With `gemm_wide` the motion encoder's two
    3x3 convolutions over 256 channels (`convc2`, `conv`) run as
    `_conv3x3_gemm` (RAFT's float32 training pass: there cuDNN's heuristic
    picks an FFT engine for them that takes ~34 ms a call at batch 10 of
    368x496 on an H100, 0.7 TFLOP/s, and whose time moves by several percent
    from process to process); else as cuDNN's convolutions."""
    e, g = "update_block.encoder.", "update_block.gru."
    dtype = net.dtype
    flo = flow.to(dtype)

    def wide(name, x):
        return _conv3x3_gemm(p, e + name, x) if gemm_wide else _conv(p, e + name, x, padding=1)

    cor = F.relu(_conv(p, e + "convc1", corr))
    cor = F.relu(wide("convc2", cor))
    fl = F.relu(_conv(p, e + "convf1", flo, padding=3))
    fl = F.relu(_conv(p, e + "convf2", fl, padding=1))
    out = F.relu(wide("conv", torch.cat([cor, fl], dim=1)))
    x = torch.cat([inp, out, flo], dim=1)
    h = net
    for i, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(p, g + "convz" + i, hx, padding=pad))
        r = torch.sigmoid(_conv(p, g + "convr" + i, hx, padding=pad))
        q = torch.tanh(_conv(p, g + "convq" + i, torch.cat([r * h, x], dim=1), padding=pad))
        h = (1 - z) * h + z * q
    f = "update_block.flow_head."
    delta = _conv(p, f + "conv2", F.relu(_conv(p, f + "conv1", h, padding=1)), padding=1)
    return h, delta.float()


def convex_upsample(p: Mapping[str, torch.Tensor], head: str, x: torch.Tensor, flow: torch.Tensor,
                    factor: int, mask_scale: float = 1.0) -> torch.Tensor:
    """Convex upsampling x`factor` of flow [N,2,H,W] float32 with the mask
    that the head `head` (conv3x3, ReLU, conv1x1 to 9 factor^2 channels)
    computes from x, scaled by `mask_scale`: pixel (f y + i, f x + j) is the
    softmax-weighted sum over the 3x3 neighbourhood of factor * flow, weights
    from mask channel k f^2 + i f + j. The softmax and the sum in float32."""
    n, _, h, w = flow.shape
    mask = _conv(p, head + ".2", F.relu(_conv(p, head + ".0", x, padding=1)))
    if mask_scale != 1.0:
        mask = mask_scale * mask
    mask = torch.softmax(mask.float().reshape(n, 1, 9, factor, factor, h, w), dim=2)
    up = F.unfold(float(factor) * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)  # [N,2,f,f,H,W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, factor * h, factor * w)


def upsample(p: Mapping[str, torch.Tensor], net: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """RAFT's convex upsampling x8 of flow [N,2,H,W] with the mask of the
    hidden state, scaled by 0.25 (RAFT's `update_block.mask`)."""
    return convex_upsample(p, "update_block.mask", net, flow, 8, 0.25)


def pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """RAFT's and GMFlow's `InputPadder` (sintel mode): [N,C,H,W]
    edge-padded to multiples of `multiple` (RAFT 8, GMFlow 32), split evenly
    between the two sides; the pads (left, right, top, bottom)."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % multiple, (-w) % multiple
    pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    if ph or pw:
        x = F.pad(x, pads, mode="replicate").contiguous(memory_format=_CL)
    return x, pads


@torch.no_grad()
def estimate_flow_pairs(p: Mapping[str, torch.Tensor], frames: torch.Tensor,
                        cfg: RaftConfig = RaftConfig()) -> torch.Tensor:
    """Consecutive-pair flow over a clip, [T,H,W,3] in [0, 1] ->
    [T-1,H,W,2] float32; `p` is `prepare`'s cast of the state dict. `fnet`
    encodes each frame once, shared by the two pairs it belongs to; `cnet`
    each pair's first frame."""
    pin_full_f32()
    dtype, dev = compute_dtype(cfg), frames.is_cuda
    t, h, w, _ = frames.shape
    x, pads = pad_to((2.0 * frames.float() - 1.0).permute(0, 3, 1, 2).to(dtype), 8)
    with trace.span("vstab.flow.raft.encode", device=dev):
        fmap = encode(p, "fnet", x, "instance")
        ctx = encode(p, "cnet", x[:-1], "batch")
        net = torch.tanh(ctx[:, : cfg.hidden]).contiguous(memory_format=_CL)
        inp = torch.relu(ctx[:, cfg.hidden :]).contiguous(memory_format=_CL)
    n, h8, w8 = t - 1, fmap.shape[2], fmap.shape[3]
    with trace.span("vstab.flow.raft.corr", device=dev, gemm=corr_gemm(fmap[:-1], fmap[1:]),
                    corr_bytes=n * pyramid_bytes(h8, w8, cfg.corr_levels)):
        pyramid = corr_pyramid(fmap[:-1], fmap[1:], cfg.corr_levels)
    del fmap
    yy, xx = torch.meshgrid(torch.arange(h8, device=frames.device, dtype=torch.float32),
                            torch.arange(w8, device=frames.device, dtype=torch.float32),
                            indexing="ij")
    coords0 = torch.stack([xx, yy], dim=-1).expand(n, h8, w8, 2)  # [N,H,W,(x, y)]
    coords1 = coords0.clone()
    k = (2 * cfg.corr_radius + 1) ** 2 * cfg.corr_levels
    window = (2 * cfg.corr_radius + 2) ** 2 * cfg.corr_levels
    lookup_bytes = cfg.iters * n * h8 * w8 * (4 * window + 8 + k * x.element_size())
    with trace.span("vstab.flow.raft.update", device=dev, iters=cfg.iters,
                    lookup_bytes=lookup_bytes):
        for _ in range(cfg.iters):
            corr = corr_lookup(pyramid, coords1, cfg.corr_radius, dtype).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, delta = update(p, net, inp, corr, flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
    del pyramid
    with trace.span("vstab.flow.raft.upsample", device=dev):
        up = upsample(p, net, (coords1 - coords0).permute(0, 3, 1, 2))
        up = up[:, :, pads[2] : pads[2] + h, pads[0] : pads[0] + w]
        return up.permute(0, 2, 3, 1).contiguous()


def train_forward(p: Mapping[str, torch.Tensor], im1: torch.Tensor, im2: torch.Tensor,
                  cfg: RaftConfig, train_bn: bool = True) -> List[torch.Tensor]:
    """RAFT's training pass (`forward(..., test_mode=False)`) on pairs
    [N,H,W,3] in [0, 1], H and W multiples of 8 -> `cfg.iters` flows
    [N,H,W,2], one an iteration, each upsampled x8 with its own mask.
    Float32 throughout with TF32 off, the motion encoder's wide layers as
    `_conv3x3_gemm`; `cnet`'s batch norm in training mode unless `train_bn`
    is False; the coordinates detached at every iteration.
    Spans: `encode`, `corr` and `update` once, `upsample` (the mask head and
    the convex upsampling) an iteration, nested in `update`."""
    if cfg.compute_dtype != "float32":
        raise ValueError(f"RAFT trains in float32, not {cfg.compute_dtype}")
    n, h, w, _ = im1.shape
    if h % 8 or w % 8:
        raise ValueError(f"RAFT's training pairs are multiples of 8 in size, not {h}x{w}")
    pin_full_f32()
    dev = im1.is_cuda
    x = (2.0 * torch.cat([im1, im2]).float() - 1.0).permute(0, 3, 1, 2)
    with trace.span("vstab.flow.raft.encode", device=dev):
        fmap = encode(p, "fnet", x, "instance")
        ctx = encode(p, "cnet", x[:n], "batch", train=train_bn)
        net = torch.tanh(ctx[:, : cfg.hidden]).contiguous(memory_format=_CL)
        inp = torch.relu(ctx[:, cfg.hidden :]).contiguous(memory_format=_CL)
    h8, w8 = h // 8, w // 8
    with trace.span("vstab.flow.raft.corr", device=dev, gemm=corr_gemm(fmap[:n], fmap[n:]),
                    corr_bytes=n * pyramid_bytes(h8, w8, cfg.corr_levels)):
        pyramid = corr_pyramid(fmap[:n], fmap[n:], cfg.corr_levels)
    yy, xx = torch.meshgrid(torch.arange(h8, device=im1.device, dtype=torch.float32),
                            torch.arange(w8, device=im1.device, dtype=torch.float32), indexing="ij")
    coords0 = torch.stack([xx, yy], dim=-1).expand(n, h8, w8, 2)  # [N,H,W,(x, y)]
    coords1 = coords0.clone()
    k = (2 * cfg.corr_radius + 1) ** 2 * cfg.corr_levels
    window = (2 * cfg.corr_radius + 2) ** 2 * cfg.corr_levels
    preds = []
    with trace.span("vstab.flow.raft.update", device=dev, iters=cfg.iters,
                    lookup_bytes=cfg.iters * n * h8 * w8 * (4 * window + 8 + 4 * k)):
        for _ in range(cfg.iters):
            coords1 = coords1.detach()
            corr = corr_lookup(pyramid, coords1, cfg.corr_radius).permute(0, 3, 1, 2)
            net, delta = update(p, net, inp, corr, (coords1 - coords0).permute(0, 3, 1, 2),
                                  gemm_wide=True)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            with trace.span("vstab.flow.raft.upsample", device=dev, iters=1):
                up = upsample(p, net, (coords1 - coords0).permute(0, 3, 1, 2))
                preds.append(up.permute(0, 2, 3, 1))
    return preds


def pair_chunk(h: int, w: int, cfg: RaftConfig, chunk: int) -> int:
    """Pairs in one chunk of `clip_flow` for RAFT at h x w: `chunk` (the
    PWC-Net default), lowered until the chunk's float32 correlation
    pyramids fit a budget of 16 GB. One pair's pyramid is 4 (HW/64)^2 x
    (1 + 1/4 + 1/16 + 1/64) bytes: 1.10 GB at 720p (8 pairs, 8.8 GB),
    5.6 GB at 1080p (2 pairs); at 4K (89 GB) none fits, and this raises."""
    budget = 16e9
    one = pyramid_bytes(-(-h // 8), -(-w // 8), cfg.corr_levels)
    fit = int(budget // one)
    if fit < 1:
        raise ValueError(
            f"RAFT's all-pairs correlation of one {h}x{w} pair takes {one / 1e9:.1f} GB, more "
            f"than the {budget / 1e9:.0f} GB budget of a chunk: frames this large do not fit"
        )
    return min(chunk, fit)


__all__ = [
    "RAFT",
    "build_net",
    "convex_upsample",
    "corr_gemm",
    "corr_pyramid",
    "encode",
    "estimate_flow_pairs",
    "init_params",
    "pad_to",
    "pair_chunk",
    "prepare",
    "pyramid_bytes",
    "train_forward",
    "update",
    "upsample",
]
