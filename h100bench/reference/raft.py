"""RAFT's forward pass (Teed & Deng, ECCV 2020, arXiv 2003.12039;
princeton-vl/RAFT `core/raft.py`, `extractor.py`, `corr.py`, `update.py`),
written out as plain functions over a state dict with RAFT's names (each
layer takes a batch of pairs; `pair_flows` runs one pair at a time so that a
pair's correlation volume is all it holds); its weights drawn with RAFT's
initialisers; and the stabilizer over its flow. It is also the oracle that
`tests/test_torch_raft.py` holds the program's RAFT to on the CPU.

Layout NCHW, as the published code. Everything computes in float32 with
TF32 off; under the "fp8" policy the operands of every convolution that the
configuration states in bfloat16 (the encoders, the motion encoder, the GRU,
the flow head and the mask head: all of them) are rounded to float8 first;
the correlation, its pyramid, the lookup and the upsampling stay float32,
as the configuration states. `corr_bf16` rounds the correlation pyramid to
bfloat16 (a control, not a policy of the configuration).

Departures from the published code, each giving the same numbers where that
code is defined: the mask head and the convex upsampling run once, after the
last iteration (RAFT's `test_mode` discards every earlier result); the
lookup samples a level padded by one zero pixel a side (RAFT divides by
W - 1, which is 0 on a level one pixel wide).

Imports nothing of `vstab_torch`, JAX or `vstab`.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference import stabilize as ref
from h100bench.reference.precision import lowp
from h100bench.reference.pwcnet import unit

Params = Mapping[str, torch.Tensor]


def _encoder_layers(name: str, out_dim: int, batch_norm: bool) -> List[Tuple[str, tuple]]:
    """(parameter name, shape) of one BasicEncoder; batch norm keeps its
    statistics, instance norm has no parameters."""
    rows: List[Tuple[str, tuple]] = []

    def conv(n, cout, cin, k):
        rows.extend([(f"{n}.weight", (cout, cin, k, k)), (f"{n}.bias", (cout,))])

    def norm(n, ch):
        if batch_norm:
            rows.extend([(f"{n}.weight", (ch,)), (f"{n}.bias", (ch,)), (f"{n}.running_mean", (ch,)),
                         (f"{n}.running_var", (ch,)), (f"{n}.num_batches_tracked", ())])

    conv(f"{name}.conv1", 64, 3, 7)
    norm(f"{name}.norm1", 64)
    cin = 64
    for layer, cout, stride in (("layer1", 64, 1), ("layer2", 96, 2), ("layer3", 128, 2)):
        for i in range(2):
            b = f"{name}.{layer}.{i}"
            conv(f"{b}.conv1", cout, cin, 3)
            conv(f"{b}.conv2", cout, cout, 3)
            norm(f"{b}.norm1", cout)
            norm(f"{b}.norm2", cout)
            if i == 0 and stride != 1:
                norm(f"{b}.norm3", cout)
                conv(f"{b}.downsample.0", cout, cin, 1)
                norm(f"{b}.downsample.1", cout)  # the same module as norm3
            cin = cout
    conv(f"{name}.conv2", out_dim, 128, 1)
    return rows


def _update_layers(levels: int, radius: int) -> List[Tuple[str, tuple]]:
    u = "update_block."
    convs = [
        ("encoder.convc1", 256, levels * (2 * radius + 1) ** 2, (1, 1)),
        ("encoder.convc2", 192, 256, (3, 3)), ("encoder.convf1", 128, 2, (7, 7)),
        ("encoder.convf2", 64, 128, (3, 3)), ("encoder.conv", 126, 256, (3, 3)),
        *[(f"gru.conv{g}{i}", 128, 384, k) for i, k in (("1", (1, 5)), ("2", (5, 1))) for g in "zrq"],
        ("flow_head.conv1", 256, 128, (3, 3)), ("flow_head.conv2", 2, 256, (3, 3)),
        ("mask.0", 256, 128, (3, 3)), ("mask.2", 576, 256, (1, 1)),
    ]
    rows = []
    for n, cout, cin, k in convs:
        rows.extend([(f"{u}{n}.weight", (cout, cin, *k)), (f"{u}{n}.bias", (cout,))])
    return rows


def init_params(seed: int, device, levels: int = 4, radius: int = 4) -> Dict[str, torch.Tensor]:
    """RAFT's parameters drawn from `seed` with its initialisers: the
    encoders' convolutions kaiming-normal (fan_out, relu) with torch's
    default biases U(+-1/sqrt(fan_in)), norms weight 1, bias 0, statistics
    0 / 1; the update block's convolutions torch's defaults, U(+-1/sqrt(fan_in))
    for weights and biases."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = (_encoder_layers("fnet", 256, False) + _encoder_layers("cnet", 256, True)
            + _update_layers(levels, radius))
    p: Dict[str, torch.Tensor] = {}
    for name, shape in rows:
        if name in p:  # a convolution's bias, drawn with its weight
            continue
        if len(shape) == 4:
            fan_in, fan_out = shape[1] * shape[2] * shape[3], shape[0] * shape[2] * shape[3]
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.empty(shape, device=device)
            if name.startswith("update_block."):
                w.uniform_(-bound, bound, generator=gen)
            else:
                w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
            p[name] = w
            p[name[: -len("weight")] + "bias"] = torch.empty(shape[0], device=device).uniform_(
                -bound, bound, generator=gen)
        elif name.endswith(("running_var", ".weight")):
            p[name] = torch.ones(shape, device=device)
        elif name.endswith("num_batches_tracked"):
            p[name] = torch.zeros((), dtype=torch.long, device=device)
        else:  # a norm's bias or running mean
            p[name] = torch.zeros(shape, device=device)
    return p


def _conv(p: Params, name: str, x: torch.Tensor, policy: str, stride: int = 1, padding=0):
    w, b = p[name + ".weight"], p[name + ".bias"]
    return F.conv2d(lowp(policy, x), lowp(policy, w), b.float(), stride=stride, padding=padding)


def _norm(p: Params, name: str, x: torch.Tensor, batch_norm: bool) -> torch.Tensor:
    if not batch_norm:
        return F.instance_norm(x, eps=1e-5)
    return F.batch_norm(x, p[name + ".running_mean"].float(), p[name + ".running_var"].float(),
                        p[name + ".weight"].float(), p[name + ".bias"].float(), False, 0.0, 1e-5)


def encoder(p: Params, name: str, x: torch.Tensor, batch_norm: bool, policy: str) -> torch.Tensor:
    """BasicEncoder: [N,3,H,W] in [-1, 1] -> [N,256,H/8,W/8]."""
    x = F.relu(_norm(p, name + ".norm1", _conv(p, name + ".conv1", x, policy, 2, 3), batch_norm))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for i, s in ((0, stride), (1, 1)):
            b = f"{name}.{layer}.{i}"
            y = F.relu(_norm(p, b + ".norm1", _conv(p, b + ".conv1", x, policy, s, 1), batch_norm))
            y = F.relu(_norm(p, b + ".norm2", _conv(p, b + ".conv2", y, policy, 1, 1), batch_norm))
            if s != 1:
                x = _norm(p, b + ".downsample.1", _conv(p, b + ".downsample.0", x, policy, s), batch_norm)
            x = F.relu(x + y)
    return _conv(p, name + ".conv2", x, policy)


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int, corr_bf16: bool = False):
    """CorrBlock: the all-pairs correlation / sqrt(C) in float32 and its
    2x2 average poolings, [N*H*W, 1, H_l, W_l] a level for N pairs."""
    n, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.view(n, c, h * w).transpose(1, 2), fmap2.view(n, c, h * w)) / math.sqrt(c)
    pyramid = [corr.view(n * h * w, 1, h, w)]
    for _ in range(levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    if corr_bf16:
        pyramid = [t.to(torch.bfloat16).float() for t in pyramid]
    return pyramid


def lookup(pyramid, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """CorrBlock.__call__: coords [N,2,H,W] (x, y) -> [N, levels (2r+1)^2,
    H, W]; x offset from the slow index of the window."""
    n, _, h, w = coords.shape
    k = 2 * radius + 1
    d = torch.linspace(-radius, radius, k, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).view(1, k, k, 2)
    out = []
    for i, corr in enumerate(pyramid):
        img = F.pad(corr, (1, 1, 1, 1))
        hp, wp = img.shape[-2:]
        c = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2) / 2**i + delta + 1.0
        grid = torch.cat([2 * c[..., :1] / (wp - 1) - 1, 2 * c[..., 1:] / (hp - 1) - 1], dim=-1)
        out.append(F.grid_sample(img, grid, align_corners=True).view(n, h, w, k * k))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def update(p: Params, net, inp, corr, flow, policy: str):
    """BasicUpdateBlock without its mask: (hidden state, delta flow)."""
    e, g, f = "update_block.encoder.", "update_block.gru.", "update_block.flow_head."
    cor = F.relu(_conv(p, e + "convc1", corr, policy))
    cor = F.relu(_conv(p, e + "convc2", cor, policy, padding=1))
    flo = F.relu(_conv(p, e + "convf1", flow, policy, padding=3))
    flo = F.relu(_conv(p, e + "convf2", flo, policy, padding=1))
    out = F.relu(_conv(p, e + "conv", torch.cat([cor, flo], dim=1), policy, padding=1))
    x = torch.cat([inp, out, flow], dim=1)
    h = net
    for i, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(p, g + "convz" + i, hx, policy, padding=pad))
        r = torch.sigmoid(_conv(p, g + "convr" + i, hx, policy, padding=pad))
        q = torch.tanh(_conv(p, g + "convq" + i, torch.cat([r * h, x], dim=1), policy, padding=pad))
        h = (1 - z) * h + z * q
    delta = _conv(p, f + "conv2", F.relu(_conv(p, f + "conv1", h, policy, padding=1)), policy, padding=1)
    return h, delta


def upsample(p: Params, net: torch.Tensor, flow: torch.Tensor, policy: str) -> torch.Tensor:
    """The mask head (x 0.25), a softmax over the 3x3 neighbourhood, and
    the convex combination of 8 * flow: [N,2,H,W] -> [N,2,8H,8W]."""
    m = _conv(p, "update_block.mask.0", net, policy, padding=1)
    mask = 0.25 * _conv(p, "update_block.mask.2", F.relu(m), policy)
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def pair_flow(p: Params, fmap1, fmap2, ctx, cfg: Mapping, policy: str, corr_bf16: bool = False):
    """One pair's upsampled flow [1,2,H,W] from its encoded frames."""
    hidden = cfg["hidden"]
    net, inp = torch.tanh(ctx[:, :hidden]), torch.relu(ctx[:, hidden:])
    pyramid = corr_pyramid(fmap1, fmap2, cfg["corr_levels"], corr_bf16)
    _, _, h, w = fmap1.shape
    yy, xx = torch.meshgrid(torch.arange(h, device=fmap1.device), torch.arange(w, device=fmap1.device),
                            indexing="ij")
    coords0 = torch.stack([xx, yy], dim=0).float()[None]
    coords1 = coords0.clone()
    for _ in range(cfg["iters"]):
        corr = lookup(pyramid, coords1, cfg["corr_radius"])
        net, delta = update(p, net, inp, corr, coords1 - coords0, policy)
        coords1 = coords1 + delta
    return upsample(p, net, coords1 - coords0, policy)


def pad8(x: torch.Tensor):
    """InputPadder (sintel mode): [N,C,H,W] replicate-padded to multiples of 8."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    pads = [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]
    return (F.pad(x, pads, mode="replicate") if ph or pw else x), pads


def pair_flows(p: Params, frames: torch.Tensor, cfg: Mapping, policy: str = "f32",
               corr_bf16: bool = False) -> Iterator[torch.Tensor]:
    """Consecutive-pair flow of a clip [T,H,W,3] (float in [0, 1] or uint8):
    [1,H,W,2] a pair, each frame encoded by fnet once."""
    t, h, w, _ = frames.shape

    def image(i):
        x = unit(frames[i : i + 1].to(torch.device(p["fnet.conv1.weight"].device)))
        return pad8(2.0 * x.permute(0, 3, 1, 2) - 1.0)

    x1, pads = image(0)
    f1 = encoder(p, "fnet", x1, False, policy)
    for i in range(t - 1):
        x2, _ = image(i + 1)
        f2 = encoder(p, "fnet", x2, False, policy)
        ctx = encoder(p, "cnet", x1, True, policy)
        fl = pair_flow(p, f1, f2, ctx, cfg, policy, corr_bf16)
        yield fl[:, :, pads[2] : pads[2] + h, pads[0] : pads[0] + w].permute(0, 2, 3, 1)
        x1, f1 = x2, f2


def solve(frames: torch.Tensor, params: Params, cfg: Mapping, policy: str = "f32",
          corr_bf16: bool = False, pairs_per_block: int = 8) -> Dict[str, object]:
    """`reference.stabilize.solve` over RAFT's flow: {'profiles' C,
    'disp' C - P, 'bucket'}."""
    t, h, w, _ = frames.shape
    s = cfg["smooth"]
    flows = pair_flows(params, frames, cfg["flow"], policy, corr_bf16)
    m, block = [], []
    for fl in flows:
        block.append(fl)
        if len(block) == pairs_per_block:
            m.append(ref.vertex_motion(torch.cat(block), tuple(s["grid_size"]), s["robust_iters"]))
            block = []
    if block:
        m.append(ref.vertex_motion(torch.cat(block), tuple(s["grid_size"]), s["robust_iters"]))
    m = torch.cat(m)
    c = torch.cat([torch.zeros_like(m[:1]), torch.cumsum(m, dim=0)], dim=0)
    disp = c - ref.smooth_profiles(c, s)
    return {"profiles": c, "disp": disp, "bucket": ref.bucket(ref.residual_bound(disp, h, w), cfg["render"])}
