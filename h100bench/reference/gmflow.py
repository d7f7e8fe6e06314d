"""GMFlow with refinement's forward pass (Xu et al., CVPR 2022, arXiv
2111.13680; haofeixu/gmflow `gmflow/gmflow.py`, `backbone.py`,
`transformer.py`, `matching.py`, `position.py`, `utils.py`, `geometry.py`;
flags --num_scales 2 --feature_channels 128 --upsample_factor 4 --num_head 1
--ffn_dim_expansion 4 --num_transformer_layers 6 --padding_factor 32
--attn_splits_list 2 8 --corr_radius_list -1 4 --prop_radius_list -1 1),
written out as plain functions over a state dict with GMFlow's names, one
pair at a time; its weights drawn with GMFlow's initialisers; and the
stabilizer over its flow. It is also the oracle that
`tests/test_torch_gmflow.py` holds the program's GMFlow to on the CPU.

Layout NCHW and tokens [B,L,C], as the published code. Everything computes
in float32 with TF32 off; under the "fp8" policy the operands of every
layer that the configuration states in bfloat16 are rounded to float8
first: the backbone's convolutions, the transformer's projections, its
attention products (q and k, the probabilities and v) and its FFN, and the
upsampler's convolutions; the matchings, propagations and convex
upsampling stay float32, as the configuration states. `match_bf16` rounds
both matchings' logits to bfloat16 (a control, not a policy of the
configuration).

Departures from the published code: the weights are drawn in the state
dict's order from one generator (the published constructor draws in module
order and then re-initialises); the convex upsampling runs only after the
last scale (the published code upsamples earlier scales at training time
only); a pair's frames are encoded one at a time (the published code
encodes the two as one batch: instance norm is per image, so the numbers
are the same).

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
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
C = 128  # feature channels
BLOCKS = 6
FFN = 4
# per scale, 1/8 then 1/4: attn_splits, corr_radius, prop_radius (-1: global)
SCALES = ((2, -1, -1), (8, 4, 1))


def param_rows() -> List[Tuple[str, tuple]]:
    """(name, shape) of GMFlow's state dict, in its order."""
    rows: List[Tuple[str, tuple]] = [("backbone.conv1.weight", (64, 3, 7, 7))]
    cin = 64
    for layer, cout, stride in (("layer1", 64, 1), ("layer2", 96, 2), ("layer3", 128, 1)):
        for i in range(2):
            b = f"backbone.{layer}.{i}"
            rows += [(f"{b}.conv1.weight", (cout, cin, 3, 3)), (f"{b}.conv2.weight", (cout, cout, 3, 3))]
            if i == 0 and (stride != 1 or cin != cout):
                rows += [(f"{b}.downsample.0.weight", (cout, cin, 1, 1)), (f"{b}.downsample.0.bias", (cout,))]
            cin = cout
    rows += [("backbone.conv2.weight", (C, 128, 1, 1)), ("backbone.conv2.bias", (C,)),
             ("backbone.trident_conv.weight", (C, C, 3, 3))]
    for i in range(BLOCKS):
        for part, ffn in (("self_attn", False), ("cross_attn_ffn", True)):
            n = f"transformer.layers.{i}.{part}"
            rows += [(f"{n}.{m}.weight", (C, C)) for m in ("q_proj", "k_proj", "v_proj", "merge")]
            rows += [(f"{n}.norm1.weight", (C,)), (f"{n}.norm1.bias", (C,))]
            if ffn:
                rows += [(f"{n}.mlp.0.weight", (2 * C * FFN, 2 * C)),
                         (f"{n}.mlp.2.weight", (C, 2 * C * FFN)),
                         (f"{n}.norm2.weight", (C,)), (f"{n}.norm2.bias", (C,))]
    for m in ("q_proj", "k_proj"):
        rows += [(f"feature_flow_attn.{m}.weight", (C, C)), (f"feature_flow_attn.{m}.bias", (C,))]
    rows += [("upsampler.0.weight", (256, 2 + C, 3, 3)), ("upsampler.0.bias", (256,)),
             ("upsampler.2.weight", (16 * 9, 256, 1, 1)), ("upsampler.2.bias", (16 * 9,))]
    return rows


def init_params(seed: int, device, norm_gain: float = 1.0, feature_scale: float = 1.0
                ) -> Dict[str, torch.Tensor]:
    """GMFlow's parameters drawn from `seed` in the state dict's order, each
    weight followed by its bias: the backbone's convolutions
    kaiming-normal (fan_out, relu) (`CNNEncoder`), the trident weight
    kaiming-uniform (relu) (`MultiScaleTridentConv`), the transformer's and
    the propagation's matrices xavier-uniform (`FeatureTransformer`,
    `FeatureFlowAttention`), layer norms 1 and 0, the upsampler's weights and
    every bias torch's default U(+-1/sqrt(fan_in)). Then the layer norms'
    gains are multiplied by `norm_gain` and the trident weight (so both
    scales' features) by `feature_scale` (1 and 1: GMFlow's initialisers as
    published)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = param_rows()
    shapes = dict(rows)
    p: Dict[str, torch.Tensor] = {}
    for name, shape in rows:
        if name in p:
            continue
        t = torch.empty(shape, device=device)
        fan_in = math.prod(shape[1:])
        if name.startswith("backbone.trident_conv."):
            t.uniform_(-math.sqrt(6.0 / fan_in), math.sqrt(6.0 / fan_in), generator=gen)
        elif name.startswith("backbone.") and len(shape) == 4:
            t.normal_(0.0, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])), generator=gen)
        elif len(shape) == 2:
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            t.uniform_(-bound, bound, generator=gen)
        elif ".norm" in name:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        else:
            t.uniform_(-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in), generator=gen)
        p[name] = t
        bias = name[: -len("weight")] + "bias"
        if name.endswith("weight") and ".norm" not in name and bias in shapes:
            bound = 1.0 / math.sqrt(fan_in)
            p[bias] = torch.empty(shapes[bias], device=device).uniform_(-bound, bound, generator=gen)
    for name in p:
        if ".norm" in name and name.endswith("weight"):
            p[name] *= norm_gain
    p["backbone.trident_conv.weight"] *= feature_scale
    return p


def _conv(p: Params, name: str, x: torch.Tensor, policy: str, stride: int = 1, padding: int = 0):
    b = p.get(name + ".bias")
    return F.conv2d(lowp(policy, x), lowp(policy, p[name + ".weight"]), None if b is None else b.float(),
                    stride=stride, padding=padding)


def _linear(p: Params, name: str, x: torch.Tensor, policy: str, stated_bf16: bool = True):
    b = p.get(name + ".bias")
    return F.linear(lowp(policy, x, stated_bf16), lowp(policy, p[name + ".weight"], stated_bf16),
                    None if b is None else b.float())


def backbone(p: Params, x: torch.Tensor, policy: str) -> List[torch.Tensor]:
    """CNNEncoder with two output scales: [N,3,H,W] normalized -> [1/8, 1/4]
    features (low resolution first, as `extract_feature` reverses them)."""
    norm = lambda t: F.instance_norm(t, eps=1e-5)  # noqa: E731
    x = F.relu(norm(_conv(p, "backbone.conv1", x, policy, 2, 3)))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 1)):
        for i, s in ((0, stride), (1, 1)):
            b = f"backbone.{layer}.{i}"
            y = F.relu(norm(_conv(p, b + ".conv1", x, policy, s, 1)))
            y = F.relu(norm(_conv(p, b + ".conv2", y, policy, 1, 1)))
            if b + ".downsample.0.weight" in p:
                x = norm(_conv(p, b + ".downsample.0", x, policy, s))
            x = F.relu(x + y)
    x = _conv(p, "backbone.conv2", x, policy)
    w = lowp(policy, p["backbone.trident_conv.weight"])
    x = lowp(policy, x)
    return [F.conv2d(x, w, None, 2, 1), F.conv2d(x, w, None, 1, 1)]


def split_feature(feature: torch.Tensor, num_splits: int, channel_last: bool = False) -> torch.Tensor:
    if channel_last:  # [B,H,W,C]
        b, h, w, c = feature.size()
        return feature.view(b, num_splits, h // num_splits, num_splits, w // num_splits, c
                            ).permute(0, 1, 3, 2, 4, 5).reshape(b * num_splits ** 2, h // num_splits,
                                                                w // num_splits, c)
    b, c, h, w = feature.size()
    return feature.view(b, c, num_splits, h // num_splits, num_splits, w // num_splits
                        ).permute(0, 2, 4, 1, 3, 5).reshape(b * num_splits ** 2, c, h // num_splits,
                                                            w // num_splits)


def merge_splits(splits: torch.Tensor, num_splits: int, channel_last: bool = False) -> torch.Tensor:
    if channel_last:  # [B*K*K,H/K,W/K,C]
        b, h, w, c = splits.size()
        nb = b // num_splits // num_splits
        return splits.view(nb, num_splits, num_splits, h, w, c).permute(0, 1, 3, 2, 4, 5).contiguous(
        ).view(nb, num_splits * h, num_splits * w, c)
    b, c, h, w = splits.size()
    nb = b // num_splits // num_splits
    return splits.view(nb, num_splits, num_splits, c, h, w).permute(0, 3, 1, 4, 2, 5).contiguous(
    ).view(nb, c, num_splits * h, num_splits * w)


def position_embedding(x: torch.Tensor, num_pos_feats: int = C // 2, temperature: int = 10000) -> torch.Tensor:
    """PositionEmbeddingSine (normalize=True, scale 2 pi) of [B,C,H,W] -> [B,C,H,W]."""
    b, _, h, w = x.size()
    mask = torch.ones((b, h, w), device=x.device)
    y_embed = mask.cumsum(1, dtype=torch.float32)
    x_embed = mask.cumsum(2, dtype=torch.float32)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def feature_add_position(feature0: torch.Tensor, feature1: torch.Tensor, attn_splits: int):
    """The position code of a window, added inside every window (attn_splits > 1)."""
    s0 = split_feature(feature0, attn_splits)
    s1 = split_feature(feature1, attn_splits)
    pos = position_embedding(s0)
    return merge_splits(s0 + pos, attn_splits), merge_splits(s1 + pos, attn_splits)


def shift_window_attn_mask(h: int, w: int, wh: int, ww: int, sh: int, sw: int, device) -> torch.Tensor:
    """generate_shift_window_attn_mask: [K*K, wh ww, wh ww] of 0 and -100."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = split_feature(img_mask, num_splits=w // ww, channel_last=True).view(-1, wh * ww)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def split_window_attention(q, k, v, num_splits: int, with_shift: bool, h: int, w: int, attn_mask,
                           policy: str) -> torch.Tensor:
    """single_head_split_window_attention on [B, H W, C]."""
    b, _, c = q.size()
    bn = b * num_splits * num_splits
    wh, ww = h // num_splits, w // num_splits
    q, k, v = (t.view(b, h, w, c) for t in (q, k, v))
    if with_shift:
        q, k, v = (torch.roll(t, shifts=(-(wh // 2), -(ww // 2)), dims=(1, 2)) for t in (q, k, v))
    q, k, v = (split_feature(t, num_splits, channel_last=True) for t in (q, k, v))
    scores = torch.matmul(lowp(policy, q.view(bn, -1, c)), lowp(policy, k.view(bn, -1, c)).permute(0, 2, 1)
                          ) / c ** 0.5
    if with_shift:
        scores = scores + attn_mask.repeat(b, 1, 1)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(lowp(policy, attn), lowp(policy, v.view(bn, -1, c)))
    out = merge_splits(out.view(bn, wh, ww, c), num_splits, channel_last=True)
    if with_shift:
        out = torch.roll(out, shifts=(wh // 2, ww // 2), dims=(1, 2))
    return out.view(b, -1, c)


def transformer_layer(p: Params, name: str, source, target, h: int, w: int, splits: int,
                      with_shift: bool, attn_mask, policy: str) -> torch.Tensor:
    query = _linear(p, name + ".q_proj", source, policy)
    key = _linear(p, name + ".k_proj", target, policy)
    value = _linear(p, name + ".v_proj", target, policy)
    message = split_window_attention(query, key, value, splits, with_shift, h, w, attn_mask, policy)
    message = _linear(p, name + ".merge", message, policy)
    message = F.layer_norm(message, (C,), p[name + ".norm1.weight"].float(), p[name + ".norm1.bias"].float())
    if name + ".mlp.0.weight" in p:
        message = F.gelu(_linear(p, name + ".mlp.0", torch.cat([source, message], dim=-1), policy))
        message = _linear(p, name + ".mlp.2", message, policy)
        message = F.layer_norm(message, (C,), p[name + ".norm2.weight"].float(), p[name + ".norm2.bias"].float())
    return source + message


def feature_transformer(p: Params, feature0, feature1, splits: int, policy: str):
    """FeatureTransformer with Swin windows (splits > 1): [B,C,H,W] x 2 ->
    the two updated feature maps."""
    b, c, h, w = feature0.shape
    feature0 = feature0.flatten(-2).permute(0, 2, 1)
    feature1 = feature1.flatten(-2).permute(0, 2, 1)
    wh, ww = h // splits, w // splits
    mask = shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2, feature0.device)
    concat0 = torch.cat((feature0, feature1), dim=0)
    concat1 = torch.cat((feature1, feature0), dim=0)
    for i in range(BLOCKS):
        blk = f"transformer.layers.{i}."
        shift = i % 2 == 1
        concat0 = transformer_layer(p, blk + "self_attn", concat0, concat0, h, w, splits, shift, mask, policy)
        concat0 = transformer_layer(p, blk + "cross_attn_ffn", concat0, concat1, h, w, splits, shift, mask,
                                    policy)
        concat1 = torch.cat(concat0.chunk(chunks=2, dim=0)[::-1], dim=0)
    feature0, feature1 = concat0.chunk(chunks=2, dim=0)
    return (feature0.view(b, h, w, c).permute(0, 3, 1, 2).contiguous(),
            feature1.view(b, h, w, c).permute(0, 3, 1, 2).contiguous())


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([x, y], dim=0).float()[None].repeat(b, 1, 1, 1)


def global_correlation_softmax(feature0, feature1, match_bf16: bool = False) -> torch.Tensor:
    b, c, h, w = feature0.shape
    feature0 = feature0.view(b, c, -1).permute(0, 2, 1)
    feature1 = feature1.view(b, c, -1)
    correlation = torch.matmul(feature0, feature1).view(b, h, w, h, w) / (c ** 0.5)
    if match_bf16:
        correlation = correlation.to(torch.bfloat16).float()
    init_grid = coords_grid(b, h, w, feature0.device)
    grid = init_grid.view(b, 2, -1).permute(0, 2, 1)
    prob = F.softmax(correlation.view(b, h * w, h * w), dim=-1)
    correspondence = torch.matmul(prob, grid).view(b, h, w, 2).permute(0, 3, 1, 2)
    return correspondence - init_grid


def local_correlation_softmax(feature0, feature1, local_radius: int, match_bf16: bool = False):
    b, c, h, w = feature0.size()
    coords_init = coords_grid(b, h, w, feature0.device)
    coords = coords_init.view(b, 2, -1).permute(0, 2, 1)
    k = 2 * local_radius + 1
    lin = torch.linspace(-local_radius, local_radius, k, device=feature0.device)
    x, y = torch.meshgrid([lin, lin], indexing="ij")
    window_grid = torch.stack((x, y), -1).transpose(0, 1).float().reshape(-1, 2).repeat(b, 1, 1, 1)
    sample_coords = coords.unsqueeze(-2) + window_grid  # [B, H W, K, 2]
    valid = ((sample_coords[..., 0] >= 0) & (sample_coords[..., 0] < w)
             & (sample_coords[..., 1] >= 0) & (sample_coords[..., 1] < h))
    norm = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], device=feature0.device)
    sample_coords_norm = (sample_coords - norm) / norm
    window_feature = F.grid_sample(feature1, sample_coords_norm, padding_mode="zeros",
                                   align_corners=True).permute(0, 2, 1, 3)  # [B, H W, C, K]
    feature0_view = feature0.permute(0, 2, 3, 1).view(b, h * w, 1, c)
    corr = torch.matmul(feature0_view, window_feature).view(b, h * w, -1) / (c ** 0.5)
    if match_bf16:
        corr = corr.to(torch.bfloat16).float()
    corr[~valid] = -1e9
    prob = F.softmax(corr, -1)
    correspondence = torch.matmul(prob.unsqueeze(-2), sample_coords).squeeze(-2).view(
        b, h, w, 2).permute(0, 3, 1, 2)
    return correspondence - coords_init


def feature_flow_attention(p: Params, feature0, flow, radius: int) -> torch.Tensor:
    """FeatureFlowAttention: global (radius < 0) or within the (2r+1)^2 window."""
    b, c, h, w = feature0.size()
    a = "feature_flow_attn."
    if radius < 0:
        query = _linear(p, a + "q_proj", feature0.view(b, c, h * w).permute(0, 2, 1), "f32")
        key = _linear(p, a + "k_proj", query, "f32")
        value = flow.view(b, flow.size(1), h * w).permute(0, 2, 1)
        scores = torch.matmul(query, key.permute(0, 2, 1)) / (c ** 0.5)
        out = torch.matmul(torch.softmax(scores, dim=-1), value)
        return out.view(b, h, w, value.size(-1)).permute(0, 3, 1, 2)
    ks = 2 * radius + 1
    f0 = _linear(p, a + "q_proj", feature0.view(b, c, -1).permute(0, 2, 1), "f32").reshape(b * h * w, 1, c)
    proj = _linear(p, a + "k_proj", f0.view(b, h, w, c), "f32").permute(0, 3, 1, 2)
    win = F.unfold(proj, kernel_size=ks, padding=radius).view(b, c, ks ** 2, h, w).permute(
        0, 3, 4, 1, 2).reshape(b * h * w, c, ks ** 2)
    flow_win = F.unfold(flow, kernel_size=ks, padding=radius).view(b, 2, ks ** 2, h, w).permute(
        0, 3, 4, 2, 1).reshape(b * h * w, ks ** 2, 2)
    prob = torch.softmax(torch.matmul(f0, win) / (c ** 0.5), dim=-1)
    return torch.matmul(prob, flow_win).view(b, h, w, 2).permute(0, 3, 1, 2).contiguous()


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    b, c, h, w = feature.size()
    grid = coords_grid(b, h, w, flow.device) + flow
    x_grid = 2 * grid[:, 0] / (w - 1) - 1
    y_grid = 2 * grid[:, 1] / (h - 1) - 1
    return F.grid_sample(feature, torch.stack([x_grid, y_grid], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def upsample_flow(p: Params, flow: torch.Tensor, feature: torch.Tensor, policy: str,
                  factor: int = 4) -> torch.Tensor:
    """The upsampler's mask from [flow; feature] and convex upsampling x4."""
    mask = _conv(p, "upsampler.2", F.relu(_conv(p, "upsampler.0", torch.cat((flow, feature), dim=1),
                                                   policy, padding=1)), policy)
    b, ch, h, w = flow.shape
    mask = torch.softmax(mask.view(b, 1, 9, factor, factor, h, w), dim=2)
    up = F.unfold(factor * flow, [3, 3], padding=1).view(b, ch, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, ch, factor * h, factor * w)


def pair_flow(p: Params, feats0: List[torch.Tensor], feats1: List[torch.Tensor], policy: str,
              match_bf16: bool = False) -> torch.Tensor:
    """One pair's flow [1,2,H,W] at the padded size from its two frames'
    [1/8, 1/4] features (GMFlow.forward at inference)."""
    flow = None
    for scale_idx, (splits, corr_radius, prop_radius) in enumerate(SCALES):
        feature0, feature1 = feats0[scale_idx], feats1[scale_idx]
        if scale_idx > 0:
            flow = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2
            feature1 = flow_warp(feature1, flow)
        feature0, feature1 = feature_add_position(feature0, feature1, splits)
        feature0, feature1 = feature_transformer(p, feature0, feature1, splits, policy)
        if corr_radius == -1:
            flow_pred = global_correlation_softmax(feature0, feature1, match_bf16)
        else:
            flow_pred = local_correlation_softmax(feature0, feature1, corr_radius, match_bf16)
        flow = flow + flow_pred if flow is not None else flow_pred
        flow = feature_flow_attention(p, feature0, flow, prop_radius)
    return upsample_flow(p, flow, feature0, policy)


def pad32(x: torch.Tensor):
    """InputPadder (sintel mode, padding_factor 32): [N,C,H,W] replicate-padded."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 32, (-w) % 32
    pads = [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]
    return (F.pad(x, pads, mode="replicate") if ph or pw else x), pads


def pair_flows(p: Params, frames: torch.Tensor, policy: str = "f32",
               match_bf16: bool = False) -> Iterator[torch.Tensor]:
    """Consecutive-pair flow of a clip [T,H,W,3] (float in [0, 1] or uint8):
    [1,H,W,2] a pair, each frame encoded once."""
    t, h, w, _ = frames.shape
    dev = torch.device(p["backbone.conv1.weight"].device)
    mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)

    def encode(i):
        x = unit(frames[i : i + 1].to(dev)).permute(0, 3, 1, 2)
        x, pads = pad32((x - mean) / std)
        return backbone(p, x, policy), pads

    f0, pads = encode(0)
    for i in range(t - 1):
        f1, _ = encode(i + 1)
        fl = pair_flow(p, f0, f1, policy, match_bf16)
        yield fl[:, :, pads[2] : pads[2] + h, pads[0] : pads[0] + w].permute(0, 2, 3, 1)
        f0 = f1


def solve(frames: torch.Tensor, params: Params, cfg: Mapping, policy: str = "f32",
          match_bf16: bool = False, pairs_per_block: int = 8) -> Dict[str, object]:
    """`reference.stabilize.solve` over GMFlow's flow: {'profiles' C,
    'disp' C - P, 'bucket'}."""
    t, h, w, _ = frames.shape
    s = cfg["smooth"]
    m, block = [], []
    for fl in pair_flows(params, frames, policy, match_bf16):
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
