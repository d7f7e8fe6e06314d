"""GMFlow with refinement, the port's third flow network (Xu, Zhang, Cai,
Rezatofighi and Tao, "GMFlow: Learning Optical Flow via Global Matching",
CVPR 2022, arXiv 2111.13680; haofeixu/gmflow `gmflow/gmflow.py`,
`backbone.py`, `transformer.py`, `matching.py`, `position.py`, `utils.py`,
`geometry.py`), the model of the `gmflow_with_refine_*` checkpoints:
two scales, 128 features, one head, 6 transformer blocks, FFN expansion 4,
windows 2x2 then 8x8, matching global then of radius 4, propagation global
then of radius 1, convex upsampling x4, frames padded to multiples of 32.

Per frame, the CNN backbone (RAFT's residual encoder with bias-free
convolutions, layer3 at stride 1, then one 3x3 weight at stride 1 and 2:
the 1/4 and 1/8 features), shared by the frame's two pairs. Per pair and
scale, 1/8 first: at 1/4 the 1/8 flow upsampled x2 and the second frame's
features warped by it (zeros outside); a sine position code inside each
window; 6 blocks of window self- and cross-attention over both frames
(windows shifted by half on odd blocks, the Swin mask -100); at 1/8 global
matching (a softmax over every position of the other frame, times the
coordinate grid) and global propagation (a softmax of the projected
features against their own projection, times the flow); at 1/4 local
matching (`kernels.cost_volume` of radius 4 scaled by sqrt(C), candidates
outside the map masked) and local propagation (the cost volume of radius 1
of the projections, the flow zero-padded). Then the upsampler's mask from
[flow; F0] and convex upsampling x4 (`raft.convex_upsample`).

The state dict has GMFlow's own names and shapes, so a published
checkpoint (its `model` entry) loads without a converter. Precision: the
backbone, the transformer's projections, attention, FFN and the
upsampler's convolutions in the compute dtype with float32 parameters
(layer norm and the attention softmax keep float32 statistics inside);
both matchings' logits and softmaxes, both propagations (projections,
logits, softmaxes, products), the coordinates, the flow and convex
upsampling in float32; TF32 off.

Departures from the published code, each giving the same numbers up to
rounding: local matching sums softmax(c)_d d rather than softmax(c)_d
(p + d) less p; the upsampler's mask head and the convex upsampling run
only after the last scale (the published code upsamples earlier scales at
training time only).

Layout: the port's frames [T,H,W,3] in [0, 1] and flow [T-1,H,W,2] (x, y);
features [N,H,W,C] tokens (channels-last NCHW for the convolutions), flow
[N,2,H,W].
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple, Union

import torch
import torch.nn.functional as F

from vstab_torch.core.config import GmflowConfig
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.flow import raft
from vstab_torch.flow.pwcnet import compute_dtype
from vstab_torch.kernels.cost_volume import cost_volume
from vstab_torch.utils import trace

_CL = torch.channels_last
MEAN = (0.485, 0.456, 0.406)  # ImageNet's, as GMFlow's `normalize_img`
STD = (0.229, 0.224, 0.225)
# The published settings (--num_scales 2 --feature_channels 128 --upsample_factor 4
# --num_head 1 --ffn_dim_expansion 4 --num_transformer_layers 6 --padding_factor 32
# --attn_splits_list 2 8 --corr_radius_list -1 4 --prop_radius_list -1 1).
C = 128  # feature channels
BLOCKS = 6  # transformer blocks, each a self- and a cross-attention layer
FFN = 4  # the FFN's expansion of [src; message]
PAD = 32  # frames are padded to multiples of this
# Per scale, coarsest first: (scale, windows a side, matching radius, propagation
# radius); a radius of -1 is global.
SCALES = ((8, 2, -1, -1), (4, 8, 4, 1))
SWIN_MASK = -100.0  # added between tokens of different regions of a shifted window
MATCH_BUDGET = 16e9  # bytes of a chunk's transient global-matching logits and softmax


def param_shapes() -> Dict[str, Tuple[int, ...]]:
    """GMFlow's state dict: each name and shape, in the order of the
    published module tree (`CNNEncoder`, `FeatureTransformer`,
    `FeatureFlowAttention`, the upsampler). The forward pass is
    `estimate_flow_pairs`, over a dict of these."""
    rows = {"backbone.conv1.weight": (64, 3, 7, 7)}
    cin = 64
    for layer, cout, stride in (("layer1", 64, 1), ("layer2", 96, 2), ("layer3", 128, 1)):
        for i in range(2):  # residual blocks: bias-free 3x3s, a 1x1 + bias shortcut where the shape changes
            b = f"backbone.{layer}.{i}."
            rows.update({b + "conv1.weight": (cout, cin, 3, 3), b + "conv2.weight": (cout, cout, 3, 3)})
            if i == 0 and (stride != 1 or cin != cout):
                rows.update({b + "downsample.0.weight": (cout, cin, 1, 1), b + "downsample.0.bias": (cout,)})
            cin = cout
    rows.update({"backbone.conv2.weight": (C, 128, 1, 1), "backbone.conv2.bias": (C,),
                 "backbone.trident_conv.weight": (C, C, 3, 3)})  # `MultiScaleTridentConv`: no bias
    for i in range(BLOCKS):
        for part, ffn in (("self_attn", False), ("cross_attn_ffn", True)):
            n = f"transformer.layers.{i}.{part}."
            rows.update({n + m + ".weight": (C, C) for m in ("q_proj", "k_proj", "v_proj", "merge")})
            rows.update({n + "norm1.weight": (C,), n + "norm1.bias": (C,)})
            if ffn:
                rows.update({n + "mlp.0.weight": (2 * C * FFN, 2 * C), n + "mlp.2.weight": (C, 2 * C * FFN),
                             n + "norm2.weight": (C,), n + "norm2.bias": (C,)})
    for m in ("q_proj", "k_proj"):
        rows.update({f"feature_flow_attn.{m}.weight": (C, C), f"feature_flow_attn.{m}.bias": (C,)})
    up = 4 ** 2 * 9  # upsample_factor 4 (8 / 2 ** (num_scales - 1))
    rows.update({"upsampler.0.weight": (256, 2 + C, 3, 3), "upsampler.0.bias": (256,),
                 "upsampler.2.weight": (up, 256, 1, 1), "upsampler.2.bias": (up,)})
    return rows


def _draw(name: str, shape: Tuple[int, ...], gen: torch.Generator, device) -> torch.Tensor:
    """One tensor of the state dict drawn with GMFlow's initialiser for it."""
    t = torch.empty(shape, device=device)
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else None
    if name.startswith("backbone.trident_conv."):  # kaiming_uniform_(relu)
        return t.uniform_(-math.sqrt(6.0 / fan_in), math.sqrt(6.0 / fan_in), generator=gen)
    if name.startswith("backbone.") and len(shape) == 4:  # kaiming_normal_(fan_out, relu)
        fan_out = shape[0] * shape[2] * shape[3]
        return t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
    if name.startswith(("transformer.", "feature_flow_attn.")) and len(shape) == 2:  # xavier_uniform_
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        return t.uniform_(-bound, bound, generator=gen)
    if ".norm" in name:  # LayerNorm
        return t.fill_(1.0 if name.endswith("weight") else 0.0)
    if name.endswith("weight"):  # the upsampler: torch's default, U(+-1/sqrt(fan_in))
        return t.uniform_(-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in), generator=gen)
    raise AssertionError(name)  # biases are drawn with their weights


def init_params(seed: Union[int, torch.Generator], device=None) -> Dict[str, torch.Tensor]:
    """A fresh state dict of GMFlow on `device` (CUDA unless told otherwise),
    drawn in its order from `seed`, an integer or a `torch.Generator` on the
    device, with GMFlow's initialisers: the backbone's convolutions
    kaiming-normal (fan_out, relu) with torch's default biases, the trident
    weight kaiming-uniform (relu), the transformer's and the propagation's
    matrices xavier-uniform, layer norms 1 and 0, every other weight and
    every bias torch's default U(+-1/sqrt(fan_in)). `h100bench/reference/
    gmflow.py` draws the same numbers."""
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=dev).manual_seed(seed)
    shapes = param_shapes()
    out: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name in out:
            continue
        out[name] = _draw(name, shape, gen, dev)
        bias = name[: -len("weight")] + "bias"
        if name.endswith("weight") and ".norm" not in name and bias in shapes:
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[bias] = torch.empty(shapes[bias], device=dev).uniform_(-bound, bound, generator=gen)
    return out


def prepare(params: Mapping[str, torch.Tensor], cfg: GmflowConfig) -> Dict[str, torch.Tensor]:
    """The state dict as the forward pass takes it, cast once per call of
    `clip_flow`: the convolutions as `raft.prepare` casts them, the
    transformer's matrices and layer norms in the compute dtype (the norm's
    statistics stay float32 inside the kernel); the propagation's
    projections float32."""
    dtype = compute_dtype(cfg)
    out = raft.prepare(params, cfg)
    for k, v in params.items():
        if k.startswith("transformer."):
            out[k] = v.to(dtype)
    return out


def backbone(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`CNNEncoder` on normalized images [N,3,H,W] -> (1/4, 1/8) features
    [N,C,H/4,W/4], [N,C,H/8,W/8], channels-last."""
    f = raft.encode(p, "backbone", x, "instance", strides=(1, 2, 1))
    w = p["backbone.trident_conv.weight"]
    return F.conv2d(f, w, padding=1), F.conv2d(f, w, stride=2, padding=1)


def position(h: int, w: int, splits: int, device) -> torch.Tensor:
    """GMFlow's `PositionEmbeddingSine` (DETR's, normalized, temperature
    10000) of a window of h/splits x w/splits, tiled over the h x w map:
    [H,W,C] float32, C/2 channels of y then C/2 of x, each sin and cos
    interleaved."""
    wh, ww, npf = h // splits, w // splits, C // 2
    scale, eps = 2 * math.pi, 1e-6
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = 10000 ** (2 * (dim_t // 2) / npf)

    def axis(n):
        e = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        e = (e / (e[-1:] + eps) * scale)[:, None] / dim_t
        return torch.stack((e[:, 0::2].sin(), e[:, 1::2].cos()), dim=2).flatten(1)  # [n, npf]

    pos = torch.cat([axis(wh)[:, None].expand(wh, ww, npf), axis(ww)[None].expand(wh, ww, npf)], -1)
    return pos.repeat(splits, splits, 1)


def shift_mask(h: int, w: int, splits: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The shifted windows' attention mask [1, splits^2, L, L] (L the tokens of
    a window): 0 between tokens of one region of the rolled map, -100
    between regions, as Swin's and GMFlow's `generate_shift_window_attn_mask`.
    Its rows are laid out 16-aligned, so that the attention kernels take it
    as it is."""
    wh, ww = h // splits, w // splits
    sh, sw = wh // 2, ww // 2
    region = torch.zeros((h, w), device=device)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            region[hs, ws] = cnt
            cnt += 1
    region = region.view(splits, wh, splits, ww).transpose(1, 2).reshape(splits * splits, wh * ww)
    n = wh * ww
    out = torch.zeros((1, splits * splits, n, -(-n // 16) * 16), dtype=dtype, device=device)[..., :n]
    out.masked_fill_(region[:, None, :] != region[:, :, None], SWIN_MASK)
    return out


def window_order(h: int, w: int, splits: int, shifted: bool, device) -> torch.Tensor:
    """Tokens laid out window by window (windows row-major, tokens row-major
    inside a window; `shifted`: the windows of the map rolled by half a
    window up and left, as Swin's `torch.roll`): for each place of that
    layout, the index of its token in the row-major h x w map, [h w] int64."""
    wh, ww = h // splits, w // splits
    y = torch.arange(h, device=device).view(splits, wh, 1, 1)
    x = torch.arange(w, device=device).view(1, 1, splits, ww)
    if shifted:
        y, x = (y + wh // 2) % h, (x + ww // 2) % w
    return (y * w + x).permute(0, 2, 1, 3).reshape(-1)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int,
                     mask: torch.Tensor = None) -> torch.Tensor:
    """Single-head attention within each of the splits x splits windows
    (GMFlow's `single_head_split_window_attention`) of tokens [B,L,C] laid
    out window by window (`window_order`); `mask` (`shift_mask`) for the
    shifted windows. Unmasked, the windows go to the kernel as the batch;
    masked, as heads, so that the mask broadcasts over the batch."""
    b, l, c = q.shape
    k2 = splits * splits
    if mask is None:
        out = F.scaled_dot_product_attention(*(t.view(b * k2, 1, l // k2, c) for t in (q, k, v)))
    else:
        out = F.scaled_dot_product_attention(*(t.view(b, k2, l // k2, c) for t in (q, k, v)), attn_mask=mask)
    return out.reshape(b, l, c)


def attention_layer(p: Mapping[str, torch.Tensor], name: str, src: torch.Tensor, tgt: torch.Tensor,
                    splits: int, mask: torch.Tensor = None) -> torch.Tensor:
    """`TransformerLayer` `name` on tokens [B,L,C] laid out window by window:
    src + LN1(merge(attn)) without an FFN, src + LN2(FFN([src; LN1(merge(attn))]))
    with one."""
    c = src.shape[-1]
    q = F.linear(src, p[name + ".q_proj.weight"])
    k = F.linear(tgt, p[name + ".k_proj.weight"])
    v = F.linear(tgt, p[name + ".v_proj.weight"])
    m = F.linear(window_attention(q, k, v, splits, mask), p[name + ".merge.weight"])
    m = F.layer_norm(m, (c,), p[name + ".norm1.weight"], p[name + ".norm1.bias"], 1e-5)
    if name + ".mlp.0.weight" in p:
        m = F.gelu(F.linear(torch.cat([src, m], dim=-1), p[name + ".mlp.0.weight"]))
        m = F.layer_norm(F.linear(m, p[name + ".mlp.2.weight"]), (c,), p[name + ".norm2.weight"],
                         p[name + ".norm2.bias"], 1e-5)
    return src + m


def transformer(p: Mapping[str, torch.Tensor], f0: torch.Tensor, f1: torch.Tensor, splits: int,
                blocks: int = BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """`FeatureTransformer` on the two frames' tokens [N,H,W,C]: both are
    updated, [F0; F1] attending to [F1; F0] as one batch; each block's
    cross-attention attends to the other frame as the block received it.
    Odd blocks shift their windows. Every layer but the attention works
    token by token, so the tokens stay laid out window by window (one gather
    into the layout of each block's windows), not split and rolled a layer."""
    n, h, w, c = f0.shape
    x = torch.cat([f0, f1]).view(2 * n, h * w, c)
    orders = [window_order(h, w, splits, s, x.device) for s in (False, True)]
    inverse = [torch.argsort(o) for o in orders]
    mask = shift_mask(h, w, splits, x.dtype, x.device)
    layout = None  # row-major
    for i in range(blocks):
        shifted = i % 2 == 1
        x = x[:, orders[shifted] if layout is None else inverse[layout][orders[shifted]]]
        layout = shifted
        blk = f"transformer.layers.{i}."
        m = mask if shifted else None
        tgt = torch.cat([x[n:], x[:n]])
        x = attention_layer(p, blk + "self_attn", x, x, splits, m)
        x = attention_layer(p, blk + "cross_attn_ffn", x, tgt, splits, m)
    x = x[:, inverse[layout]].view(2 * n, h, w, c)
    return x[:n], x[n:]


def attn_flops(n: int, h: int, w: int, splits: int) -> float:
    """Operations of the attention products (QK and PV) of one
    `transformer` call on n pairs at h x w, 2 layers a block: each of
    2n h w tokens against the h w / splits^2 of its window, 2 C operations a
    key for QK and 2 C for PV."""
    window = (h // splits) * (w // splits)
    return 2 * BLOCKS * 4.0 * window * C * 2 * n * h * w


def logits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T / sqrt(C) of float32 a [N,L,C] and b [N,S,C]: [N,L,S] float32
    (TF32 off: `estimate_flow_pairs` pins it), the scale applied by the
    product's epilogue."""
    return torch.baddbmm(a.new_zeros(()), a, b.transpose(1, 2), beta=0.0, alpha=1.0 / math.sqrt(a.shape[-1]))


def softmax_product(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(a b^T / sqrt(C)) v over every row, in float32: a [N,L,C],
    b [N,S,C], v [N,S,D] -> [N,L,D]. The logits and their softmax are the
    chunk's transient (`pair_chunk`)."""
    return torch.bmm(torch.softmax(logits(a, b), dim=-1), v)


def _grid(h: int, w: int, device) -> torch.Tensor:
    """Pixel coordinates (x, y) of an h x w map, [h w, 2] float32."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return torch.stack([xx, yy], dim=-1).view(h * w, 2)


def global_match(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """GMFlow's `global_correlation_softmax`: flow [N,2,H,W] float32 of tokens
    [N,H,W,C], P G - G with P the softmax over every position of the other
    frame and G the coordinate grid."""
    n, h, w, c = f0.shape
    grid = _grid(h, w, f0.device)
    a, b = f0.float().reshape(n, h * w, c), f1.float().reshape(n, h * w, c)
    flow = softmax_product(a, b, grid.expand(n, h * w, 2)) - grid
    return flow.view(n, h, w, 2).permute(0, 3, 1, 2)


def _offsets(radius: int, device) -> torch.Tensor:
    """The (dx, dy) of candidate k = (dy+r)(2r+1) + (dx+r), [(2r+1)^2, 2] float32."""
    d = torch.arange(-radius, radius + 1, device=device, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx, dy], dim=-1).view(-1, 2)


def local_match(f0: torch.Tensor, f1: torch.Tensor, radius: int) -> torch.Tensor:
    """GMFlow's `local_correlation_softmax`: the flow [N,2,H,W] float32 of
    tokens [N,H,W,C] within radius r: the logits F0(p) F1(p+d) / sqrt(C) of
    the (2r+1)^2 integer displacements (`cost_volume`'s channel mean times
    sqrt(C)), -1e9 where p+d lies outside the map, their softmax times d."""
    n, h, w, c = f0.shape
    corr = cost_volume(f0.float().contiguous(), f1.float().contiguous(), radius).mul_(math.sqrt(c))
    d = _offsets(radius, f0.device)
    xx, yy = _grid(h, w, f0.device).view(h, w, 1, 2).unbind(-1)
    tx, ty = xx + d[:, 0], yy + d[:, 1]  # [H,W,K]
    outside = (tx < 0) | (tx >= w) | (ty < 0) | (ty >= h)
    prob = torch.softmax(corr.masked_fill_(outside, -1e9), dim=-1)
    return (prob.view(n, h * w, -1) @ d).view(n, h, w, 2).permute(0, 3, 1, 2)


def propagate(p: Mapping[str, torch.Tensor], f0: torch.Tensor, flow: torch.Tensor,
              radius: int) -> torch.Tensor:
    """GMFlow's `FeatureFlowAttention` in float32: q = Wq F0 + bq, k = Wk q +
    bk (the key projected from the projected query, as published); flow
    [N,2,H,W] <- the softmax of q k / sqrt(C) times the flow, over every
    position (radius < 0) or the (2r+1)^2 neighbours, keys and flow
    zero-padded at the border (radius r)."""
    n, h, w, c = f0.shape
    a = "feature_flow_attn."
    q = F.linear(f0.float(), p[a + "q_proj.weight"], p[a + "q_proj.bias"])
    k = F.linear(q, p[a + "k_proj.weight"], p[a + "k_proj.bias"])
    if radius < 0:
        v = flow.permute(0, 2, 3, 1).reshape(n, h * w, 2)
        out = softmax_product(q.view(n, h * w, c), k.view(n, h * w, c), v)
        return out.view(n, h, w, 2).permute(0, 3, 1, 2)
    prob = torch.softmax(cost_volume(q, k, radius).mul_(math.sqrt(c)), dim=-1)  # [N,H,W,K]
    kk = (2 * radius + 1) ** 2
    win = F.unfold(flow, 2 * radius + 1, padding=radius).view(n, 2, kk, h, w)
    return (win * prob.permute(0, 3, 1, 2).unsqueeze(1)).sum(dim=2)


def match_flops(n: int, h: int, w: int, radius: int) -> float:
    """Operations of one matching of n pairs of h x w maps: the logits and
    their products with the coordinates (global) or displacements (local)."""
    px = h * w
    k = px if radius < 0 else (2 * radius + 1) ** 2
    return n * px * (2.0 * k * C + 4.0 * k)


def propagate_flops(n: int, h: int, w: int, radius: int) -> float:
    """Operations of one propagation of n pairs: the two projections, the
    logits and their product with the flow."""
    return n * h * w * 4.0 * C * C + match_flops(n, h, w, radius)


def warp(f1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """GMFlow's `flow_warp`: tokens [N,H,W,C] sampled bilinearly at p +
    flow(p), zeros outside (`grid_sample`, align_corners=True), in float32;
    returned in f1's dtype."""
    n, h, w, c = f1.shape
    xx, yy = _grid(h, w, f1.device).view(h, w, 2).unbind(-1)
    gx = 2 * (xx + flow[:, 0]) / (w - 1) - 1
    gy = 2 * (yy + flow[:, 1]) / (h - 1) - 1
    out = F.grid_sample(f1.permute(0, 3, 1, 2).float(), torch.stack([gx, gy], dim=-1),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).to(f1.dtype).contiguous()


def tokens(x: torch.Tensor) -> torch.Tensor:
    """[N,C,H,W] features -> [N,H,W,C] tokens (a view of channels-last memory)."""
    return x.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def estimate_flow_pairs(p: Mapping[str, torch.Tensor], frames: torch.Tensor,
                        cfg: GmflowConfig = GmflowConfig()) -> torch.Tensor:
    """Consecutive-pair flow over a clip, [T,H,W,3] in [0, 1] ->
    [T-1,H,W,2] float32; `p` is `prepare`'s cast of the state dict. The
    backbone encodes each frame once, shared by the two pairs it belongs to."""
    pin_full_f32()
    dtype, dev = compute_dtype(cfg), frames.is_cuda
    t, h, w, _ = frames.shape
    mean = torch.tensor(MEAN, device=frames.device)
    std = torch.tensor(STD, device=frames.device)
    x = ((frames.float() - mean) / std).permute(0, 3, 1, 2).to(dtype)
    x, pads = raft.pad_to(x.contiguous(memory_format=_CL), PAD)
    with trace.span("vstab.flow.gmflow.encode", device=dev, frames=t):
        feats = backbone(p, x)[::-1]  # 1/8, then 1/4
    n = t - 1
    flow = None
    for (scale, splits, corr_r, prop_r), feat in zip(SCALES, feats):
        hs, ws = feat.shape[-2:]
        f0, f1 = tokens(feat[:-1]), tokens(feat[1:])
        if flow is not None:
            flow = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2
            f1 = warp(f1, flow)
        pos = position(hs, ws, splits, frames.device)
        f0, f1 = (f0.float() + pos).to(dtype), (f1.float() + pos).to(dtype)
        with trace.span("vstab.flow.gmflow.transformer", device=dev, scale=scale, tokens=hs * ws,
                        window_tokens=(hs // splits) * (ws // splits),
                        attn_flops=attn_flops(n, hs, ws, splits)):
            f0, f1 = transformer(p, f0, f1, splits)
        kind = "global" if corr_r < 0 else "local"
        with trace.span("vstab.flow.gmflow.match", device=dev, scale=scale, kind=kind,
                        match_flops=match_flops(n, hs, ws, corr_r)):
            step = global_match(f0, f1) if corr_r < 0 else local_match(f0, f1, corr_r)
        flow = step if flow is None else flow + step
        with trace.span("vstab.flow.gmflow.propagate", device=dev, scale=scale, radius=prop_r,
                        prop_flops=propagate_flops(n, hs, ws, prop_r)):
            flow = propagate(p, f0, flow, prop_r)
    with trace.span("vstab.flow.gmflow.upsample", device=dev):
        x = torch.cat([flow.to(dtype), f0.permute(0, 3, 1, 2)], dim=1).contiguous(memory_format=_CL)
        up = raft.convex_upsample(p, "upsampler", x, flow, 4)
        up = up[:, :, pads[2] : pads[2] + h, pads[0] : pads[0] + w]
        return up.permute(0, 2, 3, 1).contiguous()


def match_bytes(h: int, w: int) -> int:
    """Bytes of one pair's transient global matching at h x w frames: the
    float32 logits over the 1/8 grid of the padded frame, and their softmax."""
    px = (-(-h // PAD) * PAD // 8) * (-(-w // PAD) * PAD // 8)
    return 2 * 4 * px * px


def pair_chunk(h: int, w: int, cfg: GmflowConfig, chunk: int) -> int:
    """Pairs in one chunk of `clip_flow` for GMFlow at h x w: `chunk` (the
    PWC-Net default), lowered until the chunk's global-matching logits and
    softmax fit a budget of 16 GB (`cfg` as `raft.pair_chunk` takes its own). One pair's are 2 x 4 (HW/64)^2 bytes of
    the padded frame: 1.73 GB at 720p (8 pairs, 13.9 GB), 8.5 GB at 1080p
    (1 pair); at 4K (136 GB) none fits, and this raises."""
    one = match_bytes(h, w)
    fit = int(MATCH_BUDGET // one)
    if fit < 1:
        raise ValueError(
            f"GMFlow's global matching of one {h}x{w} pair takes {one / 1e9:.1f} GB of logits and "
            f"softmax, more than the {MATCH_BUDGET / 1e9:.0f} GB budget of a chunk: frames this "
            "large do not fit"
        )
    return min(chunk, fit)


__all__ = [
    "attention_layer",
    "attn_flops",
    "backbone",
    "estimate_flow_pairs",
    "global_match",
    "init_params",
    "local_match",
    "logits",
    "match_bytes",
    "match_flops",
    "pair_chunk",
    "param_shapes",
    "position",
    "prepare",
    "propagate",
    "propagate_flops",
    "shift_mask",
    "softmax_product",
    "transformer",
    "warp",
    "window_attention",
    "window_order",
]
