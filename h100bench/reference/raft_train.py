"""RAFT's training step written out plainly (Teed & Deng, ECCV 2020, arXiv
2003.12039; princeton-vl/RAFT `core/raft.py` `forward(..., test_mode=False)`,
`train.py` `sequence_loss`, `fetch_optimizer`): the forward with `cnet`'s
batch norm in training mode, the sequence loss, the gradient by autograd
through the plain network (the lookup by `grid_sample`), a global-norm clip,
AdamW and the linear one-cycle schedule. Built on `reference/raft.py`'s
layers; the batches are `reference/train.py`'s.

Float32 with TF32 off; under the "tf32" policy the operands of every
convolution are rounded to TF32 (`precision.lowp`) and the caller turns
TF32 on for the correlation's matmul. It is also the oracle that
`tests/test_torch_raft_train.py` holds the program's RAFT training to on
the CPU.

Names: the shortcut's norm of a strided residual block is one module under
two names in RAFT's state dict (`norm3` and `downsample.1`); here it is
`norm3` alone, as the program's parameters name it, and `downsample.1` is
left out of the trained state.

Imports nothing of `vstab_torch`, JAX or `vstab`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from h100bench.reference import raft as ref_raft
from h100bench.reference import train as ref_train

BETAS, EPS = (0.9, 0.999), 1e-8
BN_MOMENTUM, BN_EPS = 0.1, 1e-5
STATS = ("running_mean", "running_var")


def trained_state(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """float32 copies of the state a step changes or reads, by the
    program's names (no `downsample.1`, no batch counts)."""
    return {k: v.detach().float().clone() for k, v in params.items()
            if ".downsample.1." not in k and not k.endswith("num_batches_tracked")}


def is_stat(name: str) -> bool:
    return name.endswith(STATS)


def _bn_train(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm2d in training mode: the batch's mean and biased variance
    normalise; the running mean and the unbiased variance are blended in
    with momentum 0.1."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    y = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + BN_EPS)
    y = y * p[name + ".weight"].view(1, -1, 1, 1) + p[name + ".bias"].view(1, -1, 1, 1)
    with torch.no_grad():
        m = x.numel() // x.shape[1]
        rm, rv = p[name + ".running_mean"], p[name + ".running_var"]
        rm.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
        rv.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var.detach() * m / (m - 1))
    return y


def cnet_train(p: Dict[str, torch.Tensor], x: torch.Tensor, policy: str) -> torch.Tensor:
    """`cnet`, the BasicEncoder with batch norm, in training mode."""
    conv = ref_raft._conv
    relu = torch.relu
    x = relu(_bn_train(p, "cnet.norm1", conv(p, "cnet.conv1", x, policy, 2, 3)))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for i, s in ((0, stride), (1, 1)):
            b = f"cnet.{layer}.{i}"
            y = relu(_bn_train(p, b + ".norm1", conv(p, b + ".conv1", x, policy, s, 1)))
            y = relu(_bn_train(p, b + ".norm2", conv(p, b + ".conv2", y, policy, 1, 1)))
            if s != 1:
                x = _bn_train(p, b + ".norm3", conv(p, b + ".downsample.0", x, policy, s))
            x = relu(x + y)
    return conv(p, "cnet.conv2", x, policy)


def forward(p: Dict[str, torch.Tensor], im1: torch.Tensor, im2: torch.Tensor, cfg: Mapping,
            policy: str = "f32") -> List[torch.Tensor]:
    """The `iters` upsampled flows [N,H,W,2] of pairs [N,H,W,3] in [0, 1]
    (H, W multiples of 8); updates `p`'s running statistics."""
    n = im1.shape[0]
    x = 2.0 * torch.cat([im1, im2]).float().permute(0, 3, 1, 2).contiguous() - 1.0
    fmap = ref_raft.encoder(p, "fnet", x, False, policy)
    ctx = cnet_train(p, x[:n], policy)
    hidden = cfg["hidden"]
    net, inp = torch.tanh(ctx[:, :hidden]), torch.relu(ctx[:, hidden:])
    pyramid = ref_raft.corr_pyramid(fmap[:n], fmap[n:], cfg["corr_levels"])
    _, _, h, w = fmap.shape
    yy, xx = torch.meshgrid(torch.arange(h, device=x.device), torch.arange(w, device=x.device),
                            indexing="ij")
    coords0 = torch.stack([xx, yy], dim=0).float()[None].repeat(n, 1, 1, 1)
    coords1 = coords0.clone()
    preds = []
    for _ in range(cfg["iters"]):
        coords1 = coords1.detach()
        corr = ref_raft.lookup(pyramid, coords1, cfg["corr_radius"])
        net, delta = ref_raft.update(p, net, inp, corr, coords1 - coords0, policy)
        coords1 = coords1 + delta
        preds.append(ref_raft.upsample(p, net, coords1 - coords0, policy).permute(0, 2, 3, 1))
    return preds


def sequence_loss(preds: List[torch.Tensor], gt: torch.Tensor, gamma: float,
                  max_flow: float) -> torch.Tensor:
    """sum_i gamma^(n-1-i) mean(valid |pred_i - gt|), valid = |gt| < max_flow."""
    valid = (torch.sqrt(torch.sum(gt**2, dim=-1)) < max_flow).float()[..., None]
    n = len(preds)
    return sum(gamma ** (n - 1 - i) * torch.mean(valid * torch.abs(fl - gt)) for i, fl in enumerate(preds))


def one_cycle(step: int, steps: int, pct_start: float, div_factor: float,
              final_div_factor: float) -> float:
    """The rate's factor of its peak: linear from 1/div_factor up to 1 at
    step pct_start steps - 1, then linear down to 1/(div_factor
    final_div_factor) at step steps - 1 (torch's OneCycleLR, two phases)."""
    lo = 1.0 / div_factor
    end = lo / final_div_factor
    up = pct_start * steps - 1.0
    if step <= up:
        return lo + (1.0 - lo) * step / up
    return 1.0 + (end - 1.0) * (step - up) / (steps - 1.0 - up)


class AdamW:
    """Global-norm clip (clip / max(norm, clip)), then AdamW with decoupled
    weight decay on every leaf, at the one-cycle rate."""

    def __init__(self, params: Dict[str, torch.Tensor], recipe: Mapping):
        self.p, self.r = params, recipe
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates the parameters; returns the clipped gradients."""
        r = self.r
        lr = r["lr"] * one_cycle(self.t, r["schedule_steps"], r["pct_start"], r["div_factor"],
                                 r["final_div_factor"])
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
        recipe: Mapping, steps: int, policy: str = "f32") -> Dict[str, object]:
    """`steps` steps from params0 on the batches of `seed`: {'batches',
    'losses', 'grad1' (the first step's clipped gradient by leaf), 'params'
    (the leaves after the last step), 'stats' (cnet's running statistics
    after it)}."""
    state = trained_state(params0)
    leaves = {k: v for k, v in state.items() if not is_stat(k)}
    opt = AdamW(leaves, recipe)
    gen = torch.Generator(device=scenes.device).manual_seed(seed)
    out: Dict[str, List] = {"batches": [], "losses": []}
    n, hw = recipe["batch"], tuple(recipe["hw"])
    for i in range(steps):
        b = ref_train.batch(scenes, ref_train.draw(gen, scenes.shape[0], n, hw), recipe["max_disp"])
        p = {k: (v.detach().requires_grad_(True) if k in leaves else v) for k, v in state.items()}
        preds = forward(p, b["im1"], b["im2"], cfg, policy)
        value = sequence_loss(preds, b["flow"], recipe["gamma"], recipe["max_flow"])
        del preds
        grads = dict(zip(leaves, torch.autograd.grad(value, [p[k] for k in leaves])))
        clipped = opt.step(grads)
        if i == 0:
            out["grad1"] = clipped
        out["batches"].append(b)
        out["losses"].append(float(value.detach()))
    out["params"] = leaves
    out["stats"] = {k: v for k, v in state.items() if is_stat(k)}
    return out


__all__ = ["AdamW", "cnet_train", "forward", "is_stat", "one_cycle", "run", "sequence_loss",
           "trained_state"]
