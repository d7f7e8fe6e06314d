"""The numbers compared between a candidate (the program's outputs, or a
control's) and the reference, and the sampling of what is judged.

Stabilizer, per clip (a run compares the mean over the clips it judges of
each number its workload file gives a limit for):
- step_mean_px: the mean gap of each pair's vertex motion (px), the flow
  pooled per cell;
- path_mean_px: the same of the stabilizing displacements (px), the paths
  less their smoothed solution;
- frame_mad: the worst frame's mean absolute difference of the output
  (intensity in [0, 1]), which a wrong region of every frame moves;
  frame_median: the worst frame's median absolute difference, which a
  wrong region of a frame does not move and a wrong frame does.
Trainer, over the first steps:
- batch_max: the widest gap of the batches (image intensity, flow px);
- loss_rel: the widest relative gap of a step's loss;
- grad_median: over the leaves of the first clipped gradient, the median of
  |norm - norm_ref| over the larger of norm_ref and the median leaf's
  norm_ref;
- update_median: the same of each leaf's change over the steps, leaving out
  leaves whose reference gradient is under a thousandth of the median
  leaf's (a bias under a softmax-like invariance moves by round-off alone).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn
    from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def frame_gaps(cand_blocks: Iterable[Tuple[int, torch.Tensor]],
               ref_blocks: Iterable[Tuple[int, torch.Tensor]]) -> Dict[str, float]:
    """frame_mad and frame_median over two block streams of one clip."""
    mads, meds = [], []
    for (s1, a), (s2, b) in zip(cand_blocks, ref_blocks):
        if s1 != s2 or a.shape != b.shape:
            raise ValueError(f"blocks at {s1} {tuple(a.shape)} and {s2} {tuple(b.shape)} differ")
        d = (a.float() - b.float()).abs().flatten(1)
        mads.append(d.mean(dim=1))
        meds.append(d.median(dim=1).values)
    mad, med = torch.cat(mads), torch.cat(meds)
    return {"frame_mad": float(mad.max()), "frame_median": float(med.max())}


def stabilizer_readings(cand: Mapping, ref: Mapping) -> Dict[str, float]:
    """The compared numbers of one clip. Both hold 'frames' (a stream of
    (start, block)); where the candidate holds 'profiles' and 'disp', the
    path's numbers too."""
    out: Dict[str, float] = {}
    if cand.get("profiles") is not None:
        step = (torch.diff(cand["profiles"].float(), dim=0) - torch.diff(ref["profiles"], dim=0)).abs()
        out.update(step_mean_px=float(step.mean()),
                   path_mean_px=float((cand["disp"].float() - ref["disp"]).abs().mean()))
    out.update(frame_gaps(cand["frames"], ref["frames"]))
    return out


def run_checks(judged: List[Mapping[str, float]], limits: Mapping[str, float]) -> Dict[str, Dict]:
    """A run's compared numbers: each the mean of its readings over the clips
    the run judged, beside its limit."""
    return {name: {"value": sum(r[name] for r in judged) / len(judged), "limit": float(limit)}
            for name, limit in limits.items()}


def blocks_of(frames, block: int, device) -> Iterable[Tuple[int, torch.Tensor]]:
    """(start, frames[start:start+block] on device) over a tensor or array."""
    for s in range(0, frames.shape[0], block):
        yield s, torch.as_tensor(frames[s : s + block]).to(device)


def _leaf_gaps(cand: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
               keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Per leaf: |norm(cand) - norm(ref)| over max(norm(ref), the median leaf's)."""
    names = list(ref) if keep is None else keep
    rn = {k: float(ref[k].double().norm()) for k in ref}
    median = float(torch.tensor(sorted(rn.values())).median())
    return {k: abs(float(cand[k].double().norm()) - rn[k]) / max(rn[k], median) for k in names}


def leaf_gaps(cand: Mapping, ref: Mapping, params0: Mapping[str, torch.Tensor]
              ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The per-leaf gaps of the first clipped gradient and of the change over
    the steps (moving leaves only), by leaf name. Both hold 'grad1' (the
    first clipped gradient by leaf) and 'params' (after the steps)."""
    gn = {k: float(v.double().norm()) for k, v in ref["grad1"].items()}
    median = float(torch.tensor(sorted(gn.values())).median())
    moving = [k for k in gn if gn[k] >= 1e-3 * median]
    d_cand = {k: cand["params"][k].float() - params0[k].float() for k in params0}
    d_ref = {k: ref["params"][k].float() - params0[k].float() for k in params0}
    return _leaf_gaps(cand["grad1"], ref["grad1"]), _leaf_gaps(d_cand, d_ref, moving)


def trainer_readings(cand: Mapping, ref: Mapping, params0: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of the first steps. Both hold 'batches',
    'losses', 'grad1' and 'params' (see `leaf_gaps`)."""
    batch_max = 0.0
    for bc, br in zip(cand["batches"], ref["batches"]):
        for key in ("im1", "im2", "flow"):
            batch_max = max(batch_max, float((bc[key].float() - br[key]).abs().max()))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cand["losses"], ref["losses"]))
    grad, update = leaf_gaps(cand, ref, params0)
    return {
        "batch_max": batch_max,
        "loss_rel": loss_rel,
        "grad_median": float(torch.tensor(list(grad.values()), dtype=torch.float64).median()),
        "update_median": float(torch.tensor(list(update.values()), dtype=torch.float64).median()),
    }
