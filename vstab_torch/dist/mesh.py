"""The ("data", "time") layout of the ranks, the port of `vstab/dist/mesh.py`.

One process drives one device. Its rank in the `torch.distributed` world
takes the place of a device in the reference's mesh: ranks are laid out
row-major on a d x t grid, each row is a "time" group (the ranks that share
one clip, each holding a contiguous slice of its frames) and each column a
"data" group (ranks that hold different clips). The collectives of
`vstab_torch.dist` run over these groups: gloo for CPU tensors, NCCL for
CUDA tensors.

The reference's sharding objects (`clip_sharding`, `batch_sharding`,
`replicated`) have no torch counterpart: a rank holds its own slice, and
`time_slice` says which.

With no process group initialized the world is one rank and the mesh is
1 x 1, as the reference's default mesh on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from vstab_torch.core.config import DistConfig

DATA_AXIS = "data"
TIME_AXIS = "time"


def group_size(group) -> int:
    """Ranks in `group` (the world when None); 1 with no process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group) -> int:
    """This process's rank within `group`; 0 with no process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def global_rank(group, rank: int) -> int:
    """The world rank of `group`'s member `rank`."""
    return rank if group is None else dist.get_global_rank(group, rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the d x t grid: `shape` {"data": d, "time": t},
    its row (`data_index`) and column (`time_index`), and the process groups
    of its row (`time_group`) and column (`data_group`). The groups are None
    in a world of one; a rank past the first d*t has no place (indices and
    groups None)."""

    shape: Dict[str, int]
    data_index: Optional[int]
    time_index: Optional[int]
    data_group: Optional[dist.ProcessGroup] = None
    time_group: Optional[dist.ProcessGroup] = None


def _axis_sizes(cfg: Optional[DistConfig], world: int):
    """The reference's rule: an axis size of 0 / None absorbs the ranks the
    other axis leaves; both 0 / None is 1 x world."""
    d = cfg.data_axis if cfg else 1
    t = cfg.time_axis if cfg else 1
    if not d and not t:
        d, t = 1, world
    elif not d:
        d = world // t
    elif not t:
        t = world // d
    if d * t > world:
        raise ValueError(f"mesh {d}x{t} needs {d * t} devices, have {world}")
    return d, t


def make_mesh(cfg: Optional[DistConfig] = None) -> Mesh:
    """Build the ("data", "time") mesh over the ranks of the world.

    Axis sizes come from cfg (both 1 by default). Where the process group is
    initialized this is a collective call: every rank of the world must make
    it, with the same cfg and in the same order, since each group of the
    grid is made by `dist.new_group`. A group that spans the whole world is
    the world's own group; build the mesh once and pass it to each call."""
    world = group_size(None)
    d, t = _axis_sizes(cfg, world)
    shape = {DATA_AXIS: d, TIME_AXIS: t}
    if not dist.is_initialized():
        return Mesh(shape, 0, 0)
    rank = dist.get_rank()

    def grid_group(ranks):
        if len(ranks) == world:
            return dist.group.WORLD
        return dist.new_group(ranks)

    rows = [grid_group([i * t + j for j in range(t)]) for i in range(d)]
    cols = [grid_group([i * t + j for i in range(d)]) for j in range(t)]
    if rank >= d * t:
        return Mesh(shape, None, None)
    i, j = divmod(rank, t)
    return Mesh(shape, i, j, data_group=cols[j], time_group=rows[i])


def time_size(mesh: Mesh) -> int:
    return mesh.shape[TIME_AXIS]


def time_slice(t_pad: int, mesh: Mesh) -> slice:
    """The frames [r*t_loc, (r+1)*t_loc) of a clip of t_pad frames that the
    rank at time index r holds; t_pad must be a multiple of the time size."""
    n = time_size(mesh)
    if t_pad % n:
        raise ValueError(f"{t_pad} frames do not split over {n} time ranks")
    if mesh.time_index is None:
        raise ValueError("this rank has no place on the mesh")
    t_loc = t_pad // n
    return slice(mesh.time_index * t_loc, (mesh.time_index + 1) * t_loc)


__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "Mesh",
    "global_rank",
    "group_rank",
    "group_size",
    "make_mesh",
    "time_size",
    "time_slice",
]
