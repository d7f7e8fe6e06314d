"""Distributed runtime of the port: the ("data", "time") layout of the
ranks, halo exchange, the distributed Schur solve, the time-sharded pipeline
and the multi-process bring-up, on `torch.distributed` (the port of
`vstab/dist/`)."""

from vstab_torch.dist.mesh import DATA_AXIS, TIME_AXIS, Mesh, make_mesh, time_size, time_slice
from vstab_torch.dist.halo import (
    exclusive_prefix_sum,
    extend_right,
    shift_from_next,
    shift_from_prev,
)
from vstab_torch.dist.schur_dist import schur_solve_shard
from vstab_torch.dist.pipeline_dist import stabilize_sharded
from vstab_torch.dist.init import initialize, shutdown

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "Mesh",
    "make_mesh",
    "time_size",
    "time_slice",
    "shift_from_next",
    "shift_from_prev",
    "extend_right",
    "exclusive_prefix_sum",
    "schur_solve_shard",
    "stabilize_sharded",
    "initialize",
    "shutdown",
]
