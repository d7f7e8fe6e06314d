"""Multi-process bring-up, the port of `vstab/dist/init.py`.

One process per device. `initialize` starts the `torch.distributed` world
from a `DistConfig`, retrying with a growing wait; after it, `make_mesh`
lays the ranks out and the same code runs on one process or many.
"""

from __future__ import annotations

import logging
import time

import torch
import torch.distributed as dist

from vstab_torch.core.config import DistConfig

log = logging.getLogger("vstab_torch.dist")

# The backend of every process group the port starts: gloo for CPU tensors
# and NCCL for CUDA tensors, or gloo alone where torch has no NCCL.
BACKEND = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def initialize(cfg: DistConfig, retries: int = 3, backoff_s: float = 5.0) -> None:
    """Start the process group from cfg: `coordinator_address` ("host:port",
    served by rank 0), `num_processes`, `process_id`. A no-op for one
    process or no address. The backend is `BACKEND`. With CUDA, the process
    takes the device `process_id % devices`."""
    if cfg.coordinator_address is None or cfg.num_processes <= 1:
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(cfg.process_id % torch.cuda.device_count())
    last = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend=BACKEND,
                init_method=f"tcp://{cfg.coordinator_address}",
                world_size=cfg.num_processes,
                rank=cfg.process_id,
            )
            log.info("torch.distributed up: process %d/%d, backend %s",
                     cfg.process_id, cfg.num_processes, BACKEND)
            return
        except Exception as e:  # noqa: BLE001 - retry any bring-up failure
            last = e
            log.warning("distributed init attempt %d failed: %s", attempt, e)
            time.sleep(backoff_s * (attempt + 1))
    raise RuntimeError(f"torch.distributed.init_process_group failed after {retries} tries") from last


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["BACKEND", "initialize", "shutdown"]
