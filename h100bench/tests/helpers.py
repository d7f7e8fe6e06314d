"""Cells of BENCHMARK.json cut to sizes the CPU runs in seconds."""

import copy

from h100bench import harness

TINY_FLOW = {"pyramid_channels": [4, 8, 8, 8, 8, 8], "estimator_channels": [8, 8, 8, 8, 8],
             "context_dilations": [1, 2]}


def tiny_cell(name: str, tiny_net: bool = False, frames: int = 9, hw=(64, 96)):
    """(cell, params): the cell with its traffic cut to a few small clips
    (or scenes and a batch of 2 at 64x64), its blocks to 4 frames; with
    tiny_net a narrow network from a seed, else params None (the cell's
    checkpoint at its published widths)."""
    cell = harness.Cell.find(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic)
    cell.spec = copy.deepcopy(cell.spec)
    if "frames" in cell.traffic:
        cell.traffic.update(frames=frames, height=hw[0], width=hw[1], clips=2)
    else:
        cell.traffic.update(scenes=6, height=64, width=64)
        cell.config["recipe"].update(hw=[64, 64], batch=2, scan_len=2)
    if "block_len" in cell.spec:
        cell.spec["block_len"] = 4
    params = None
    if tiny_net:
        from vstab_torch.core.config import FlowConfig
        from vstab_torch.flow.pwcnet import init_params

        flow = cell.config["program"]["flow"]
        flow.update(TINY_FLOW)
        fc = FlowConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in flow.items()})
        params = init_params(0, fc, device="cpu")
    return cell, params
