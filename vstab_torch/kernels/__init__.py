"""Hand-written CUDA kernels of the port, each beside its plain torch version.

Every wrapper runs the plain version for CPU tensors, launches its kernel for
CUDA tensors, and raises on anything else. `KERNELS` maps each kernel's name
to its `CudaKernel`, whose `launches` attribute counts its launches;
`KERNELS_BWD` does the same for the two backward kernels that training runs
(the gradients of the cost volume and of the feature warp), which no
serving path launches, and `KERNELS_RAFT` for the kernels that only the RAFT
flow network launches (its correlation lookup, and that lookup's backward,
which only RAFT's training launches).
"""

from vstab_torch.kernels import corr_lookup as _corr
from vstab_torch.kernels import cost_volume as _cv
from vstab_torch.kernels import warp as _warp
from vstab_torch.kernels import warp1d as _warp1d
from vstab_torch.kernels.corr_lookup import (
    corr_lookup,
    corr_lookup_backward,
    corr_lookup_backward_plain,
    corr_lookup_plain,
)
from vstab_torch.kernels.cost_volume import (
    cost_volume,
    cost_volume_backward,
    cost_volume_backward_plain,
    cost_volume_plain,
)
from vstab_torch.kernels.warp import (
    bilinear_warp,
    bilinear_warp_backward,
    bilinear_warp_backward_plain,
    bilinear_warp_plain,
    warp_validity,
)
from vstab_torch.kernels.warp1d import (
    hwarp,
    hwarp_plain,
    twopass_validity,
    vwarp,
    vwarp_plain,
    warp_twopass,
)

KERNELS = {
    "cost_volume": _cv.KERNEL,
    "bilinear_warp": _warp.KERNEL,
    "vwarp": _warp1d.VWARP,
    "hwarp": _warp1d.HWARP,
}
KERNELS_BWD = {
    "cost_volume_bwd": _cv.KERNEL_BWD,
    "bilinear_warp_bwd": _warp.KERNEL_BWD,
}
KERNELS_RAFT = {"corr_lookup": _corr.KERNEL, "corr_lookup_bwd": _corr.KERNEL_BWD}


def reset_launches() -> None:
    for k in (*KERNELS.values(), *KERNELS_BWD.values(), *KERNELS_RAFT.values()):
        k.launches = 0


__all__ = [
    "KERNELS",
    "KERNELS_BWD",
    "KERNELS_RAFT",
    "bilinear_warp",
    "bilinear_warp_backward",
    "bilinear_warp_backward_plain",
    "bilinear_warp_plain",
    "corr_lookup",
    "corr_lookup_backward",
    "corr_lookup_backward_plain",
    "corr_lookup_plain",
    "cost_volume",
    "cost_volume_backward",
    "cost_volume_backward_plain",
    "cost_volume_plain",
    "hwarp",
    "hwarp_plain",
    "reset_launches",
    "twopass_validity",
    "vwarp",
    "vwarp_plain",
    "warp_twopass",
    "warp_validity",
]
