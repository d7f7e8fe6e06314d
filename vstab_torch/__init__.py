"""vstab_torch: the PyTorch/CUDA port of vstab for NVIDIA Hopper.

`stabilize(frames, params, cfg)` runs the whole-clip path (PWC-Net flow ->
sparse-LS or affine smoothing -> two-pass render), `stabilize_batch` a batch
of clips, `stabilize_blocked` and `stabilize_video_blocked` clips longer than
device memory in temporal blocks; `python -m vstab_torch` is the command
line. All run on the CUDA device through the hand-written kernels of
`vstab_torch.kernels`, or on the CPU through their plain torch versions when
the caller passes `device="cpu"`. `vstab/` is the reference they are held
against.
"""

from vstab_torch.core.config import Config
from vstab_torch.pipeline import default_params, stabilize, stabilize_batch, stabilize_clip
from vstab_torch.pipeline_blocked import stabilize_blocked, stabilize_video_blocked

__all__ = [
    "Config",
    "default_params",
    "stabilize",
    "stabilize_batch",
    "stabilize_blocked",
    "stabilize_clip",
    "stabilize_video_blocked",
]
