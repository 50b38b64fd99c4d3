"""Checkpoint / resume for the incremental reconstruction.

Port of sfm_danpipeline_tpu/utils/checkpoint.py. The whole
`ReconstructionState` (plus the registered-view bookkeeping passed as
extras) goes into one .npz with the reference's field names, so a
checkpoint written by either package loads in the other. `load_state`
restores it so the incremental loop, or any later stage, continues where it
stopped.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sfm_danpipeline_torch import require_device
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState

_FIELDS = [
    "points_xyz",
    "points_rgb",
    "points_valid",
    "track_feat",
    "feat_to_point",
    "cameras",
    "camera_valid",
    "focal",
    "n_points",
]


def save_state(path: str, state: ReconstructionState, **extra) -> None:
    arrays = {f: getattr(state, f).cpu().numpy() for f in _FIELDS}
    for k, v in extra.items():
        arrays[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_state(
    path: str, device: str | torch.device = "cuda"
) -> Tuple[ReconstructionState, dict]:
    """The saved state on `device` (the card by default: later stages follow
    the state's device) and the extras as numpy arrays."""
    dev = require_device(device)
    with np.load(path) as z:
        state = ReconstructionState(
            **{f: torch.as_tensor(z[f], device=dev) for f in _FIELDS}
        )
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
    return state, extra
