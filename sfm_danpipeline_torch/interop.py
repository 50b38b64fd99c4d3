"""Carry intermediate state between the JAX reference and the port.

An SfM engine has no weights: what crosses between the two packages is
the intermediate state. `*_from_numpy` builds the port's dataclasses from
numpy arrays (what `np.asarray` gives of the reference's `Keypoints`,
`PairMatches`, `ReconstructionState` and `BAProblem` fields); `*_to_numpy`
goes back. Each stage can then be run alone on the other package's input.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sfm_danpipeline_torch.ba.problem import BAProblem
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.sift import Keypoints
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState

_INT = {"idx_a", "idx_b", "track_feat", "feat_to_point", "n_points"}
_LONG = {"obs_cam", "obs_pt"}
_BOOL = {"valid", "points_valid", "camera_valid", "fix_cam", "fix_focal", "fix_pt"}


def _dtype(name: str) -> torch.dtype:
    if name in _INT:
        return torch.int32
    if name in _LONG:
        return torch.int64
    if name in _BOOL:
        return torch.bool
    return torch.float32


def _from_numpy(cls, fields, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(fields, f.name) if not isinstance(fields, dict) else fields.get(f.name)
        kw[f.name] = None if v is None else torch.tensor(
            np.array(v), dtype=_dtype(f.name), device=device
        )
    return cls(**kw)


def _to_numpy(obj) -> Dict[str, np.ndarray]:
    return {
        f.name: None if getattr(obj, f.name) is None else getattr(obj, f.name).cpu().numpy()
        for f in dataclasses.fields(obj)
    }


def keypoints_from_numpy(kp, device="cpu") -> Keypoints:
    """`kp`: an object or dict with xy, sigma, angle, response, descriptors, valid."""
    return _from_numpy(Keypoints, kp, device)


def matches_from_numpy(m, device="cpu") -> PairMatches:
    """`m`: an object or dict with idx_a, idx_b, dist, lowe, valid."""
    return _from_numpy(PairMatches, m, device)


def state_from_numpy(st, device="cpu") -> ReconstructionState:
    """`st`: an object or dict with the ReconstructionState fields."""
    return _from_numpy(ReconstructionState, st, device)


def problem_from_numpy(prob, device="cpu") -> BAProblem:
    """`prob`: an object or dict with the BAProblem fields."""
    return _from_numpy(BAProblem, prob, device)


keypoints_to_numpy = _to_numpy
matches_to_numpy = _to_numpy
state_to_numpy = _to_numpy
problem_to_numpy = _to_numpy
