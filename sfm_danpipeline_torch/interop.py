"""Carry intermediate state between the JAX reference and the port.

An SfM engine has no weights: what crosses between the two packages is
the intermediate state. `*_from_numpy` builds the port's dataclasses from
numpy arrays (what `np.asarray` gives of the reference's `Keypoints`,
`PairMatches`, `ReconstructionState`, `BAProblem`, `PairScores` and
`Sim3` fields); `*_to_numpy` goes back. Each stage can then be run alone on
the other package's input. `key_from_numpy` takes a reference key's data
(`jax.random.key_data`), so that both packages draw from one key.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sfm_danpipeline_torch.ba.problem import BAProblem
from sfm_danpipeline_torch.ops.matching import PairMatches
from sfm_danpipeline_torch.ops.sift import Keypoints
from sfm_danpipeline_torch.ops.similarity import Sim3
from sfm_danpipeline_torch.pipeline.bootstrap import PairScores
from sfm_danpipeline_torch.pipeline.tracks import ReconstructionState

_INT = {"idx_a", "idx_b", "track_feat", "feat_to_point", "n_points", "n_matches", "n_inliers"}
_LONG = {"obs_cam", "obs_pt"}
_BOOL = {
    "valid", "points_valid", "camera_valid", "fix_cam", "fix_focal", "fix_pt", "usable",
}


def _dtype(name: str) -> torch.dtype:
    if name in _INT:
        return torch.int32
    if name in _LONG:
        return torch.int64
    if name in _BOOL:
        return torch.bool
    return torch.float32


def _names(cls):
    """Field names of a dataclass or a NamedTuple."""
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)


def _from_numpy(cls, fields, device):
    kw = {}
    for name in _names(cls):
        v = getattr(fields, name) if not isinstance(fields, dict) else fields.get(name)
        kw[name] = None if v is None else torch.tensor(
            np.array(v), dtype=_dtype(name), device=device
        )
    return cls(**kw)


def _to_numpy(obj) -> Dict[str, np.ndarray]:
    return {
        name: None if getattr(obj, name) is None else getattr(obj, name).cpu().numpy()
        for name in _names(type(obj))
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


def scores_from_numpy(sc, device="cpu") -> PairScores:
    """`sc`: an object or dict with the PairScores fields."""
    return _from_numpy(PairScores, sc, device)


def key_from_numpy(key_data, device="cpu") -> torch.Tensor:
    """A reference key's data, uint32 (..., 2), as the port's key: the same
    words in an int64 tensor (..., 2) (ops/prng.py)."""
    a = np.asarray(key_data)
    if a.dtype != np.uint32 or a.shape[-1:] != (2,):
        raise TypeError(f"a key's data is uint32 (..., 2), got {a.dtype} {a.shape}")
    return torch.tensor(a.astype(np.int64), device=device)


def sim3_from_numpy(sim, device="cpu") -> Sim3:
    """`sim`: an object or dict with s, R, t."""
    return _from_numpy(Sim3, sim, device)


keypoints_to_numpy = _to_numpy
matches_to_numpy = _to_numpy
state_to_numpy = _to_numpy
problem_to_numpy = _to_numpy
