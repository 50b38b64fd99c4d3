"""The system under test as the benchmark drives it: one image set through
sfm_danpipeline_torch, ended with its outputs on the host.

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference.judge import Reconstruction
from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch
from sfm_danpipeline_torch.ops import matching
from sfm_danpipeline_torch.pipeline import sfm

# The program's own stage timers (host clocks read after a synchronize), in
# the order `SfMPipeline.run` reads them.
SFM_TIMERS = ("t_features", "t_matching", "t_baseline", "t_incremental", "t_components", "t_final_ba")
CONTROLS = ("no-ba", "no-ratio", "tf32")


def apply_control(control: str) -> None:
    """Switch the program, for the rest of the process, to one of the
    check's controls (never in a benchmark run):

    - "no-ba": every bundle adjustment returns the state it was given (zero
      LM iterations), which breaks the configuration's guarantee that the
      reconstruction is bundle-adjusted;
    - "no-ratio": knn2 returns a second-nearest distance ten times the
      nearest, so the ratio test passes every valid keypoint's nearest
      neighbour: a fault of the matcher;
    - "tf32": TF32 on for matmuls and cuDNN convolutions, the lower
      precision that the program's own torch flags select (its package
      turns both off at import).
    """
    if control == "no-ba":
        real = sfm.run_ba
        sfm.run_ba = lambda prob, cfg, max_iterations=None: real(prob, cfg, max_iterations=0)
    elif control == "no-ratio":
        real_knn2 = matching.knn2

        def knn2(*args, **kwargs):
            best_idx, best_d2, second_d2 = real_knn2(*args, **kwargs)
            return best_idx, best_d2, torch.where(best_d2 < second_d2, 100.0 * best_d2 + 1e-6, second_d2)

        knn2.launches, knn2.last_flagged = 0, None  # the counters the launcher updates
        matching.knn2 = knn2
    elif control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    else:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")


def pipeline_config(overrides: Dict[str, object]):
    """The default PipelineConfig with `overrides` ("group.field" or a
    top-level field name -> value) applied."""
    cfg = PipelineConfig()
    for key, value in overrides.items():
        group, _, field = key.partition(".")
        if field:
            value = dataclasses.replace(getattr(cfg, group), **{field: value})
        cfg = dataclasses.replace(cfg, **{group: value})
    return cfg


def inputs(gray: np.ndarray, K: np.ndarray):
    """The images and intrinsics as a user's loader hands them over: host
    numpy arrays in the program's ImageBatch and Intrinsics."""
    V, H, W = gray.shape
    images = ImageBatch(
        gray=gray,
        color=np.repeat(gray[..., None], 3, axis=-1),
        sizes=np.tile(np.array([[H, W]], np.int32), (V, 1)),
        paths=tuple(f"view_{v:04d}" for v in range(V)),
    )
    return images, Intrinsics(K=K.astype(np.float32), dist=np.zeros((5,), np.float32))


@dataclasses.dataclass
class SetResult:
    rec: Reconstruction
    timers: Dict[str, float]  # the program's stage timers of this set
    counts: Dict[str, float]  # the program's other numbers of this set (views, points, RMS, ...)
    valid_rows: np.ndarray  # (V,) valid keypoints per image: knn2's rows
    descriptor_shape: Tuple[int, int]  # (D, K) of the descriptors knn2 is given


def first_views(images, n: int):
    """The first `n` views of an image set (a warm-up's smaller set)."""
    return ImageBatch(gray=images.gray[:n], color=images.color[:n], sizes=images.sizes[:n], paths=images.paths[:n])


def run_set(images, intrinsics, cfg, device) -> SetResult:
    """One job: a fresh SfMPipeline over the set; returns once every output,
    the ratio-test matches of every pair with them, is on the host."""
    pipe = sfm.SfMPipeline(cfg, device=device)
    res = pipe.run(images, intrinsics)
    state = res.state
    valid = state.points_valid.cpu().numpy()
    # The pipeline's oriented (V, V, M) match tables; the strict one is the
    # ratio test's output at cfg.matching.ratio.
    feat_a, feat_b, strict = pipe._ctx["tables"][:3]
    V = feat_a.shape[0]
    pairs = torch.triu_indices(V, V, 1, device=feat_a.device)
    rec = Reconstruction(
        cameras=state.cameras.cpu().numpy(),
        camera_valid=state.camera_valid.cpu().numpy(),
        focal=float(state.focal),
        points=res.points,
        tracks=state.track_feat.cpu().numpy()[valid],
        kp_xy=res.keypoints.xy.cpu().numpy(),
        match_pairs=pairs.T.cpu().numpy(),
        match_a=feat_a[pairs[0], pairs[1]].cpu().numpy(),
        match_b=feat_b[pairs[0], pairs[1]].cpu().numpy(),
        match_valid=strict[pairs[0], pairs[1]].cpu().numpy(),
    )
    timers = {k: float(res.metrics[k]) for k in SFM_TIMERS}
    counts = {k: float(v) for k, v in res.metrics.items() if k not in timers and k != "t_total"}
    valid_rows = res.keypoints.valid.sum(-1).cpu().numpy()
    K, D = res.keypoints.descriptors.shape[-2:]
    return SetResult(rec, timers, counts, valid_rows, (D, K))
