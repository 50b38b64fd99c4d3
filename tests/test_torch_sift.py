"""Parity of the port's SIFT (sfm_danpipeline_torch.ops.sift) with the JAX
reference on a rendered 240x320 courtyard frame.

Tolerances: valid keypoint counts within 2%; mutually nearest keypoints
within 0.05 px; their descriptors at cosine >= 0.99. The pyramid blur
(separable conv vs shift-adds), the Newton solve (LU vs XLA's solve) and
the gathers (vs hat-weight contractions) sum in other orders, so positions
agree to ~1e-4 px rather than bitwise, and a response tie at the budget
edge may swap a keypoint.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.config import FeatureConfig as JFeatureConfig
from sfm_danpipeline_tpu.ops import sift as j_sift
from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
from sfm_danpipeline_torch.config import FeatureConfig
from sfm_danpipeline_torch.ops import sift as t_sift
from torch_testing import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def both():
    scene = make_courtyard_scene(
        n_views=2, height=240, width=320, ring_fraction=0.12, seed=0
    )
    gray = scene.images.gray[:1]
    kj = j_sift.detect_and_compute_batch(
        jnp.asarray(gray), JFeatureConfig(max_keypoints=1024)
    )
    kt = t_sift.detect_and_compute_batch(
        torch.tensor(gray), FeatureConfig(max_keypoints=1024)
    )
    vj = np.asarray(kj.valid[0])
    vt = kt.valid[0].numpy()
    out = {
        "xy": (np.asarray(kj.xy[0])[vj], kt.xy[0].numpy()[vt]),
        "desc": (np.asarray(kj.descriptors[0])[vj], kt.descriptors[0].numpy()[vt]),
        "angle": (np.asarray(kj.angle[0])[vj], kt.angle[0].numpy()[vt]),
    }
    # Mutually nearest keypoints; among co-located rows (a keypoint's
    # secondary orientation shares its xy) pair by descriptor.
    xj, xt = out["xy"]
    dj, dt = out["desc"]
    D = np.linalg.norm(xj[:, None] - xt[None], axis=-1) + 1e-3 * (
        1.0 - dj @ dt.T
    )
    a = D.argmin(1)
    b = D.argmin(0)
    mutual = np.where(b[a] == np.arange(len(a)))[0]
    out["pairs"] = (mutual, a[mutual])
    return out


def test_keypoint_counts_agree(both):
    nj, nt = len(both["xy"][0]), len(both["xy"][1])
    assert nj > 200
    assert abs(nt - nj) <= 0.02 * nj, (nj, nt)


def test_mutual_keypoints_agree_in_position(both):
    (xj, xt), (ij, it) = both["xy"], both["pairs"]
    assert len(ij) >= 0.95 * len(xj)
    err = np.linalg.norm(xj[ij] - xt[it], axis=-1)
    assert np.all(err <= 0.05), err.max()


def test_mutual_keypoints_agree_in_descriptor(both):
    (dj, dt), (ij, it) = both["desc"], both["pairs"]
    cos = np.sum(dj[ij] * dt[it], axis=-1)
    assert np.all(cos >= 0.99), cos.min()
