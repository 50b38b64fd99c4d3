"""The port's AKAZE (sfm_danpipeline_torch.ops.akaze) against the JAX
reference, and the reference's own AKAZE test cases on the port.

Parity, on two rendered 120x160 courtyard frames with 512 keypoints: at
least 95% of the reference's valid keypoints have a port keypoint within
0.5 px with |angle difference| < 0.05 rad, and on those the Hamming
distance of the descriptors is at most 2% of the 512 (486 used) bits. Not
0: an MLDB bit compares two cell means of bilinear samples; the reference
samples a per-keypoint patch by hat-weight contractions, the port gathers
from the level stack, and the diffusion stencil and the arc sums round in
other orders, so near-equal means can flip. The FED schedule is host
arithmetic and is held equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.config import FeatureConfig as JFeatureConfig
from sfm_danpipeline_tpu.ops import akaze as j_akaze
from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
from sfm_danpipeline_torch.config import FeatureConfig
from sfm_danpipeline_torch.ops import akaze as t_akaze
from torch_testing import keypoint_agreement, one_torch_thread  # noqa: F401

SMALL_CFG = FeatureConfig(detector="akaze", max_keypoints=256, akaze_n_octaves=3)


@pytest.mark.parametrize("T", [0.0, 0.3, 1.28, 7.5])
def test_fed_schedule_equal(T):
    assert t_akaze._fed_tau_cascade(T) == j_akaze._fed_tau_cascade(T)


@pytest.mark.parametrize("view", [0, 1])
def test_keypoints_and_descriptors_agree_with_reference(view):
    scene = make_courtyard_scene(n_views=2, height=120, width=160, ring_fraction=0.1, seed=0)
    gray = scene.images.gray[view]
    kj = j_akaze.detect_and_compute_akaze(jnp.asarray(gray), JFeatureConfig(max_keypoints=512))
    kt = t_akaze.detect_and_compute_akaze(torch.tensor(gray), FeatureConfig(max_keypoints=512))
    hit, ham, n_ref = keypoint_agreement(kj, kt)
    assert n_ref > 100
    assert abs(int(kt.valid.sum()) - n_ref) <= 0.02 * n_ref
    assert hit >= 0.95, hit
    assert ham <= 0.02, ham


def test_contrast_factor_agrees():
    scene = make_courtyard_scene(n_views=2, height=120, width=160, ring_fraction=0.1, seed=0)
    kj = np.array([float(j_akaze._contrast_factor(jnp.asarray(g))) for g in scene.images.gray])
    kt = t_akaze._contrast_factor(torch.tensor(scene.images.gray)).numpy()
    np.testing.assert_allclose(kt, kj, rtol=1e-5)


def test_batch_equals_single_image():
    scene = make_courtyard_scene(n_views=2, height=120, width=160, ring_fraction=0.1, seed=0)
    gray = torch.tensor(scene.images.gray)
    kb = t_akaze.detect_and_compute_akaze_batch(gray, SMALL_CFG)
    k1 = t_akaze.detect_and_compute_akaze(gray[1], SMALL_CFG)
    assert torch.equal(kb.valid[1], k1.valid)
    assert torch.equal(kb.descriptors[1], k1.descriptors)


# --- the reference's own cases (tests/test_akaze.py) on the port ---


def _blob_image(rng, h=160, w=200, n=25):
    img = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        y, x = rng.integers(25, h - 25), rng.integers(25, w - 25)
        r = rng.uniform(2.0, 5.0)
        img += rng.uniform(0.3, 1.0) * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * r * r))
    return np.clip(img, 0, 1)


def _detect(img):
    kp = t_akaze.detect_and_compute_akaze(torch.tensor(img), SMALL_CFG)
    v = kp.valid.numpy()
    return kp, kp.xy.numpy()[v], kp.descriptors.numpy()[v]


def test_akaze_shapes_and_masks():
    kp, xy, d = _detect(_blob_image(np.random.default_rng(0)))
    assert kp.xy.shape == (256, 2)
    assert kp.descriptors.shape == (256, 512)
    assert 5 < len(xy) <= 256
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 200).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 160).all()
    # MLDB bits are exactly {0, 1}; pad region (486:512) all zero.
    assert set(np.unique(d)).issubset({0.0, 1.0})
    assert (d[:, 486:] == 0).all()


def test_akaze_blob_centers_detected():
    img = np.zeros((120, 160), np.float32)
    yy, xx = np.mgrid[0:120, 0:160]
    centers = [(40, 40), (40, 120), (80, 80)]
    for cy, cx in centers:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 4.0**2))
    _, xy, _ = _detect(img)
    for cy, cx in centers:
        d = np.linalg.norm(xy - [cx, cy], axis=1).min()
        assert d < 2.0, f"blob at ({cx},{cy}) missed by {d:.2f}px"


def test_akaze_translation_equivariance():
    img = _blob_image(np.random.default_rng(3))
    shift = 8
    _, xy1, _ = _detect(img)
    _, xy2, _ = _detect(np.roll(img, shift, axis=1))
    matched = considered = 0
    for p in xy1:
        if p[0] + shift < 190:
            considered += 1
            matched += np.linalg.norm(xy2 - (p + [shift, 0]), axis=1).min() < 1.5
    assert considered > 5
    assert matched > 0.6 * considered


def test_akaze_descriptor_hamming_under_translation():
    """MLDB bits of translated keypoints mostly agree (Hamming distance of
    true pairs well below the ~243-bit random-pair expectation)."""
    img = _blob_image(np.random.default_rng(5))
    _, xy1, d1 = _detect(img)
    _, xy2, d2 = _detect(np.roll(img, 6, axis=0))
    good = total = 0
    for i, p in enumerate(xy1):
        j = np.linalg.norm(xy2 - (p + [0, 6]), axis=1).argmin()
        if np.linalg.norm(xy2[j] - (p + [0, 6])) < 1.5:
            total += 1
            good += np.sum(d1[i] != d2[j]) < 80
    assert total > 5
    assert good > 0.7 * total
