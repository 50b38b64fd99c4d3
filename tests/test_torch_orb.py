"""The port's ORB (sfm_danpipeline_torch.ops.orb) against the JAX reference,
and the reference's own ORB test cases on the port.

Parity, on two rendered 120x160 courtyard frames with 512 keypoints: at
least 95% of the reference's valid keypoints have a port keypoint within
0.5 px with |angle difference| < 0.05 rad, and on those the Hamming
distance of the descriptors is at most 2% of the 256 bits. Not 0: a bit is
`a < b` of two bilinear samples of the smoothed image, and the two packages
sum the blur and the resize in other orders, so near-equal samples can
flip. The BRIEF pattern comes from numpy's generator in both and is held
bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_danpipeline_tpu.ops import orb as j_orb
from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
from sfm_danpipeline_torch.ops import orb as t_orb
from sfm_danpipeline_torch.ops.matching import match_pair
from torch_testing import keypoint_agreement, one_torch_thread  # noqa: F401


def test_brief_pattern_bit_equal():
    np.testing.assert_array_equal(np.asarray(j_orb._PATTERN), t_orb._PATTERN)


@pytest.mark.parametrize("view", [0, 1])
def test_keypoints_and_descriptors_agree_with_reference(view):
    scene = make_courtyard_scene(n_views=2, height=120, width=160, ring_fraction=0.1, seed=0)
    gray = scene.images.gray[view]
    kj = j_orb.detect_and_compute_orb(jnp.asarray(gray), max_keypoints=512)
    kt = t_orb.detect_and_compute_orb(torch.tensor(gray), max_keypoints=512)
    hit, ham, n_ref = keypoint_agreement(kj, kt)
    assert n_ref > 200
    assert abs(int(kt.valid.sum()) - n_ref) <= 0.02 * n_ref
    assert hit >= 0.95, hit
    assert ham <= 0.02, ham


def test_batch_equals_single_image():
    scene = make_courtyard_scene(n_views=2, height=120, width=160, ring_fraction=0.1, seed=0)
    gray = torch.tensor(scene.images.gray)
    kb = t_orb.detect_and_compute_orb_batch(gray, max_keypoints=256)
    k1 = t_orb.detect_and_compute_orb(gray[1], max_keypoints=256)
    assert torch.equal(kb.valid[1], k1.valid)
    assert torch.equal(kb.descriptors[1], k1.descriptors)
    torch.testing.assert_close(kb.xy[1], k1.xy, rtol=0, atol=0)


# --- the reference's own cases (tests/test_orb.py) on the port ---


def _checker_scene(rng, h=160, w=200, n=18):
    """Random bright squares on dark background: corner-rich."""
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        y, x = rng.integers(25, h - 40), rng.integers(25, w - 40)
        s = rng.integers(8, 18)
        img[y : y + s, x : x + s] = rng.uniform(0.5, 1.0)
    return img


def test_corners_detected_on_squares():
    img = _checker_scene(np.random.default_rng(0))
    kp = t_orb.detect_and_compute_orb(torch.tensor(img), max_keypoints=512)
    assert int(kp.valid.sum()) > 20
    assert kp.descriptors.shape == (512, 256)
    d = kp.descriptors.numpy()[kp.valid.numpy()]
    assert set(np.unique(d)).issubset({0.0, 1.0})


def test_blank_image_no_keypoints():
    kp = t_orb.detect_and_compute_orb(torch.zeros((120, 160)), max_keypoints=256)
    assert int(kp.valid.sum()) == 0


def test_translation_matching():
    img = _checker_scene(np.random.default_rng(1))
    img2 = np.roll(img, (0, 9), axis=(0, 1))
    kp1 = t_orb.detect_and_compute_orb(torch.tensor(img), max_keypoints=512)
    kp2 = t_orb.detect_and_compute_orb(torch.tensor(img2), max_keypoints=512)
    m = match_pair(
        kp1.descriptors, kp1.valid, kp2.descriptors, kp2.valid, ratio=0.9, max_matches=512
    )
    v = m.valid.numpy()
    assert v.sum() > 15
    pa = kp1.xy.numpy()[m.idx_a.numpy()[v]]
    pb = kp2.xy.numpy()[m.idx_b.numpy()[v]]
    good = np.linalg.norm(pb - pa - [9, 0], axis=1) < 2.0
    assert good.mean() > 0.7
