"""Shared pieces of the port's parity tests: a fixture that keeps torch to
one intra-op thread, and the check of a binary-descriptor detector (ORB,
AKAZE) against the JAX reference's on the same image."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run: the suite runs several
    workers side by side, the JAX side of each test takes the cores it finds,
    and the port's small eager ops gain nothing from more. A test module
    takes it by importing the name."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def keypoint_agreement(kj, kt):
    """Fractions and distances for one image. kj: the reference's Keypoints
    (JAX arrays), kt: the port's (torch tensors), both unbatched.

    Returns (hit_fraction, max_hamming_fraction, n_ref): the share of the
    reference's valid keypoints that have a port keypoint within 0.5 px
    whose angle differs by < 0.05 rad, and over those pairs the largest
    Hamming distance as a fraction of the descriptor's bits (where several
    port keypoints qualify, e.g. the same corner found on two pyramid
    levels, the one with the closest descriptor is its counterpart)."""
    vj = np.asarray(kj.valid)
    vt = kt.valid.numpy()
    xj, xt = np.asarray(kj.xy)[vj], kt.xy.numpy()[vt]
    aj, at = np.asarray(kj.angle)[vj], kt.angle.numpy()[vt]
    dj, dt = np.asarray(kj.descriptors)[vj], kt.descriptors.numpy()[vt]
    near = np.linalg.norm(xj[:, None] - xt[None], axis=-1) < 0.5
    dang = np.abs(np.angle(np.exp(1j * (aj[:, None] - at[None]))))
    ok = near & (dang < 0.05)
    ham = np.abs(dj[:, None, :] - dt[None, :, :]).sum(-1)
    ham = np.where(ok, ham, np.inf).min(1)
    hit = np.isfinite(ham)
    n_bits = dj.shape[1]
    return hit.mean(), (ham[hit].max() / n_bits if hit.any() else 0.0), int(vj.sum())
