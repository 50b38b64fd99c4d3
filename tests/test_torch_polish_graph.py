"""The two-view Sampson polish (sfm_danpipeline_torch.ops.epipolar._polish)
as one CUDA graph per input shape.

On the card `_polish` runs `_polish_eager` at a shape's first call,
captures it at the second, once per (P, M, dtype, device), and replays it
from then on; on the CPU it runs the eager path and counts nothing. The inputs are the rendered courtyard's: SIFT and
ratio-test matches of every pair, normalized by K, the polish's arguments
taken from the estimators' own calls (a spy on `_polish`).

Tolerance: none. A replay runs the eager path's kernels in the same order on
the same values, so graph and eager outputs are held equal bit for bit
(`torch.equal`), as are the CPU's outputs and those of the two-round loop
the package ran before the graph.

The card's tests import no JAX, so they also run on a card host without it:
`python -m pytest --noconftest -m gpu tests/test_torch_polish_graph.py`.
"""
import pytest
import torch

from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
from sfm_danpipeline_torch.ops import epipolar as t_epi
from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.matching import match_all_pairs
from sfm_danpipeline_torch.ops.projection import undistort_points
from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch
from sfm_danpipeline_torch.utils import profiling
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
from torch_testing import one_torch_thread  # noqa: F401

# The CPU's scene is small (its SIFT takes seconds); the card's has the
# benchmark's image size and keypoints, and 10 views for P = 45.
CPU_SCENE = dict(n_views=6, height=240, width=320, ring_fraction=0.12, seed=0)
CPU_KEYPOINTS = 1024
CARD_SCENE = dict(n_views=10, height=480, width=640, ring_fraction=0.3, seed=0)
ESTIMATORS = ("polish", "basins", "pose")
# `_polish` calls of each case of `_outputs`: the basins estimator polishes
# twice (run once to take its arguments, then `_polish` on each), the pose
# estimator once.
POLISH_CALLS = {"polish": 4, "basins": 2, "pose": 1}


def _pairs(scene_kw, max_keypoints, device):
    """Every pair's normalized matches of the rendered courtyard: x1, x2
    (P, M, 2), valid (P, M), and K's focal length (a 0-dim tensor, as the
    pipeline passes it)."""
    scene = make_courtyard_scene(**scene_kw)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=max_keypoints))
    K = torch.as_tensor(scene.intrinsics.K, dtype=torch.float32, device=device)
    dist = torch.zeros(5, device=device)
    kp = detect_and_compute_batch(torch.as_tensor(scene.images.gray, device=device), cfg.features)
    pi, pj = torch.triu_indices(scene_kw["n_views"], scene_kw["n_views"], 1, device=device)
    m = match_all_pairs(
        kp.descriptors, kp.valid, pi.int(), pj.int(), ratio=cfg.matching.ratio,
        max_matches=cfg.matching.max_matches, xy=kp.xy, dup_radius=cfg.matching.dup_radius,
    )
    x1 = undistort_points(kp.xy[pi[:, None], m.idx_a.long()], K, dist)
    x2 = undistort_points(kp.xy[pj[:, None], m.idx_b.long()], K, dist)
    return dict(x1=x1, x2=x2, valid=m.valid, focal=K[0, 0])


def _batch(pairs, P):
    """The first P pairs (P = 1: the first pair alone, as the seed bootstrap
    passes one pair) with one key per pair."""
    if P == 1:
        args = {k: pairs[k][0] for k in ("x1", "x2", "valid")}
        key = prng.key(7, pairs["x1"].device)
    else:
        args = {k: pairs[k][:P] for k in ("x1", "x2", "valid")}
        key = prng.split(prng.key(7, pairs["x1"].device), P)
    return key, args


def _estimate(name, pairs, P):
    key, a = _batch(pairs, P)
    if name == "pose":
        return tuple(t_epi.estimate_relative_pose(key, a["x1"], a["x2"], a["valid"], focal=pairs["focal"]))
    return tuple(t_epi.estimate_relative_pose_basins(key, a["x1"], a["x2"], a["valid"], focal=pairs["focal"]))


def _polish_calls(pairs, P, monkeypatch):
    """The arguments of every `_polish` call of the basins estimator at P."""
    calls, real = [], t_epi._polish

    def spy(*args):
        calls.append(args)
        return real(*args)

    with monkeypatch.context() as mp:
        mp.setattr(t_epi, "_polish", spy)
        _estimate("basins", pairs, P)
    assert len(calls) == 2  # the winner's polish and the other basin's
    return calls


def _parent_polish(R0, t0, band0, x1, x2, valid, refit_n2):
    """`_polish` as the package ran it before the graph: two rounds of
    `_refine_pose_sampson`, each re-collecting the band."""
    R, t, band = R0, t0, band0
    for _ in range(2):
        R, t = t_epi._refine_pose_sampson(R, t, x1, x2, band.to(x1.dtype))
        band = (t_epi.sampson_distance(t_epi.essential_from_pose(R, t), x1, x2) < refit_n2) & valid
    return R, t, band


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _outputs(name, pairs, P, monkeypatch):
    if name == "polish":
        return [t_epi._polish(*args) for args in _polish_calls(pairs, P, monkeypatch)]
    return [_estimate(name, pairs, P)]


# --- the CPU: the eager path, unchanged -------------------------------------


@pytest.fixture(scope="module")
def cpu_pairs():
    return _pairs(CPU_SCENE, CPU_KEYPOINTS, "cpu")


@pytest.mark.parametrize("name", ESTIMATORS)
@pytest.mark.parametrize("P", [1, 15])
def test_cpu_polish_is_the_eager_path(cpu_pairs, name, P, monkeypatch):
    """On the CPU `_polish`, and the two estimators over it, give what the
    two-round loop gives bit for bit, capture nothing and count no replay."""
    cached = dict(t_epi._POLISH_GRAPHS)
    with profiling.recording() as timer:
        got = _outputs(name, cpu_pairs, P, monkeypatch)
    with monkeypatch.context() as mp:
        mp.setattr(t_epi, "_polish", _parent_polish)
        want = _outputs(name, cpu_pairs, P, monkeypatch)
    for g, w in zip(got, want):
        _assert_equal(g, w)
    assert "polish_graph_captures" not in timer.counters
    assert "polish_graph_replays" not in timer.counters
    assert t_epi._POLISH_GRAPHS == cached


def test_polish_graph_cache_captures_at_the_second_call_and_keeps_the_last_few(monkeypatch):
    """A shape's first call gets no graph, its second makes one, later calls
    get the same one; beyond `_POLISH_GRAPHS_KEPT` shapes the least recently
    used is forgotten, and comes back as a first call."""
    monkeypatch.setattr(t_epi, "_POLISH_GRAPHS", t_epi.OrderedDict())
    made = []

    def get(key):
        return t_epi._polish_graph(key, lambda: made.append(key) or ("graph", key))

    assert get("a") is None and made == []
    assert get("a") == ("graph", "a") and made == ["a"]
    assert get("a") == ("graph", "a") and made == ["a"]
    for key in range(t_epi._POLISH_GRAPHS_KEPT - 1):
        assert get(key) is None
    assert get("a") == ("graph", "a")  # used last: kept
    assert get("b") is None  # one beyond: forgets key 0, the oldest
    assert len(t_epi._POLISH_GRAPHS) == t_epi._POLISH_GRAPHS_KEPT
    assert 0 not in t_epi._POLISH_GRAPHS and get(0) is None
    assert made == ["a"]


# --- the card: graph against eager -------------------------------------------


@pytest.fixture(scope="module")
def card_pairs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU form")
    return _pairs(CARD_SCENE, PipelineConfig().features.max_keypoints, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ESTIMATORS)
@pytest.mark.parametrize("P", [1, 15, 45])
def test_graph_equals_eager_on_cuda(card_pairs, name, P, monkeypatch):
    """Graph and eager `_polish`, and the estimators over each, are equal bit
    for bit at the seed's P = 1, the 6-view set's 15 pairs and 10 views' 45.
    A first pass has the shape captured; the second only replays."""
    _outputs(name, card_pairs, P, monkeypatch)
    with profiling.recording() as timer:
        got = _outputs(name, card_pairs, P, monkeypatch)
    assert timer.counters == {"polish_graph_replays": POLISH_CALLS[name]}
    with monkeypatch.context() as mp:
        mp.setattr(t_epi, "_polish", t_epi._polish_eager)
        want = _outputs(name, card_pairs, P, monkeypatch)
    for g, w in zip(got, want):
        _assert_equal(g, w)


@pytest.mark.gpu
def test_first_call_eager_second_captures_then_replays(card_pairs, monkeypatch):
    """A shape's first call runs eagerly and counts nothing, its second
    captures once and replays, the third replays the same graph."""
    args = _polish_calls({k: v[:3] if k != "focal" else v for k, v in card_pairs.items()}, 3, monkeypatch)[0]
    key = (*args[3].shape[:2], args[3].dtype, args[3].device.index)
    t_epi._POLISH_GRAPHS.pop(key, None)
    with profiling.recording() as timer:
        first = t_epi._polish(*args)
        assert timer.counters == {} and t_epi._POLISH_GRAPHS[key] is None
        second = t_epi._polish(*args)
        assert timer.counters == {"polish_graph_captures": 1, "polish_graph_replays": 1}
        graph = t_epi._POLISH_GRAPHS[key]
        third = t_epi._polish(*args)
        assert timer.counters == {"polish_graph_captures": 1, "polish_graph_replays": 2}
        assert t_epi._POLISH_GRAPHS[key] is graph
    _assert_equal(first, t_epi._polish_eager(*args))
    _assert_equal(second, first)
    _assert_equal(third, first)
