"""Triangulation and track fusion (sfm_danpipeline_torch.pipeline.incremental
`triangulate_new_view_all`, pipeline/tracks.py `add_points`) as one CUDA
graph per shape.

`scatter_set_last` writes every entry, sending the losers of a duplicate
target to a dump element it slices off, where it used to select the winners
with a boolean mask (a host sync on the card). The pair step
`triangulate_new_view` indexes with (1,) device tensors, so it reads nothing
back to the host. On the card `triangulate_new_view_all` runs its pairs
eagerly at a shape's first call, captures the step at the second and replays
it for every pair after; on the CPU it runs the eager loop and counts
nothing.

Tolerance: none. The new scatter writes each real target once, by the same
winner, and a replay runs the eager step's kernels in the same order on the
same values, so every comparison is bit for bit (`torch.equal`): against
frozen copies of the package's code before the change (the masked scatter
and the per-pair step with Python indices) on the CPU, and graph against
eager on the card.

The inputs are a synthetic rig: cameras on an arc, each view's features a
permutation of one set of world points (projections plus noise, a few far
off), and match tables that pick random subsets of the shared points, so
the same feature of a view is matched in several other views and pairs fuse
into one another's points.

The card's tests import no JAX, so they also run on a card host without it:
`python -m pytest --noconftest -m gpu tests/test_torch_triangulate_graph.py`.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.ops.lie import exp_so3
from sfm_danpipeline_torch.ops.projection import undistort_points
from sfm_danpipeline_torch.ops.triangulation import triangulate_and_filter
from sfm_danpipeline_torch.pipeline import incremental as t_inc
from sfm_danpipeline_torch.pipeline import tracks as t_tr
from sfm_danpipeline_torch.utils import profiling
from torch_testing import one_torch_thread  # noqa: F401

FIELDS = ("points_xyz", "points_rgb", "points_valid", "track_feat", "feat_to_point", "n_points")
CONFIG = PipelineConfig()
# (views, capacity, keypoints, match slots): small rigs for the CPU; the
# card's are the benchmark's shapes (arc20-sift and temple6-sift).
CPU_RIGS = {"v5": (5, 512, 96, 48), "v4-full": (4, 64, 64, 40)}
CARD_RIGS = {"arc20": (20, 65536, 2048, 1024), "temple6": (6, 65536, 2048, 1024)}


# --- frozen copies of the package before the change -------------------------


def _frozen_scatter_set_last(dst, rows, cols, vals):
    """`scatter_set_last` as the package had it: the winners selected with a
    boolean mask."""
    out = dst.clone()
    if cols is None:
        target = out.view(dst.shape[0], -1)
        lin = rows.long()
        vals = vals.reshape(lin.shape[0], -1)
    else:
        target = out.view(-1)
        lin = rows.long() * dst.shape[1] + cols.long()
    pos = torch.arange(lin.numel(), device=dst.device)
    winner = torch.full(
        (target.shape[0],), -1, dtype=torch.long, device=dst.device
    ).scatter_reduce(0, lin, pos, "amax")
    keep = winner[lin] == pos
    target[lin[keep]] = vals[keep].to(dst.dtype)
    return out


def _frozen_triangulate_new_view(state, new_view, done_view, feat_new, feat_done, valid,
                                 keypoints_xy, colors, K, dist, config):
    """The pair step as the package had it: Python view indices, the tables
    sliced by the caller, the count of kept candidates returned beside the
    state."""
    cam_n = state.cameras[new_view]
    cam_d = state.cameras[done_view]
    pn = keypoints_xy[new_view][feat_new.long()]
    pd = keypoints_xy[done_view][feat_done.long()]
    X, keep = triangulate_and_filter(
        exp_so3(cam_n[:3]), cam_n[3:], exp_so3(cam_d[:3]), cam_d[3:],
        undistort_points(pn, K, dist), undistort_points(pd, K, dist), pn, pd, K,
        valid & state.camera_valid[new_view] & state.camera_valid[done_view],
        max_error_px=config.geometry.max_reprojection_error_px,
    )
    state = t_tr.add_points(
        state, X, colors[new_view][feat_new.long()], new_view, feat_new,
        done_view, feat_done, keep, merge_distance=config.geometry.merge_distance,
    )
    return state, torch.sum(keep)


def _frozen_sweep(state, rig, monkeypatch):
    """The re-fuse sweep through the frozen step and scatter."""
    with monkeypatch.context() as mp:
        mp.setattr(t_tr, "scatter_set_last", _frozen_scatter_set_last)
        for v in range(state.n_views):
            for d in range(state.n_views):
                state, _ = _frozen_triangulate_new_view(
                    state, v, d, rig["feat_a"][v, d], rig["feat_b"][v, d], rig["valid"][v, d],
                    rig["xy"], rig["colors"], rig["K"], rig["dist"], CONFIG,
                )
    return state


# --- the rig -----------------------------------------------------------------


def _rig(V, capacity, Kmax, M, device, seed=0, invalid_view=None):
    """Cameras on an arc around unit-cube points, each view's Kmax features a
    permutation of the points, and (V, V, M) oriented match tables."""
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((Kmax, 3), generator=g) * 2 - 1
    theta = torch.linspace(-0.5, 0.5, V)
    cameras = torch.zeros((V, 6))
    cameras[:, 1] = theta
    cameras[:, 5] = 4.0
    K = torch.tensor([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]])
    perm = torch.stack([torch.randperm(Kmax, generator=g) for _ in range(V)])  # feature -> point
    inv = torch.argsort(perm, dim=1)  # point -> feature
    R = exp_so3(cameras[:, :3])
    cam = torch.einsum("vij,vkj->vki", R, X[perm]) + cameras[:, None, 3:]
    xy = cam[..., :2] / cam[..., 2:3] * 500.0 + torch.tensor([320.0, 240.0])
    xy = xy + 0.3 * torch.randn(xy.shape, generator=g)
    far = torch.rand((V, Kmax), generator=g) < 0.05
    xy = torch.where(far[..., None], xy + 40.0, xy)
    feat_a = torch.zeros((V, V, M), dtype=torch.int32)
    feat_b = torch.zeros((V, V, M), dtype=torch.int32)
    valid = torch.zeros((V, V, M), dtype=torch.bool)
    for a in range(V):
        for b in range(a + 1, V):
            pts = torch.randperm(Kmax, generator=g)[:M]
            ok = torch.rand(M, generator=g) < 0.8
            feat_a[a, b], feat_b[a, b] = inv[a, pts].int(), inv[b, pts].int()
            feat_a[b, a], feat_b[b, a] = feat_b[a, b], feat_a[a, b]
            valid[a, b] = valid[b, a] = ok
    state = t_tr.init_state(V, Kmax, capacity, 500.0)
    camera_valid = torch.ones(V, dtype=torch.bool)
    if invalid_view is not None:
        camera_valid[invalid_view] = False
    state = dataclasses.replace(state, cameras=cameras, camera_valid=camera_valid)
    rig = dict(
        feat_a=feat_a, feat_b=feat_b, valid=valid, xy=xy,
        colors=torch.rand((V, Kmax, 3), generator=g), K=K, dist=torch.zeros(5),
    )
    fields = {f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)}
    return dataclasses.replace(state, **fields), {k: v.to(device) for k, v in rig.items()}


def _tables(rig):
    return tuple(rig[k] for k in ("feat_a", "feat_b", "valid", "xy", "colors", "K", "dist"))


def _sweep(state, rig, eager=False):
    """The reinit's re-fuse sweep: every view against every view, itself
    included, in order; through `triangulate_new_view_all`, or with `eager`
    through the eager loop alone."""
    views = list(range(state.n_views))
    for v in views:
        if eager:
            state = t_inc._triangulate_eager(state, v, views, _tables(rig), CONFIG)
        else:
            state = t_inc.triangulate_new_view_all(state, v, views, *_tables(rig), CONFIG)
    return state


def _assert_states_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert torch.equal(g, w), f
    assert torch.equal(got.cameras, want.cameras)
    assert torch.equal(got.camera_valid, want.camera_valid)


# --- the CPU: the same arithmetic, no sync ------------------------------------


def _scatter_case(case, device="cpu"):
    """dst, rows, cols, vals with many duplicate targets."""
    g = torch.Generator().manual_seed(3)
    if case == "cols-int32":
        dst = torch.randint(-5, 50, (33, 7), generator=g, dtype=torch.int32)
        rows = torch.randint(0, 33, (200,), generator=g)
        cols = torch.randint(0, 7, (200,), generator=g)
        vals = torch.randint(0, 1000, (200,), generator=g, dtype=torch.int64)
    elif case == "cols-float-into-int":
        dst = torch.full((9, 4), -1, dtype=torch.int32)
        rows = torch.randint(0, 9, (80,), generator=g).int()
        cols = torch.randint(0, 4, (80,), generator=g).int()
        vals = torch.randn(80, generator=g) * 100
    elif case == "rows-float3":
        dst = torch.randn((17, 3), generator=g)
        rows = torch.randint(0, 17, (60,), generator=g)
        cols = None
        vals = torch.randn((60, 3), generator=g)
    else:  # "rows-bool": a 1-D destination, whole-row writes
        dst = torch.zeros(12, dtype=torch.bool)
        rows = torch.randint(0, 12, (40,), generator=g)
        cols = None
        vals = torch.rand(40, generator=g) < 0.5
    return tuple(None if t is None else t.to(device) for t in (dst, rows, cols, vals))


SCATTER_CASES = ("cols-int32", "cols-float-into-int", "rows-float3", "rows-bool")


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_set_last_equals_the_masked_version(case):
    """Last-wins among duplicates, bit for bit the masked version's output,
    and the input left as it was."""
    dst, rows, cols, vals = _scatter_case(case)
    before = dst.clone()
    got = t_tr.scatter_set_last(dst, rows, cols, vals)
    want = _frozen_scatter_set_last(dst, rows, cols, vals)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(dst, before)


def test_add_points_fusing_pairs_equals_the_masked_version(monkeypatch):
    """`add_points` over pairs whose candidates fuse into one another's
    points (a new-view feature matched in two done views, and an earlier
    pair's points extended) equals the masked version's states bit for bit,
    step by step, with Python and with tensor view indices."""
    state, rig = _rig(5, 512, 96, 48, "cpu", seed=1)
    g = torch.Generator().manual_seed(2)
    pairs = [(1, 0), (2, 0), (2, 1), (3, 1), (3, 2), (0, 3), (4, 2), (4, 0)]
    steps = []
    for a, b in pairs:
        M = rig["feat_a"].shape[-1]
        steps.append((
            torch.randn((M, 3), generator=g), torch.rand((M, 3), generator=g),
            a, rig["feat_a"][a, b], b, rig["feat_b"][a, b],
            rig["valid"][a, b] & (torch.rand(M, generator=g) < 0.9),
        ))
    got, want = state, state
    n_fused = 0
    for xyz, rgb, a, fa, b, fb, mask in steps:
        before = want.n_points.clone()
        with monkeypatch.context() as mp:
            mp.setattr(t_tr, "scatter_set_last", _frozen_scatter_set_last)
            want_next = t_tr.add_points(want, xyz, rgb, a, fa, b, fb, mask)
        got = t_tr.add_points(got, xyz, rgb, torch.tensor([a]), fa, torch.tensor([b]), fb, mask)
        _assert_states_equal(got, want_next)
        n_fused += int(torch.sum(mask)) - int(want_next.n_points - before)
        want = want_next
    assert n_fused > 0  # the sequence does fuse


@pytest.mark.parametrize("rig", sorted(CPU_RIGS))
def test_cpu_sweep_equals_the_parent_loop(rig, monkeypatch):
    """On the CPU the re-fuse sweep through `triangulate_new_view_all` gives
    the parent's per-pair loop's states bit for bit (at "v4-full"
    the capacity runs out), captures nothing and counts no replay."""
    V, capacity, Kmax, M = CPU_RIGS[rig]
    state, tables = _rig(V, capacity, Kmax, M, "cpu", seed=4, invalid_view=3 if V > 4 else None)
    cached = dict(t_inc._TRIANGULATE_GRAPHS)
    with profiling.recording() as timer:
        got = _sweep(state, tables)
    want = _frozen_sweep(state, tables, monkeypatch)
    _assert_states_equal(got, want)
    assert int(got.n_points) > 0
    if rig == "v4-full":
        assert int(got.n_points) == capacity
    assert timer.counters == {}
    assert t_inc._TRIANGULATE_GRAPHS == cached


class _Ops(TorchDispatchMode):
    """Every aten op dispatched in the block, with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((func, args))
        return func(*args, **(kwargs or {}))


def _syncing_ops(calls):
    """The ops of `calls` that would read the device back to the host: a
    boolean-mask index, a nonzero, a masked select, a scalar read."""
    found = []
    aten = torch.ops.aten
    for func, args in calls:
        if func in (aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
                    aten._index_put_impl_.default):
            if any(t is not None and t.dtype == torch.bool for t in args[1]):
                found.append(str(func))
        elif func.overloadpacket in (aten.nonzero, aten.masked_select, aten._local_scalar_dense,
                                     aten.item, aten.nonzero_static):
            found.append(str(func))
    return found


def test_pair_step_issues_no_syncing_op():
    """The pair step on the CPU issues no boolean-mask index, no nonzero and
    no scalar read: on the card any of them would synchronise and could not
    be captured."""
    state, rig = _rig(4, 256, 64, 32, "cpu", seed=5)
    views = torch.arange(4)
    state = t_inc.triangulate_new_view(state, views[1:2], views[0:1], *_tables(rig), CONFIG)
    with _Ops() as ops:
        out = t_inc.triangulate_new_view(state, views[2:3], views[1:2], *_tables(rig), CONFIG)
    assert len(ops.calls) > 100
    assert _syncing_ops(ops.calls) == []
    assert int(out.n_points) > int(state.n_points)


def test_the_guard_finds_the_masked_scatter():
    """The guard of the test above does see a boolean-mask index: the masked
    scatter trips it."""
    dst, rows, cols, vals = _scatter_case("cols-int32")
    with _Ops() as ops:
        _frozen_scatter_set_last(dst, rows, cols, vals)
    assert _syncing_ops(ops.calls)
    with _Ops() as ops:
        t_tr.scatter_set_last(dst, rows, cols, vals)
    assert _syncing_ops(ops.calls) == []


# --- the card: graph against eager ---------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU form")
    return torch.device("cuda")


def _key(state, rig):
    inputs = (state.cameras, state.camera_valid, *_tables(rig))
    g = CONFIG.geometry
    return (
        state.capacity, state.n_views, state.max_keypoints, rig["feat_a"].shape[-1],
        tuple(a.dtype for a in inputs), state.device.index,
        g.max_reprojection_error_px, g.merge_distance,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_set_last_equals_the_masked_version_on_cuda(card, case):
    dst, rows, cols, vals = _scatter_case(case, card)
    assert torch.equal(t_tr.scatter_set_last(dst, rows, cols, vals),
                       _frozen_scatter_set_last(dst, rows, cols, vals))


@pytest.mark.gpu
@pytest.mark.parametrize("rig", sorted(CARD_RIGS))
def test_graph_equals_eager_on_cuda(card, rig):
    """The re-fuse sweep replayed through the graph equals the eager loop bit
    for bit at the benchmark's shapes, and every pair of it is a replay."""
    V, capacity, Kmax, M = CARD_RIGS[rig]
    state, tables = _rig(V, capacity, Kmax, M, card, seed=6)
    t_inc.triangulate_new_view_all(state, 0, [1], *_tables(tables), CONFIG)
    t_inc.triangulate_new_view_all(state, 0, [1], *_tables(tables), CONFIG)  # captured
    with profiling.recording() as timer:
        got = _sweep(state, tables)
    assert timer.counters == {"triangulate_graph_replays": V * V}
    want = _sweep(state, tables, eager=True)
    _assert_states_equal(got, want)
    assert int(got.n_points) > 0


@pytest.mark.gpu
def test_returned_state_does_not_alias_the_graph(card):
    """A later replay leaves an earlier call's returned state as it was."""
    V, capacity, Kmax, M = CARD_RIGS["temple6"]
    state, tables = _rig(V, capacity, Kmax, M, card, seed=7)
    views = list(range(V))
    for _ in range(2):
        t_inc.triangulate_new_view_all(state, 0, views, *_tables(tables), CONFIG)
    first = t_inc.triangulate_new_view_all(state, 0, views, *_tables(tables), CONFIG)
    kept = {f: getattr(first, f).clone() for f in FIELDS}
    second = t_inc.triangulate_new_view_all(first, 1, views, *_tables(tables), CONFIG)
    graph = t_inc._TRIANGULATE_GRAPHS[_key(state, tables)]
    for f in FIELDS:
        assert torch.equal(getattr(first, f), kept[f]), f
        assert getattr(first, f).data_ptr() != graph.points[f].data_ptr()
        assert getattr(second, f).data_ptr() != graph.points[f].data_ptr()
    assert int(second.n_points) > int(first.n_points)


@pytest.mark.gpu
def test_first_call_eager_second_captures_then_replays(card):
    """A shape's first call runs eagerly and counts nothing, its second
    captures once and replays every pair, the third replays the same graph;
    all three give the eager result."""
    V, capacity, Kmax, M = CARD_RIGS["temple6"]
    state, tables = _rig(V, capacity, Kmax, M, card, seed=8)
    key = _key(state, tables)
    t_inc._TRIANGULATE_GRAPHS.pop(key, None)
    views = list(range(V))
    args = (state, 2, views, *_tables(tables), CONFIG)
    with profiling.recording() as timer:
        first = t_inc.triangulate_new_view_all(*args)
        assert timer.counters == {} and t_inc._TRIANGULATE_GRAPHS[key] is None
        second = t_inc.triangulate_new_view_all(*args)
        assert timer.counters == {"triangulate_graph_captures": 1, "triangulate_graph_replays": V}
        graph = t_inc._TRIANGULATE_GRAPHS[key]
        third = t_inc.triangulate_new_view_all(*args)
        assert timer.counters == {
            "triangulate_graph_captures": 1, "triangulate_graph_replays": 2 * V,
        }
        assert t_inc._TRIANGULATE_GRAPHS[key] is graph
    want = t_inc._triangulate_eager(state, 2, views, _tables(tables), CONFIG)
    for got in (first, second, third):
        _assert_states_equal(got, want)
