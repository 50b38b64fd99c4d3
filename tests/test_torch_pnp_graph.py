"""PnP's two sync-free chains (sfm_danpipeline_torch.ops.pnp
`solve_pnp_ransac`) as CUDA graphs.

A solve runs draws -> DLT fit -> P3P Newton loop (`_p3p_newton`) -> P3P
Procrustes SVD -> select-refine-accept (`_select_refine_accept`). The two
named chains read nothing back to the host: the pick is a gather at a
device index, and the Newton starts are made on the device once, outside
the chain. On the card they replay as CUDA graphs once the process has run
one solve eagerly, a shape capturing at its first call after that; on the
CPU the solve runs eagerly and counts nothing.

Tolerance: none. The CPU solve is held to a frozen copy of the function
before the split, and on the card a replay runs the eager chain's kernels
in the same order on the same values, so every comparison is bit for bit
(`torch.equal`). The one arithmetic change, the acceptance gate's
determinant in closed form, feeds only a comparison with a margin of 1e-3
around a rotation's determinant of 1.

The problems are synthetic: points in front of a camera, a share of the
rows outliers, and rows left invalid, as registration's slots are.

The card's tests import no JAX, so they also run on a card host without it:
`python -m pytest --noconftest -m gpu tests/test_torch_pnp_graph.py`.
"""
import math
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sfm_danpipeline_torch.ops import pnp, prng
from sfm_danpipeline_torch.ops.select import top_k_indices
from sfm_danpipeline_torch.utils import profiling
from sfm_danpipeline_torch.utils.cuda_graphs import CapturedChain
from torch_testing import one_torch_thread  # noqa: F401

FOCAL, CX, CY = 500.0, 320.0, 240.0
THRESHOLD = 0.006 * 640
FIELDS = ("R", "t", "inliers", "n_inliers", "ok")


# --- frozen copy of the function before the split -----------------------------


def _frozen_p3p_solve(X3, y3):
    """`_p3p_solve` as the package had it, before its split into the Newton
    loop and the Procrustes step: its starts copied from the host on every
    call."""
    d12 = torch.sum((X3[:, 0] - X3[:, 1]) ** 2, -1)[:, None]
    d13 = torch.sum((X3[:, 0] - X3[:, 2]) ** 2, -1)[:, None]
    d23 = torch.sum((X3[:, 1] - X3[:, 2]) ** 2, -1)[:, None]
    c12 = torch.sum(y3[:, 0] * y3[:, 1], -1)[:, None]
    c13 = torch.sum(y3[:, 0] * y3[:, 2], -1)[:, None]
    c23 = torch.sum(y3[:, 1] * y3[:, 2], -1)[:, None]
    starts = torch.as_tensor(pnp._P3P_STARTS, device=X3.device)
    H = X3.shape[0]
    u = starts[:, 0].expand(H, -1)
    v = starts[:, 1].expand(H, -1)

    def system(u, v):
        g12 = 1.0 + u * u - 2.0 * u * c12
        g13 = 1.0 + v * v - 2.0 * v * c13
        g23 = u * u + v * v - 2.0 * u * v * c23
        return g12, g13, g23

    for _ in range(12):
        g12, g13, g23 = system(u, v)
        F1 = g12 * d13 - g13 * d12
        F2 = g12 * d23 - g23 * d12
        J11 = (2.0 * u - 2.0 * c12) * d13
        J12 = -(2.0 * v - 2.0 * c13) * d12
        J21 = (2.0 * u - 2.0 * c12) * d23 - (2.0 * u - 2.0 * v * c23) * d12
        J22 = -(2.0 * v - 2.0 * u * c23) * d12
        det = pnp._safe(J11 * J22 - J12 * J21, 1e-12)
        du = (F1 * J22 - F2 * J12) / det
        dv = (J11 * F2 - J21 * F1) / det
        u = torch.clamp(u - torch.clamp(du, -0.5, 0.5), 1e-3, 1e3)
        v = torch.clamp(v - torch.clamp(dv, -0.5, 0.5), 1e-3, 1e3)
    g12, g13, g23 = system(u, v)
    scale = d12 + d13 + d23 + 1e-12
    r1 = torch.abs(g12 * d13 - g13 * d12) / scale
    r2 = torch.abs(g12 * d23 - g23 * d12) / scale
    s1 = torch.sqrt(torch.clamp(d12 / torch.clamp(g12, min=1e-12), min=0.0))
    ok = (r1 < 1e-4) & (r2 < 1e-4) & (s1 > 0) & (g12 > 1e-12)
    P = torch.stack(
        [s1[..., None] * y3[:, None, 0], (u * s1)[..., None] * y3[:, None, 1],
         (v * s1)[..., None] * y3[:, None, 2]],
        dim=-2,
    )
    Xw = X3[:, None].expand_as(P)
    cw = torch.mean(Xw, dim=-2)
    cc = torch.mean(P, dim=-2)
    C = (P - cc[..., None, :]).transpose(-1, -2) @ (Xw - cw[..., None, :])
    U, _, Vh = torch.linalg.svd(C)
    sgn = torch.sign(torch.linalg.det(U @ Vh))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * diag[..., None, :]) @ Vh
    t = cc - (R @ cw[..., None])[..., 0]
    eye = torch.eye(3, dtype=X3.dtype, device=X3.device)
    R = torch.where(ok[..., None, None], R, eye)
    t = torch.where(ok[..., None], t, torch.full_like(t, 1e12))
    return torch.cat([R, t[..., None]], dim=-1)


def _frozen_solve(key, X, px, xn, valid, K, threshold_px, n_hypotheses=1024, sample_size=6,
                  max_translation=200.0, min_inliers=6, sample_mask=None,
                  prescore_strict_first=False, seen=None):
    """`solve_pnp_ransac` as the package had it: the pick read at 0-dim
    tensor indices, the gate's determinant from `torch.linalg.det`. `seen`
    records whether the 8 px second chance was taken."""
    idx6, idx3 = pnp.pnp_sample_draws(key, valid, n_hypotheses, sample_size, sample_mask)
    models6 = pnp._dlt_pnp(X[idx6], xn[idx6])
    h = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    y = h / torch.linalg.norm(h, dim=-1, keepdim=True)
    models3 = _frozen_p3p_solve(X[idx3], y[idx3])
    models = torch.cat([models6, models3.reshape(-1, 3, 4)])
    score_w = (
        1.0 + (sample_mask & valid).to(X.dtype) if sample_mask is not None
        else torch.ones_like(valid, dtype=X.dtype)
    )
    S = min(pnp.PRESCORE_ROWS, X.shape[0])
    rank = (~valid).to(torch.int8)
    if prescore_strict_first and sample_mask is not None:
        rank = rank * 2 + (~sample_mask).to(torch.int8)
    order = torch.argsort(rank, stable=True)[:S]
    sub_valid = valid[order]
    pres = torch.clamp(pnp._reproj_errors_px(models, X[order], px[order], K), max=1e9)
    pres = torch.where(sub_valid[None, :], pres, torch.zeros_like(pres))
    pre_scores = torch.sum(score_w[order][None, :] * torch.clamp(pres, max=threshold_px), dim=-1)
    T = min(384, models.shape[0])
    top = top_k_indices(-pre_scores, T)
    res = torch.clamp(pnp._reproj_errors_px(models[top], X, px, K), max=1e9)
    res = torch.where(valid[None, :], res, torch.zeros_like(res))
    scores = torch.sum(score_w[None, :] * torch.clamp(res, max=threshold_px), dim=-1)
    best = torch.argmin(scores)
    Rt = models[top[best]]
    inliers = (res[best] < threshold_px) & valid
    n_in = torch.sum(inliers)
    loose = (pnp._reproj_errors_px(Rt, X, px, K) < 8.0) & valid
    use_loose = n_in < torch.clamp(torch.div(torch.sum(valid), 5, rounding_mode="floor"), min=10)
    inliers = torch.where(use_loose, loose, inliers)
    if seen is not None:
        seen["second_chance"] = bool(use_loose)
    R, t = pnp._gauss_newton_refine(Rt[:, :3], Rt[:, 3], X, px, K, inliers.to(X.dtype))
    err1 = pnp._reproj_errors_px(torch.cat([R, t[:, None]], -1), X, px, K)
    w2 = ((err1 < 8.0) & valid).to(X.dtype)
    R, t = pnp._gauss_newton_refine(R, t, X, px, K, w2)
    err = pnp._reproj_errors_px(torch.cat([R, t[:, None]], -1), X, px, K)
    inliers = (err < threshold_px) & valid
    n_in = torch.sum(inliers)
    center = -R.T @ t
    ok = (
        (torch.abs(torch.linalg.det(R) - 1.0) < 1e-3)
        & (torch.linalg.norm(center) <= max_translation)
        & (n_in >= max(sample_size, min_inliers))
    )
    return pnp.PnPResult(R=R, t=t, inliers=inliers, n_inliers=n_in, ok=ok)


# --- the problems --------------------------------------------------------------


def _problem(M, seed, valid_share=0.5, outlier_share=0.2, noise_px=0.4, junk=False, device="cpu"):
    """M rows: world points in front of a camera at a known pose, their
    pixels with noise, a share of the valid rows outliers (or, with `junk`,
    every pixel anywhere in the frame), a share of the rows invalid and a
    strict subset of the valid rows. Returns (X, px, xn, valid, strict, K)."""
    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[FOCAL, 0.0, CX], [0.0, FOCAL, CY], [0.0, 0.0, 1.0]])
    a = math.radians(6.0)
    R = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0], [-math.sin(a), 0.0, math.cos(a)]])
    t = torch.tensor([0.3, -0.1, 0.2])
    X = torch.cat([
        (torch.rand(M, 2, generator=g) - 0.5) * 4.0, 4.0 + 4.0 * torch.rand(M, 1, generator=g),
    ], dim=1)
    Xc = X @ R.T + t
    px = FOCAL * Xc[:, :2] / Xc[:, 2:] + torch.tensor([CX, CY])
    px = px + noise_px * torch.randn(M, 2, generator=g)
    out = torch.rand(M, generator=g) < (1.0 if junk else outlier_share)
    px = torch.where(out[:, None], torch.rand(M, 2, generator=g) * torch.tensor([640.0, 480.0]), px)
    xn = (px - torch.tensor([CX, CY])) / FOCAL
    valid = torch.rand(M, generator=g) < valid_share
    strict = valid & (torch.rand(M, generator=g) < 0.6)
    return tuple(a.to(device) for a in (X, px, xn, valid, strict, K))


# case: (M, problem kwargs, solve kwargs); "no-mask" has fewer rows than the
# prescore takes.
CASES = {
    "strict": (600, dict(), dict(mask=True)),
    "strict-first": (600, dict(), dict(mask=True, prescore_strict_first=True)),
    "no-mask": (200, dict(), dict(mask=False)),
    "no-mask-strict-first": (600, dict(), dict(mask=False, prescore_strict_first=True)),
    "second-chance": (600, dict(noise_px=2.0), dict(mask=True, threshold_px=1.0)),
    "fails": (600, dict(junk=True), dict(mask=True, min_inliers=30)),
}


def _solve_args(case, seed, device="cpu", n_hypotheses=128):
    M, prob, kw = CASES[case]
    X, px, xn, valid, strict, K = _problem(M, seed, device=device, **prob)
    kw = dict(kw)
    mask = strict if kw.pop("mask") else None
    args = (prng.key(seed), X, px, xn, valid, K)
    kwargs = dict(
        threshold_px=kw.pop("threshold_px", THRESHOLD), n_hypotheses=n_hypotheses,
        sample_mask=mask, **kw,
    )
    return args, kwargs


def _assert_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert torch.equal(g, w), f


# --- the CPU: the same values, no sync ------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_solve_equals_the_frozen_function(case, seed):
    """On the CPU `solve_pnp_ransac` gives the function before the split bit
    for bit, captures nothing and counts nothing; each case takes the
    branch it is named for."""
    args, kwargs = _solve_args(case, seed)
    cached = (dict(pnp._NEWTON_GRAPHS), dict(pnp._SELECT_GRAPHS))
    with profiling.recording() as timer:
        got = pnp.solve_pnp_ransac(*args, **kwargs)
    seen = {}
    want = _frozen_solve(*args, **kwargs, seen=seen)
    _assert_equal(got, want)
    assert timer.counters == {}
    assert (pnp._NEWTON_GRAPHS, pnp._SELECT_GRAPHS) == cached
    assert seen["second_chance"] == (case in ("second-chance", "fails"))
    assert bool(got.ok) == (case != "fails")


class _Ops(TorchDispatchMode):
    """Every aten op dispatched in the block, with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((func, args))
        return func(*args, **(kwargs or {}))


def _refused_ops(calls):
    """The ops of `calls` that a capture refuses or that read the device back
    to the host: a scalar read, a nonzero or masked select, a boolean-mask
    index, a tensor made from host memory (a host-to-device copy on the
    card), a copy across devices, and the linear algebra whose error check
    reads back (SVD, eigh, det)."""
    aten = torch.ops.aten
    refused = {
        aten._local_scalar_dense, aten.item, aten.nonzero, aten.nonzero_static, aten.masked_select,
        aten.lift_fresh, aten.lift_fresh_copy, aten._linalg_svd, aten._linalg_eigh,
        aten._linalg_det, aten.linalg_det,
    }
    found = []
    for func, args in calls:
        if func.overloadpacket in refused:
            found.append(str(func))
        elif func.overloadpacket in (aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_):
            if any(t is not None and t.dtype == torch.bool for t in args[1]):
                found.append(str(func))
        elif func.overloadpacket in (aten._to_copy, aten.copy_):
            devices = {a.device for a in args if isinstance(a, torch.Tensor)}
            if len(devices) > 1:
                found.append(str(func))
    return found


def _chain_inputs(case, seed):
    """The two chains' inputs as `solve_pnp_ransac` builds them for a case."""
    args, kwargs = _solve_args(case, seed)
    key, X, px, xn, valid, K = args
    mask = kwargs["sample_mask"]
    idx6, idx3 = pnp.pnp_sample_draws(key, valid, kwargs["n_hypotheses"], 6, mask)
    models6 = pnp._dlt_pnp(X[idx6], xn[idx6])
    h = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    y = h / torch.linalg.norm(h, dim=-1, keepdim=True)
    X3, y3 = X[idx3], y[idx3]
    head = pnp._p3p_newton(X3, y3, pnp._p3p_starts(X3.device))
    models = torch.cat([models6, pnp._p3p_procrustes(*head).reshape(-1, 3, 4)])
    score_w = 1.0 + (mask & valid).to(X.dtype) if mask is not None else torch.ones_like(valid, dtype=X.dtype)
    order = torch.argsort((~valid).to(torch.int8), stable=True)[:min(256, X.shape[0])]
    threshold = torch.full((), kwargs["threshold_px"])
    return (X3, y3), (models, X, px, valid, score_w, order, K, threshold)


@pytest.mark.parametrize("case", ["strict", "second-chance", "fails"])
def test_chains_dispatch_no_refused_op(case):
    """Neither chain reads a scalar back, indexes with a boolean mask, makes
    a tensor from host memory, copies across devices or calls SVD, eigh or
    det: on the card any of them would synchronise or break the capture."""
    newton_in, select_in = _chain_inputs(case, 3)
    starts = pnp._p3p_starts(newton_in[0].device)
    with _Ops() as ops:
        pnp._p3p_newton(*newton_in, starts)
    assert len(ops.calls) > 500
    assert _refused_ops(ops.calls) == []
    with _Ops() as ops:
        out = pnp._select_refine_accept(*select_in, 6, 200.0)
    assert len(ops.calls) > 1000
    assert _refused_ops(ops.calls) == []
    assert bool(out[4]) == (case != "fails")


def test_the_guard_finds_the_frozen_reads():
    """The guard above trips on the function before the split: its pick reads
    0-dim tensor indices back, and its Newton starts come from the host."""
    args, kwargs = _solve_args("strict", 3)
    with _Ops() as ops:
        _frozen_solve(*args, **kwargs)
    found = set(_refused_ops(ops.calls))
    assert "aten._local_scalar_dense.default" in found
    assert "aten.lift_fresh.default" in found


# --- the card: graph against eager ---------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def fresh(monkeypatch):
    """Empty PnP caches, their own memory pool, and a process that has not yet
    solved on the card, for the length of one test."""
    monkeypatch.setattr(pnp, "_NEWTON_GRAPHS", {})
    monkeypatch.setattr(pnp, "_POOLS", {})
    monkeypatch.setattr(pnp, "_SELECT_GRAPHS", {})
    monkeypatch.setattr(pnp, "_WARM", set())


# The registration's shapes at the benchmark's configuration: 2,048
# hypotheses, M = done views x 1,024 slots, ~15% of them valid.
CARD_HYPOTHESES = 2048


def _card_args(card, done_views, seed, strict_first=False):
    M = done_views * 1024
    X, px, xn, valid, strict, K = _problem(M, seed, valid_share=0.15, device=card)
    args = (prng.key(seed), X, px, xn, valid, K)
    kwargs = dict(
        threshold_px=THRESHOLD, n_hypotheses=CARD_HYPOTHESES, min_inliers=20,
        sample_mask=strict, prescore_strict_first=strict_first,
    )
    return args, kwargs


def _eager(monkeypatch, args, kwargs):
    """The solve on the card with both chains dispatched op by op."""
    with monkeypatch.context() as mp:
        mp.setattr(pnp, "_replay_chains", pnp._run_chains)
        return pnp.solve_pnp_ransac(*args, **kwargs)


@pytest.mark.gpu
def test_graph_equals_eager_at_alternating_shapes(card, fresh, monkeypatch):
    """Three shapes called in alternation, twice round: every call after the
    process's first replays, and equals the eager solve bit for bit."""
    shapes = (2, 7, 19)
    problems = {d: _card_args(card, d, 40 + d) for d in shapes}
    pnp.solve_pnp_ransac(*_card_args(card, 3, 5)[0], **_card_args(card, 3, 5)[1])  # eager warm-up
    for _ in range(2):
        for d in shapes:
            args, kwargs = problems[d]
            with profiling.recording() as timer:
                got = pnp.solve_pnp_ransac(*args, **kwargs)
            assert timer.counters.get("pnp_graph_replays") == 1
            _assert_equal(got, _eager(monkeypatch, args, kwargs))
            assert bool(got.ok)


@pytest.mark.gpu
def test_first_capture_after_the_eager_solve_equals_eager(card, fresh, monkeypatch):
    """A process's first solve runs eagerly and counts nothing; the next, at a
    new shape, captures both chains at once and equals eager; the first
    shape again captures only its select chain."""
    a_args, a_kw = _card_args(card, 4, 11)
    b_args, b_kw = _card_args(card, 9, 12)
    with profiling.recording() as timer:
        first = pnp.solve_pnp_ransac(*a_args, **a_kw)
        assert timer.counters == {}
        second = pnp.solve_pnp_ransac(*b_args, **b_kw)
        assert timer.counters == {"pnp_graph_captures": 2, "pnp_graph_replays": 1}
        third = pnp.solve_pnp_ransac(*a_args, **a_kw)
        assert timer.counters == {"pnp_graph_captures": 3, "pnp_graph_replays": 2}
    _assert_equal(first, _eager(monkeypatch, a_args, a_kw))
    _assert_equal(second, _eager(monkeypatch, b_args, b_kw))
    _assert_equal(third, first)
    assert len(pnp._NEWTON_GRAPHS) == 1 and len(pnp._SELECT_GRAPHS) == 2


@pytest.mark.gpu
def test_blind_reselect_replays_the_same_select_graph(card, fresh, monkeypatch):
    """The strict-first reselect differs from the first pick only in its
    prescore rows, an input of the select graph: it replays the same graph,
    and both picks equal eager."""
    pnp.solve_pnp_ransac(*_card_args(card, 3, 5)[0], **_card_args(card, 3, 5)[1])  # eager warm-up
    args, kwargs = _card_args(card, 6, 21)
    pick = pnp.solve_pnp_ransac(*args, **kwargs)
    graphs = dict(pnp._SELECT_GRAPHS)
    strict_kw = dict(kwargs, prescore_strict_first=True)
    with profiling.recording() as timer:
        reselect = pnp.solve_pnp_ransac(*args, **strict_kw)
    assert timer.counters == {"pnp_graph_replays": 1}
    assert dict(pnp._SELECT_GRAPHS) == graphs
    _assert_equal(pick, _eager(monkeypatch, args, kwargs))
    _assert_equal(reselect, _eager(monkeypatch, args, strict_kw))


@pytest.mark.gpu
def test_a_twenty_view_sweep_keeps_every_shape(card, fresh):
    """Done-view counts 1-19 of a 20-view set: the first sweep captures one
    Newton graph and 19 select graphs, the second captures nothing and
    replays every solve; no shape was evicted, and the graphs' memory stays
    within a tenth of the card."""
    problems = [_card_args(card, d, 60 + d) for d in range(1, 20)]
    pnp.solve_pnp_ransac(*_card_args(card, 3, 5)[0], **_card_args(card, 3, 5)[1])  # eager warm-up
    torch.cuda.reset_peak_memory_stats()
    with profiling.recording() as timer:
        firsts = [pnp.solve_pnp_ransac(*a, **k) for a, k in problems]
    assert timer.counters == {"pnp_graph_captures": 20, "pnp_graph_replays": 19}
    keys = list(pnp._SELECT_GRAPHS)
    with profiling.recording() as timer:
        seconds = [pnp.solve_pnp_ransac(*a, **k) for a, k in problems]
    assert timer.counters == {"pnp_graph_replays": 19}
    assert list(pnp._SELECT_GRAPHS) == keys and len(keys) == 19
    assert all(g is not None for g in pnp._SELECT_GRAPHS.values())
    for got, want in zip(seconds, firsts):
        _assert_equal(got, want)
    peak = torch.cuda.max_memory_allocated()
    print(f"PnP graphs, 20-view sweep: peak allocated {peak / 2**30:.3f} GiB, "
          f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    assert peak < 8 * 2**30


@pytest.mark.gpu
def test_captured_chain_reads_each_call_and_shares_a_pool(card):
    """`CapturedChain`: a replay reads each call's tensors and fills (a
    Python float or a 0-dim tensor), its outputs are clones that the next
    replay leaves alone, two chains in one pool keep their own buffers, and
    the counters read one capture each and one replay a call where named."""
    def fn(a, b, s):
        return a * s + b, torch.sum(a) - s

    x = torch.arange(6.0, device=card)
    y = torch.linspace(-1.0, 1.0, 6, device=card)
    two, three = torch.tensor(2.0, device=card), torch.tensor(3.0, device=card)
    pool = torch.cuda.graph_pool_handle()
    with profiling.recording() as timer:
        one = CapturedChain(fn, (x, y), (x.dtype,), "test_captures", "test_replays", pool)
        other = CapturedChain(lambda a, b, s: (a - b * s,), (x, y), (x.dtype,), "test_captures", pool=pool)
        first = one((x, y), (2.0,))
        second = one((y, x), (three,))
        third = other((x, y), (two,))
    assert timer.counters == {"test_captures": 2, "test_replays": 2}
    for got, want in zip(first, fn(x, y, two)):
        assert torch.equal(got, want)
    for got, want in zip(second, fn(y, x, three)):
        assert torch.equal(got, want)
    assert torch.equal(third[0], x - y * two)
