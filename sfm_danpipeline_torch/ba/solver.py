"""Levenberg-Marquardt with Schur-complement elimination of points.

Port of sfm_danpipeline_tpu/ba/solver.py (the reference's Ceres
DENSE_SCHUR semantics): normal-equation blocks from per-observation
Jacobians, the reduced camera (+ shared focal) system by point
elimination, a dense Cholesky solve, back-substitution, and the
accept/reject damping schedule. The reference's `lax.while_loop` is a host
loop here, with one device->host read per iteration for the stop test.

The per-camera, per-point and per-(point, camera) segment sums use
ops/reduce, whose summation order is fixed: a rerun from one state gives the
same bits, on a card too (atomic `index_add_` would not). The observation
lists do not change during a solve, so `run_ba` sorts them once
(`segment_plans`) and every iteration sums through the same three tables.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from sfm_danpipeline_torch.ba.problem import BAProblem
from sfm_danpipeline_torch.ba.residuals import cost as ba_cost
from sfm_danpipeline_torch.ba.residuals import jacobian_blocks
from sfm_danpipeline_torch.config import BAConfig
from sfm_danpipeline_torch.ops.reduce import SegmentPlan, planned_sum, segment_plan


class NormalBlocks(NamedTuple):
    U: torch.Tensor  # (C, 6, 6)
    V: torch.Tensor  # (P, 3, 3)
    G: torch.Tensor  # (P, C, 6, 3) camera-point coupling per point
    Hcf: torch.Tensor  # (C, 6)
    Hpf: torch.Tensor  # (P, 3)
    Hff: torch.Tensor  # ()
    g_c: torch.Tensor  # (C, 6)
    g_p: torch.Tensor  # (P, 3)
    g_f: torch.Tensor  # ()


class SegmentPlans(NamedTuple):
    cam: SegmentPlan  # observations by camera
    pt: SegmentPlan  # observations by point
    pair: SegmentPlan  # observations by (point, camera)


def segment_plans(problem: BAProblem) -> SegmentPlans:
    """The three gather tables of `build_normal_blocks`; they depend on the
    observation lists only, not on the parameters."""
    C, P = problem.n_cameras, problem.n_points
    oc, op = problem.obs_cam, problem.obs_pt
    return SegmentPlans(
        cam=segment_plan(oc, C), pt=segment_plan(op, P), pair=segment_plan(op * C + oc, P * C)
    )


def build_normal_blocks(
    problem: BAProblem, plans: Optional[SegmentPlans] = None
) -> Tuple[NormalBlocks, torch.Tensor]:
    """Gauss-Newton normal-equation blocks and the current cost. `plans`
    (default: made here) must be `segment_plans` of the same observations."""
    C, P = problem.n_cameras, problem.n_points
    if plans is None:
        plans = segment_plans(problem)
    r, Jc, Jf, Jp = jacobian_blocks(
        problem.cameras, problem.focal, problem.points, problem.obs_cam,
        problem.obs_pt, problem.obs_xy, problem.obs_w,
    )
    # Frozen parameters: zero their Jacobian columns.
    Jc = Jc * (~problem.fix_cam[problem.obs_cam]).to(Jc.dtype)[:, None, None]
    Jf = Jf * (~problem.fix_focal).to(Jf.dtype)
    if problem.fix_pt is not None:
        Jp = Jp * (~problem.fix_pt[problem.obs_pt]).to(Jp.dtype)[:, None, None]
    JcT = Jc.transpose(1, 2)
    JpT = Jp.transpose(1, 2)
    blocks = NormalBlocks(
        U=planned_sum(JcT @ Jc, plans.cam),
        V=planned_sum(JpT @ Jp, plans.pt),
        G=planned_sum(JcT @ Jp, plans.pair).reshape(P, C, 6, 3),
        Hcf=planned_sum((JcT @ Jf)[..., 0], plans.cam),
        Hpf=planned_sum((JpT @ Jf)[..., 0], plans.pt),
        Hff=torch.sum(Jf * Jf),
        g_c=planned_sum((JcT @ r[..., None])[..., 0], plans.cam),
        g_p=planned_sum((JpT @ r[..., None])[..., 0], plans.pt),
        g_f=torch.sum(Jf[..., 0] * r),
    )
    return blocks, 0.5 * torch.sum(r * r)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    Gg = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d  # noqa: E741
    det = a * A + b * B + c * Cc
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack(
        [
            torch.stack([A, D, Gg], dim=-1),
            torch.stack([B, E, H], dim=-1),
            torch.stack([Cc, F, I], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def schur_solve(
    blocks: NormalBlocks, lam: torch.Tensor, fix_cam: torch.Tensor, fix_focal: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve the Marquardt-damped normal equations by point elimination.
    Returns (delta_cam (C,6), delta_f (), delta_pt (P,3))."""
    C = blocks.U.shape[0]
    P = blocks.V.shape[0]
    dt, dev = blocks.U.dtype, blocks.U.device
    eyeC = torch.eye(6, dtype=dt, device=dev)
    eyeP = torch.eye(3, dtype=dt, device=dev)
    dU = blocks.U + lam * blocks.U * eyeC + 1e-8 * eyeC
    dV = blocks.V + lam * blocks.V * eyeP + 1e-8 * eyeP
    dff = blocks.Hff * (1.0 + lam) + 1e-8
    fixC = fix_cam.to(dt)[:, None, None]
    dU = dU * (1.0 - fixC) + eyeC * fixC
    dff = torch.where(fix_focal, torch.ones_like(dff), dff)

    Vinv = _inv3(dV)
    Gf = blocks.G.reshape(P, C * 6, 3)
    GV = torch.einsum("pac,pcd->pad", Gf, Vinv)
    S_cc = -torch.einsum("pac,pbc->ab", GV, Gf) + torch.block_diag(*dU.unbind(0))
    S_cf = blocks.Hcf.reshape(C * 6) - torch.einsum("pac,pc->a", GV, blocks.Hpf)
    S_ff = dff - torch.einsum("pc,pcd,pd->", blocks.Hpf, Vinv, blocks.Hpf)
    rhs_c = -blocks.g_c.reshape(C * 6) + torch.einsum("pac,pc->a", GV, blocks.g_p)
    rhs_f = -blocks.g_f + torch.einsum("pc,pcd,pd->", blocks.Hpf, Vinv, blocks.g_p)

    S = torch.cat(
        [
            torch.cat([S_cc, S_cf[:, None]], dim=1),
            torch.cat([S_cf, S_ff[None]])[None, :],
        ]
    )
    rhs = torch.cat([rhs_c, rhs_f[None]])
    L, info = torch.linalg.cholesky_ex(S)
    delta = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    # A failed factorization yields NaN (as the reference's Cholesky does),
    # so the step's cost is NaN and the LM loop rejects it.
    delta = torch.where(info == 0, delta, torch.full_like(delta, float("nan")))
    delta_c = delta[: C * 6].reshape(C, 6)
    delta_f = delta[-1]
    Wt_dc = torch.einsum("pcab,ca->pb", blocks.G, delta_c)
    rhs_p = -blocks.g_p - Wt_dc - blocks.Hpf * delta_f
    delta_p = torch.einsum("pcd,pd->pc", Vinv, rhs_p)
    delta_c = delta_c * (~fix_cam).to(dt)[:, None]
    delta_f = torch.where(fix_focal, torch.zeros_like(delta_f), delta_f)
    return delta_c, delta_f, delta_p


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class BAResult(NamedTuple):
    cameras: torch.Tensor
    focal: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    converged: torch.Tensor


def run_ba(
    problem: BAProblem,
    config: BAConfig = BAConfig(),
    max_iterations: Optional[int] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> BAResult:
    """LM loop: assemble -> Schur solve -> accept/reject, until the
    relative decrease falls under rtol in the Newton regime, lambda hits
    its cap, or the iteration budget (`max_iterations`, default
    config.max_iterations) runs out.

    `reduce` is the counterpart of the reference's `axis_name`: when the
    problem's observation arrays are one shard of a larger table, it sums a
    tensor over the shards (an all-reduce across processes,
    parallel/distributed.py). It is applied to every cost and to every field
    of the normal blocks, so the reduced camera system is solved replicated.
    The default (none) is the single-device solve."""
    obs = (problem.obs_cam, problem.obs_pt, problem.obs_xy, problem.obs_w)
    if reduce is None:
        reduce = _identity
    budget = config.max_iterations if max_iterations is None else int(max_iterations)
    plans = segment_plans(problem) if budget > 0 else None

    def cost_of(cameras, focal, points):
        return reduce(ba_cost(cameras, focal, points, *obs))

    def blocks_of(prob):
        return NormalBlocks(*(reduce(b) for b in build_normal_blocks(prob, plans)[0]))

    return lm_solve(problem, config, budget, cost_of, blocks_of)


def lm_solve(
    problem: BAProblem,
    config: BAConfig,
    budget: int,
    cost_of: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    blocks_of: Callable[[BAProblem], NormalBlocks],
) -> BAResult:
    """The LM iteration of `run_ba` around two callables: `cost_of(cameras,
    focal, points)`, the total cost, and `blocks_of(problem)`, the total
    normal blocks at the problem's parameters (ba/sharded.py sums both over
    observation shards)."""
    cameras, focal, points = problem.cameras, problem.focal, problem.points
    c0 = cost_of(cameras, focal, points)
    cur = c0
    lam = torch.tensor(config.init_lambda, dtype=torch.float32, device=c0.device)
    it = 0
    done = torch.tensor(False, device=c0.device)
    while it < budget:
        prob = dataclasses.replace(problem, cameras=cameras, focal=focal, points=points)
        blocks = blocks_of(prob)
        dc, df, dp = schur_solve(blocks, lam, problem.fix_cam, problem.fix_focal)
        new_cams, new_focal, new_points = cameras + dc, focal + df, points + dp
        new_cost = cost_of(new_cams, new_focal, new_points)
        accept = new_cost < cur
        rel_decrease = (cur - new_cost) / torch.clamp(cur, min=1e-20)
        cameras = torch.where(accept, new_cams, cameras)
        focal = torch.where(accept, new_focal, focal)
        points = torch.where(accept, new_points, points)
        cur = torch.where(accept, new_cost, cur)
        lam = torch.where(accept, lam * config.lambda_down, lam * config.lambda_up)
        lam = torch.clamp(lam, config.min_lambda, config.max_lambda)
        # Convergence only in the Newton regime (small lambda).
        done = (accept & (rel_decrease < config.rtol) & (lam <= config.init_lambda)) | (
            lam >= config.max_lambda
        )
        it += 1
        if bool(done):
            break
    return BAResult(
        cameras=cameras, focal=focal, points=points, initial_cost=c0,
        final_cost=cur, iterations=it, converged=done | (cur < c0),
    )
