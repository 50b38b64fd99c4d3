"""Multi-device bundle adjustment: observation-sharded LM over a device list.

Port of sfm_danpipeline_tpu/ba/sharded.py. The observation table is cut
into contiguous shards, one per device; every LM iteration builds each
shard's normal-equation blocks and cost on that shard's device, sums them on
`devices[0]` in shard order (the reference's psum, here with a fixed order,
so reruns give the same bits), and solves the small reduced camera system
there. The parameters live on `devices[0]` and are copied to the other
shards' devices once per evaluation.

A list that repeats one device (`[cuda:0] * 4`, `[cpu] * 8`) is legal: it
runs the same sharded arithmetic on one device, as the reference's tests run
it on a simulated 8-device CPU mesh. The sharded solve matches the
single-device one to float32 reduction-order tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from sfm_danpipeline_torch.ba.problem import BAProblem
from sfm_danpipeline_torch.ba.residuals import cost as ba_cost
from sfm_danpipeline_torch.ba.solver import (
    BAResult,
    NormalBlocks,
    build_normal_blocks,
    lm_solve,
    segment_plans,
)
from sfm_danpipeline_torch.config import BAConfig


def default_devices() -> List[torch.device]:
    """Every local CUDA card; raises where there is none.

    Local, not global: these devices back the sharded paths inside the
    single-process pipeline (SfMPipeline). In a multi-process job only rank 0
    runs that pipeline (single-writer, parallel/distributed.run_sfm_multihost),
    so nothing here may issue a collective that the other processes would
    have to join. Cross-process sharding belongs to run_ba_multihost, which
    every process enters together."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "sharded bundle adjustment defaults to the local CUDA cards and "
            "there is none; pass devices=[torch.device('cpu')] * n to shard on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def pad_observations(problem: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation axis to a multiple of `multiple` with weight-0
    rows (camera 0, point 0, which the solve provably ignores)."""
    pad = (-problem.n_obs) % multiple
    if pad == 0:
        return problem

    def extend(a, fill_shape):
        return torch.cat([a, a.new_zeros((pad,) + fill_shape)])

    return dataclasses.replace(
        problem,
        obs_cam=extend(problem.obs_cam, ()),
        obs_pt=extend(problem.obs_pt, ()),
        obs_xy=extend(problem.obs_xy, (2,)),
        obs_w=extend(problem.obs_w, ()),
    )


def _on(problem: BAProblem, device: torch.device, lo: int, hi: int) -> BAProblem:
    """Observations [lo, hi) of `problem`, everything on `device`."""
    return dataclasses.replace(
        problem,
        cameras=problem.cameras.to(device),
        focal=problem.focal.to(device),
        points=problem.points.to(device),
        obs_cam=problem.obs_cam[lo:hi].to(device),
        obs_pt=problem.obs_pt[lo:hi].to(device),
        obs_xy=problem.obs_xy[lo:hi].to(device),
        obs_w=problem.obs_w[lo:hi].to(device),
        fix_cam=problem.fix_cam.to(device),
        fix_focal=problem.fix_focal.to(device),
        fix_pt=None if problem.fix_pt is None else problem.fix_pt.to(device),
    )


def _ordered_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """parts[0] + parts[1] + ... on `device`, always in this order."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def run_ba_sharded(
    problem: BAProblem,
    config: BAConfig = BAConfig(),
    devices: Optional[Sequence[torch.device | str]] = None,
    max_iterations: Optional[int] = None,
) -> BAResult:
    """Observation-sharded LM bundle adjustment over `devices` (default:
    `default_devices()`). The parameters are replicated and the result lies
    on `devices[0]`; each LM iteration costs one gather of every shard's
    (small) reduced blocks onto `devices[0]` plus the dense solve there."""
    devs = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n = len(devs)
    problem = pad_observations(problem, n)
    home = devs[0]
    per = problem.n_obs // n
    shards = [_on(problem, d, k * per, (k + 1) * per) for k, d in enumerate(devs)]
    plans = [segment_plans(s) for s in shards]
    home_problem = _on(problem, home, 0, 0)
    budget = config.max_iterations if max_iterations is None else int(max_iterations)

    def at(shard, cameras, focal, points):
        d = shard.cameras.device
        return dataclasses.replace(
            shard, cameras=cameras.to(d), focal=focal.to(d), points=points.to(d)
        )

    def cost_of(cameras, focal, points):
        costs = []
        for s in shards:
            s = at(s, cameras, focal, points)
            costs.append(ba_cost(s.cameras, s.focal, s.points, s.obs_cam, s.obs_pt, s.obs_xy, s.obs_w))
        return _ordered_sum(costs, home)

    def blocks_of(prob):
        per_shard = [
            build_normal_blocks(at(s, prob.cameras, prob.focal, prob.points), plan)[0]
            for s, plan in zip(shards, plans)
        ]
        return NormalBlocks(*(_ordered_sum(f, home) for f in zip(*per_shard)))

    return lm_solve(home_problem, config, budget, cost_of, blocks_of)
