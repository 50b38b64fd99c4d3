"""Multi-process driver on torch.distributed: process initialization, the
host-sharded input stages, the multi-process form of the
observation-sharded bundle adjuster, and the single-writer SfM driver.

Port of sfm_danpipeline_tpu/parallel/distributed.py. The recipe:

  1. every process calls `initialize()` (a `tcp://` rendezvous at the
     coordinator; rank and world size given explicitly);
  2. each process computes features for its contiguous image block and
     matches for its contiguous pair block; the blocks are all-gathered, so
     every process holds the full arrays;
  3. rank 0 alone runs the sequential incremental loop (`SfMPipeline.run` on
     the gathered inputs) and broadcasts the result once: a packed byte
     buffer of the state, the registered-view mask and the metrics;
  4. every process polishes the map together: an observation-sharded LM
     whose per-rank normal blocks are summed by `all_reduce`.

Backend: NCCL when every local rank has a card of its own, otherwise gloo
(two ranks on one card, or the CPU). Over gloo the all-gathers and the
broadcast stage CUDA tensors through the host; the computation itself stays
on the rank's device.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sfm_danpipeline_torch import require_device
from sfm_danpipeline_torch.ba.problem import BAProblem
from sfm_danpipeline_torch.ba.solver import BAResult, run_ba
from sfm_danpipeline_torch.config import BAConfig, PipelineConfig

log = logging.getLogger("sfm_danpipeline_torch")

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")

# The metrics rank 0 broadcasts with the state (the reference's list).
_BCAST_METRICS = (
    "ba_rms_px", "ba_n_obs", "ba_iterations", "n_points",
    "n_registered", "n_components", "n_merged_components",
    "merge_cross_med_px", "n_cross_tracks", "n_keypoints_mean",
    "focal",
)


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    device: str | torch.device = "cuda",
) -> torch.device:
    """Join the multi-process job and return this rank's device.

    `coordinator` is HOST:PORT (a `tcp://` rendezvous there) or a full
    init-method URL (`tcp://...`, `file://...`). The local ranks are every
    rank when the coordinator is this host, else one per host, unless
    LOCAL_RANK / LOCAL_WORLD_SIZE say otherwise. With `device="cuda"` the
    rank computes on card local_rank % device_count and raises where there
    is no card; the backend is NCCL when every local rank has a card of its
    own, else gloo. The choice is logged and `backend()` returns it."""
    dev = require_device(device)
    host = coordinator.split("://")[-1].rsplit(":", 1)[0]
    local_world = int(os.environ.get(
        "LOCAL_WORLD_SIZE", num_processes if host in _LOCAL_HOSTS else 1
    ))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id % local_world))
    name = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        if local_world <= n_cards:
            name = "nccl"
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(name, init_method=init, world_size=num_processes, rank=process_id)
    log.info(
        "rank %d of %d (local rank %d of %d): backend %s, device %s",
        process_id, num_processes, local_rank, local_world, name, dev,
    )
    return dev


def shutdown() -> None:
    """Leave the job (destroys the process group, if one was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def backend() -> str:
    """The process group's backend ("nccl" or "gloo")."""
    return str(dist.get_backend())


def host_shard(n_items: int) -> Tuple[int, int]:
    """[start, end) of a length-n work list owned by this rank: contiguous
    blocks of ceil(n / world) (the last ones shorter or empty)."""
    p, n = dist.get_rank(), dist.get_world_size()
    per = -(-n_items // n)
    return min(p * per, n_items), min((p + 1) * per, n_items)


def _block_rows(n_items: int) -> np.ndarray:
    """This rank's rows of an equal-size, clip-padded split: ceil(n / world)
    indices from rank * per on, clipped to n - 1, so every rank holds a
    block of one size and the first n rows of the gathered blocks are rows
    0..n-1 in order."""
    per = -(-n_items // dist.get_world_size())
    s = dist.get_rank() * per
    return np.clip(np.arange(s, s + per), 0, n_items - 1)


def _staged(t: torch.Tensor, fn: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """Run the in-place collective `fn` on a copy of `t`: on the host over
    gloo (which takes few collectives on CUDA tensors), on the card over
    NCCL. Returns the result on `t`'s device."""
    buf = t.cpu() if backend() == "gloo" else t
    buf = buf.clone()
    fn(buf)
    return buf.to(t.device)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (every rank gets the same bits)."""
    return _staged(t, lambda b: dist.all_reduce(b, op=dist.ReduceOp.SUM))


def _all_gather_rows(t: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Concatenate every rank's equal-shape `t` along dim 0 (rank order) and
    keep the first `n_keep` rows."""
    src = t.cpu() if backend() == "gloo" else t
    src = src.contiguous()
    if src.dtype == torch.bool:  # collectives take bytes
        src = src.view(torch.uint8)
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, src)
    return torch.cat(outs)[:n_keep].view(t.dtype).to(t.device)


def _gather_fields(obj, n_keep: int):
    """A dataclass of tensors with every field gathered along dim 0."""
    return type(obj)(
        *(_all_gather_rows(getattr(obj, f.name), n_keep) for f in dataclasses.fields(obj))
    )


def run_ba_multihost(
    local_problem: BAProblem,
    config: BAConfig = BAConfig(),
    max_iterations: Optional[int] = None,
) -> BAResult:
    """Observation-sharded LM across processes: `local_problem` holds this
    rank's observation rows (the same count on every rank; pad with weight-0
    rows) and the replicated parameters. Every cost and normal block is
    summed over the ranks (all_reduce), and the reduced camera solve runs
    replicated, so every rank returns the same result."""
    return run_ba(local_problem, config, max_iterations=max_iterations, reduce=all_reduce_sum)


def _detect_local(gray: torch.Tensor, cfg):
    """The pipeline's detector switch applied to this rank's image block."""
    from sfm_danpipeline_torch.ops.akaze import detect_and_compute_akaze_batch
    from sfm_danpipeline_torch.ops.orb import detect_and_compute_orb_batch
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch

    if cfg.detector == "orb":
        return detect_and_compute_orb_batch(gray, max_keypoints=cfg.max_keypoints)
    if cfg.detector == "akaze":
        return detect_and_compute_akaze_batch(gray, cfg)
    return detect_and_compute_batch(gray, cfg)


def compute_features_multihost(images, config: PipelineConfig, device: torch.device):
    """Host-sharded feature extraction: each rank detects on its contiguous
    image block (clip-padded to equal size); the full Keypoints batch is
    assembled by all_gather and is the same on every rank."""
    V = images.n_images
    idx = _block_rows(V)
    kp_local = _detect_local(torch.as_tensor(images.gray[idx], device=device), config.features)
    return _gather_fields(kp_local, V)


def compute_matches_multihost(kp, n_images: int, config: PipelineConfig):
    """Pair-block-sharded matching across ranks: the pair list of
    `_pair_list(V)` splits into contiguous equal blocks (clip-padded); each
    rank matches its block with the pipeline's parameters (on a card through
    the knn2 kernel), and the full PairMatches is assembled by all_gather."""
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.pipeline.sfm import _pair_list

    cfg = config.matching
    pi, pj = (np.asarray(a, np.int32) for a in _pair_list(n_images))
    idx = _block_rows(len(pi))
    dev = kp.descriptors.device
    m_local = match_all_pairs(
        kp.descriptors, kp.valid, torch.as_tensor(pi[idx], device=dev),
        torch.as_tensor(pj[idx], device=dev), ratio=max(cfg.ratio, cfg.registration_ratio),
        max_matches=cfg.max_matches, strict_ratio=cfg.ratio, xy=kp.xy,
        dup_radius=cfg.dup_radius, dedup=cfg.dedup_matches,
    )
    return _gather_fields(m_local, len(pi))


def _layout(tensors: Sequence[torch.Tensor]) -> int:
    """A fingerprint of the buffer layout: every tensor's dtype and shape."""
    desc = ";".join(f"{t.dtype}{tuple(t.shape)}" for t in tensors)
    return zlib.crc32(desc.encode())


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat uint8 tensor: a 16-byte header (payload byte count and the
    layout fingerprint, int64 each), then every tensor's bytes in order."""
    dev = tensors[0].device
    body = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    n = sum(b.numel() for b in body)
    head = torch.tensor([n, _layout(tensors)], dtype=torch.int64, device=dev).view(torch.uint8)
    return torch.cat([head] + [b.to(dev) for b in body])


def unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of `pack` into tensors shaped as `like`; raises unless the
    header's byte count and layout match `like` and the buffer's length."""
    n, fingerprint = buf[:16].clone().view(torch.int64).tolist()
    want = sum(t.numel() * t.element_size() for t in like)
    if n != want or buf.numel() != 16 + want or fingerprint != _layout(like):
        raise ValueError(
            f"packed buffer does not match its template: header {n} bytes "
            f"(layout {fingerprint}), buffer {buf.numel() - 16} bytes, template "
            f"{want} bytes (layout {_layout(like)})"
        )
    out, off = [], 16
    for t in like:
        nb = t.numel() * t.element_size()
        out.append(buf[off:off + nb].clone().view(t.dtype).reshape(t.shape).to(t.device))
        off += nb
    return out


def run_sfm_multihost(
    images,
    intrinsics,
    config: Optional[PipelineConfig] = None,
    run_ba_every_view: bool = True,
    polish_iterations: int = 12,
    checkpoint_path: Optional[str] = None,
    device: str | torch.device = "cuda",
):
    """Multi-process SfM: host-sharded features -> pair-block-sharded
    matching -> the incremental loop on rank 0 alone, its result broadcast
    once -> the observation-sharded multi-process polish of the final map.
    Call `initialize()` first on every rank and pass the device it returned.
    A one-process job runs the plain pipeline plus the polish.

    `checkpoint_path`: per-view checkpoints, written by rank 0 only (the only
    rank that runs the loop)."""
    from sfm_danpipeline_torch.ops.projection import undistort_points
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline, SfMResult
    from sfm_danpipeline_torch.pipeline.tracks import init_state

    if config is None:
        config = PipelineConfig()
    dev = require_device(device)
    rank, nproc = dist.get_rank(), dist.get_world_size()
    kp = compute_features_multihost(images, config, dev)
    # Canonicalize the keypoints to ideal pinhole pixels before matching when
    # the lens model is nonzero, as the single-process pipeline does: the
    # co-location test inside matching must see the same coordinates.
    raw_xy = None
    if bool(np.any(np.asarray(intrinsics.dist) != 0.0)):
        K = torch.as_tensor(intrinsics.K, dtype=torch.float32, device=dev)
        raw_xy = kp.xy.cpu().numpy()
        xn = undistort_points(kp.xy, K, torch.as_tensor(intrinsics.dist, dtype=torch.float32, device=dev))
        ideal = torch.stack([xn[..., 0] * K[0, 0] + K[0, 2], xn[..., 1] * K[1, 1] + K[1, 2]], dim=-1)
        kp = dataclasses.replace(kp, xy=ideal)
    matches = compute_matches_multihost(kp, images.n_images, config)
    pipe = SfMPipeline(
        config, checkpoint_path=checkpoint_path if rank == 0 else None, device=dev,
        shard_devices=[dev],
    )
    run_kw = dict(
        run_ba_every_view=run_ba_every_view, precomputed_keypoints=kp,
        precomputed_matches=matches, precomputed_canonical=True, precomputed_raw_xy=raw_xy,
    )
    if nproc == 1:
        result = pipe.run(images, intrinsics, **run_kw)
    else:
        # Single writer: the sequential loop is deterministic, so running it
        # on every rank buys nothing and costs N-fold compute; rank 0 runs it
        # and broadcasts the state once (one flat byte buffer).
        V = images.n_images
        template = init_state(
            V, config.features.max_keypoints, config.max_points, float(intrinsics.fx), device=dev
        )
        fields = [f.name for f in dataclasses.fields(template)]
        reg = torch.zeros((V,), dtype=torch.int32, device=dev)
        mvec = torch.zeros((len(_BCAST_METRICS),), dtype=torch.float32, device=dev)
        if rank == 0:
            result = pipe.run(images, intrinsics, **run_kw)
            state0 = result.state
            reg[result.registered_views] = 1
            mvec = torch.tensor(
                [float(result.metrics.get(k, np.nan)) for k in _BCAST_METRICS],
                dtype=torch.float32, device=dev,
            )
        else:
            state0 = template
        like = [getattr(template, f) for f in fields] + [reg, mvec]
        buf = pack([getattr(state0, f) for f in fields] + [reg, mvec])
        got = unpack(_staged(buf, lambda b: dist.broadcast(b, src=0)), like)
        state = dataclasses.replace(template, **dict(zip(fields, got[:-2])))
        reg, mvec = got[-2].cpu().numpy(), got[-1].cpu().numpy()
        if rank == 0:
            result = dataclasses.replace(result, state=state)
        else:
            valid = state.points_valid.cpu().numpy()
            result = SfMResult(
                state=state, keypoints=kp,
                points=state.points_xyz.cpu().numpy()[valid],
                colors=state.points_rgb.cpu().numpy()[valid],
                registered_views=[int(v) for v in np.nonzero(reg)[0]],
                metrics={k: float(v) for k, v in zip(_BCAST_METRICS, mvec) if not np.isnan(v)},
                raw_xy=raw_xy,
            )
    result = polish_multihost(result, intrinsics, config, polish_iterations)
    result.metrics["dist_backend"] = backend()
    return result


def polish_multihost(result, intrinsics, config: PipelineConfig, polish_iterations: int = 12):
    """The multi-process global polish of a finished reconstruction, entered
    by every rank with the same `result`: the compact observation rows are
    split into equal clip-padded blocks (padding weighted 0) and solved by
    run_ba_multihost with camera registered_views[0] as the gauge anchor and
    the focal frozen unless ba.optimize_focal. Below ba.sharded_min_obs
    observations the pipeline's own final BA stands and the routing is
    recorded instead (mh_polish_skipped, mh_n_obs, n_processes)."""
    from sfm_danpipeline_torch.pipeline.tracks import live_observations, observation_table_compact

    if not result.registered_views:
        return result
    state = result.state
    dev = state.device
    nproc = dist.get_world_size()
    n_pts = int(torch.sum(state.points_valid))
    n_obs = int(torch.sum(live_observations(state)))
    if n_pts == 0 or n_obs < 16:
        return result
    if n_obs < config.ba.sharded_min_obs:
        # The pipeline's final BA already solved this replicated; a sharded
        # re-polish pays a collective per LM iteration, which costs more than
        # the solve at this size (config.ba.sharded_min_obs).
        return dataclasses.replace(result, metrics={
            **result.metrics, "mh_polish_skipped": 1.0, "mh_n_obs": float(n_obs),
            "n_processes": float(nproc),
        })
    pp = torch.tensor([intrinsics.cx, intrinsics.cy], dtype=torch.float32, device=dev)
    obs_cam, obs_pt, obs_xy, obs_w = observation_table_compact(state, result.keypoints.xy, pp)
    idx = _block_rows(n_obs)
    pad = torch.as_tensor(np.arange(len(idx)) + dist.get_rank() * len(idx) >= n_obs, device=dev)
    idx = torch.as_tensor(idx, device=dev)
    fix_cam = ~state.camera_valid
    fix_cam[result.registered_views[0]] = True  # gauge anchor
    local = BAProblem(
        cameras=state.cameras, focal=state.focal, points=state.points_xyz,
        obs_cam=obs_cam[idx], obs_pt=obs_pt[idx], obs_xy=obs_xy[idx],
        obs_w=torch.where(pad, torch.zeros_like(obs_w[idx]), obs_w[idx]),
        fix_cam=fix_cam, fix_focal=torch.tensor(not config.ba.optimize_focal, device=dev),
    )
    res = run_ba_multihost(local, BAConfig(max_iterations=polish_iterations))
    state = dataclasses.replace(state, cameras=res.cameras, points_xyz=res.points, focal=res.focal)
    valid = state.points_valid.cpu().numpy()
    return dataclasses.replace(
        result, state=state, points=res.points.cpu().numpy()[valid],
        metrics={
            **result.metrics, "mh_polish_cost0": float(res.initial_cost),
            "mh_polish_cost1": float(res.final_cost), "n_processes": float(nproc),
        },
    )
