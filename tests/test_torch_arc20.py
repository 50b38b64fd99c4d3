"""The benchmark's 20-view arc (portbench/configs/arc20-sift.json: the
courtyard over 0.4 of the ring from 0 degrees, 480x640, f = 520 px, the
source's principal point 302.2, 246.87), rendered on the CPU at texture
seeds where the reference leaves views out, through both packages with the
default config and key.

There the port departs from the reference (ROADMAP.md, known defects of the
reference: a blind PnP prescore): it registers every view the reference
registers and the ones the reference leaves out, meets the repository's
quality gates, and takes the reference's decision on the rotation-averaging
reinit (kept or not). Seed 1618033988 is the seed whose reinit once emptied
the BA table on the card; 2331044326 left views 18 and 19 out.
"""
import numpy as np
import pytest

from portbench.reference.scene import render
from sfm_danpipeline_torch.config import PipelineConfig
from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch
from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers

ARC20 = dict(n_views=20, ring_fraction=0.4, arc_start_deg=0.0, height=480, width=640, focal=520.0,
             cx=302.2, cy=246.87)


def _ate_pct(cameras, scene, regs):
    gt = scene.centers[regs]
    d = float(np.max(np.linalg.norm(scene.centers[:, None] - scene.centers[None], axis=-1)))
    return 100.0 * aligned_rmse(camera_centers(cameras)[regs], gt) / d


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1618033988, 2331044326])
def test_arc20_seed_the_reference_leaves_views_out(seed):
    from sfm_danpipeline_tpu.config import PipelineConfig as JConfig
    from sfm_danpipeline_tpu.io.calibration import Intrinsics as JIntrinsics
    from sfm_danpipeline_tpu.io.images import ImageBatch as JImageBatch
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline

    scene = render(seed=seed, device="cpu", **ARC20)
    V, H, W = scene.gray.shape
    parts = dict(
        gray=scene.gray, color=np.repeat(scene.gray[..., None], 3, axis=-1),
        sizes=np.tile(np.array([[H, W]], np.int32), (V, 1)), paths=tuple(f"view_{v:04d}" for v in range(V)),
    )
    K, dist = scene.K.astype(np.float32), np.zeros((5,), np.float32)
    rj = JPipeline(JConfig()).run(JImageBatch(**parts), JIntrinsics(K=K, dist=dist))
    rt = SfMPipeline(PipelineConfig(), device="cpu").run(ImageBatch(**parts), Intrinsics(K=K, dist=dist))
    regs_j, regs_t = sorted(rj.registered_views), sorted(rt.registered_views)
    assert len(regs_j) < V  # the reference leaves views out here
    assert set(regs_j) <= set(regs_t) and len(regs_t) == V
    m = rt.metrics
    assert m["ba_rms_px"] < 1.0 and m["n_points"] >= 1000, m
    assert _ate_pct(rt.state.cameras.numpy(), scene, regs_t) < 1.0
    assert m.get("rotavg_applied", 0.0) == rj.metrics.get("rotavg_applied", 0.0)
    # The views the reference left out came in by a blind pick reselected.
    assert rt.trace["counters"].get("pnp_reselect_taken", 0) > 0
