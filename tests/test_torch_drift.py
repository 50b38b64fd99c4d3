"""Drift and isolation checks for the port.

The port carries copies of the reference's numpy-only modules (config,
calibration and image I/O, the synthetic scene, the metrics) because
importing them through sfm_danpipeline_tpu runs its __init__, which
imports JAX. These tests keep each copy equal to its original, and check
in a fresh interpreter that the port imports and runs its whole slice
without loading JAX.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np

import sfm_danpipeline_tpu.config as j_config
import sfm_danpipeline_torch.config as t_config
from sfm_danpipeline_tpu.io import calibration as j_calib
from sfm_danpipeline_tpu.io import images as j_images
from sfm_danpipeline_tpu.utils import metrics as j_metrics
from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene as j_scene
from sfm_danpipeline_torch.io import calibration as t_calib
from sfm_danpipeline_torch.io import images as t_images
from sfm_danpipeline_torch.utils import metrics as t_metrics
from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene as t_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def test_config_defaults_equal_field_by_field():
    j = _fields(j_config.PipelineConfig())
    t = _fields(t_config.PipelineConfig())
    assert j == t
    assert len(t) > 80


def test_courtyard_scene_bitwise_equal():
    kw = dict(n_views=2, height=48, width=64, ring_fraction=0.1, seed=3)
    a, b = j_scene(**kw), t_scene(**kw)
    for name in ("R", "t", "centers"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("gray", "color", "sizes"):
        np.testing.assert_array_equal(getattr(a.images, name), getattr(b.images, name))
    np.testing.assert_array_equal(a.intrinsics.K, b.intrinsics.K)
    np.testing.assert_array_equal(a.intrinsics.dist, b.intrinsics.dist)


def test_calibration_and_image_loading_equal(tmp_path):
    xml = tmp_path / "calib.xml"
    xml.write_text(textwrap.dedent("""\
        <?xml version="1.0"?>
        <opencv_storage>
        <Camera_Matrix type_id="opencv-matrix"><rows>3</rows><cols>3</cols><dt>d</dt>
        <data>1520.4 0. 302.3 0. 1525.9 246.9 0. 0. 1.</data></Camera_Matrix>
        <Distortion_Coefficients type_id="opencv-matrix"><rows>1</rows><cols>4</cols><dt>d</dt>
        <data>0.1 -0.2 0.001 0.002</data></Distortion_Coefficients>
        </opencv_storage>
        """))
    a, b = j_calib.load_calibration(str(xml)), t_calib.load_calibration(str(xml))
    np.testing.assert_array_equal(a.K, b.K)
    np.testing.assert_array_equal(a.dist, b.dist)
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (40, 50, 3), dtype=np.uint8)).save(tmp_path / f"im{i}.png")
    ia, ib = j_images.load_images(str(tmp_path)), t_images.load_images(str(tmp_path))
    np.testing.assert_array_equal(ia.gray, ib.gray)
    np.testing.assert_array_equal(ia.color, ib.color)
    assert ia.paths == ib.paths


def test_metrics_equal():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(12, 3))
    dst = 2.0 * src @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.0 + 0.01 * rng.normal(size=(12, 3))
    assert j_metrics.umeyama_alignment(src, dst)[0] == t_metrics.umeyama_alignment(src, dst)[0]
    assert j_metrics.aligned_rmse(src, dst) == t_metrics.aligned_rmse(src, dst)
    cams = (rng.normal(size=(5, 6)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(
        t_metrics.camera_centers(cams), j_metrics.camera_centers(cams), rtol=1e-5, atol=1e-6
    )


def test_port_imports_and_runs_without_jax():
    """A fresh interpreter imports every port module and runs the slice
    end to end (V=3 courtyard) with JAX never loaded."""
    code = textwrap.dedent("""\
        import importlib, pkgutil, sys
        import torch
        torch.set_num_threads(1)
        import sfm_danpipeline_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig
        from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
        from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene
        sc = make_courtyard_scene(n_views=3, height=240, width=320, ring_fraction=0.06, seed=0)
        cfg = PipelineConfig(features=FeatureConfig(max_keypoints=1024))
        res = SfMPipeline(cfg, device="cpu").run(sc.images, sc.intrinsics)
        assert res.metrics["n_registered"] == 3, res.metrics
        print("jax" in sys.modules, sorted(k for k in sys.modules if k.startswith("sfm_danpipeline_tpu")))
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False []"


def test_pipeline_runs_on_the_card_unless_asked_for_the_cpu():
    """`SfMPipeline()` takes the CUDA card; with none present it raises
    rather than running on the CPU, which only `device="cpu"` selects."""
    import pytest
    import torch

    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline

    assert SfMPipeline(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert SfMPipeline().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            SfMPipeline()
