"""Drift and isolation checks for the port.

The port carries copies of the reference's numpy-only modules (config,
calibration and image I/O, PLY / PCD I/O and the native binding, the PMVS
export, the visualizations, the float64 BA oracle, the stage timer and the
FLOPs models, the synthetic scene, the metrics) because
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
import pytest

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


# Copies that differ from their original only in the package they name.
EXACT_COPIES = ["io/ply.py", "utils/viz.py", "ba/reference.py"]


def _source(package, rel):
    with open(os.path.join(REPO, package, rel)) as f:
        return f.read()


@pytest.mark.parametrize("rel", EXACT_COPIES)
def test_numpy_module_is_a_copy(rel):
    want = _source("sfm_danpipeline_tpu", rel).replace("sfm_danpipeline_tpu", "sfm_danpipeline_torch")
    assert _source("sfm_danpipeline_torch", rel) == want


def _code_after_docstring(src):
    import ast

    tree = ast.parse(src)
    body = tree.body[1:] if ast.get_docstring(tree) is not None else tree.body
    return "\n".join(ast.unparse(node) for node in body)


def test_native_binding_is_a_copy_with_its_own_docstring():
    """io/native.py: the module docstring says where the library lives; the
    code is the reference's, and both load the repository's one
    native/libcloudio.so."""
    from sfm_danpipeline_tpu.io import native as j_native
    from sfm_danpipeline_torch.io import native as t_native

    want = _source("sfm_danpipeline_tpu", "io/native.py").replace("sfm_danpipeline_tpu", "sfm_danpipeline_torch")
    assert _code_after_docstring(_source("sfm_danpipeline_torch", "io/native.py")) == _code_after_docstring(want)
    assert t_native._LIB_PATH == j_native._LIB_PATH


def test_ply_pcd_and_native_io_equal(tmp_path):
    from sfm_danpipeline_tpu.io import native as j_native
    from sfm_danpipeline_tpu.io import ply as j_ply
    from sfm_danpipeline_torch.io import native as t_native
    from sfm_danpipeline_torch.io import ply as t_ply

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    for mod_w, name in ((j_ply, "j"), (t_ply, "t")):
        mod_w.write_ply(str(tmp_path / f"{name}.ply"), pts, cols)
        mod_w.write_pcd(str(tmp_path / f"{name}.pcd"), pts, cols)
    j_native.write_ply_fast(str(tmp_path / "jf.ply"), pts, cols)
    t_native.write_ply_fast(str(tmp_path / "tf.ply"), pts, cols)
    for a, b in (("j.ply", "t.ply"), ("j.pcd", "t.pcd"), ("jf.ply", "tf.ply")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes(), (a, b)
    # Each package reads what the other wrote.
    for got, want in zip(t_ply.read_ply(str(tmp_path / "j.ply")), j_ply.read_ply(str(tmp_path / "t.ply"))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_native.read_ply_fast(str(tmp_path / "jf.ply")), j_native.read_ply_fast(str(tmp_path / "tf.ply"))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_ply.read_pcd(str(tmp_path / "j.pcd")), j_ply.read_pcd(str(tmp_path / "t.pcd"))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_native.voxel_downsample_fast(pts, 0.5), j_native.voxel_downsample_fast(pts, 0.5)
    )
    np.testing.assert_array_equal(
        t_native.radius_neighbor_counts_fast(pts, 0.7), j_native.radius_neighbor_counts_fast(pts, 0.7)
    )


def test_pmvs_export_trees_equal(tmp_path):
    """The port's exporter imports PIL inside the function (the reference at
    module level); the trees they write are the same, byte for byte."""
    from sfm_danpipeline_tpu.io.pmvs_export import export_pmvs as j_export
    from sfm_danpipeline_torch.io.pmvs_export import export_pmvs as t_export

    sc = t_scene(n_views=3, height=48, width=64, ring_fraction=0.1, seed=1)
    for name, fn in (("j", j_export), ("t", t_export)):
        opts = fn(str(tmp_path / name), sc.images, sc.intrinsics, sc.R, sc.t, [0, 2])
        assert opts.endswith("options.txt")
    files = sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "j")
        for d, _, fs in os.walk(tmp_path / "j") for f in fs
    )
    assert len(files) == 5  # options.txt, 2 images, 2 projection files
    for rel in files:
        assert (tmp_path / "j" / rel).read_bytes() == (tmp_path / "t" / rel).read_bytes(), rel


def test_flops_models_equal_and_peak_is_the_h100s():
    from sfm_danpipeline_tpu.utils import flops as j_flops
    from sfm_danpipeline_torch.utils import flops as t_flops

    assert t_flops.sift_flops(480, 640) == j_flops.sift_flops(480, 640)
    assert t_flops.matching_flops(45, 2048, 512) == j_flops.matching_flops(45, 2048, 512)
    assert t_flops.H100_PEAK_F32 == 67.0e12
    assert not hasattr(t_flops, "TPU_V5E_PEAK_F32")
    assert t_flops.mfu(67.0e12, 1.0) == 1.0


def test_stage_timer_and_profiler_trace():
    from sfm_danpipeline_tpu.utils.profiling import StageTimer as JTimer
    from sfm_danpipeline_torch.utils.profiling import StageTimer

    for cls in (JTimer, StageTimer):
        t = cls()
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        assert t.counts == {"a": 2} and set(t.as_metrics()) == {"t_a"}


def test_broadcast_metrics_list_equal():
    """The metrics rank 0 broadcasts with the state: the port's module-level
    copy of the list the reference keeps inside run_sfm_multihost."""
    from sfm_danpipeline_tpu.parallel import distributed as j_dist
    from sfm_danpipeline_torch.parallel import distributed as t_dist

    lists = [
        c for c in j_dist.run_sfm_multihost.__code__.co_consts
        if isinstance(c, tuple) and "ba_rms_px" in c
    ]
    assert lists == [t_dist._BCAST_METRICS]


def test_cli_and_new_modules_load_no_jax():
    """A fresh interpreter imports the command line and every module added with it
    with neither JAX nor the reference package loaded."""
    code = textwrap.dedent("""\
        import importlib, sys
        for m in ("cli", "ops.akaze", "ops.orb", "ops.flow", "analysis.filtering",
                  "analysis.segmentation", "analysis.normals", "analysis.dendrometry",
                  "mvs.meshing", "utils.checkpoint", "utils.profiling", "utils.flops",
                  "utils.viz", "io.ply", "io.native", "io.pmvs_export", "ba.reference",
                  "ba.sharded", "parallel.matching", "parallel.distributed", "pipeline.guided"):
            importlib.import_module("sfm_danpipeline_torch." + m)
        print("jax" in sys.modules, sorted(k for k in sys.modules if k.startswith("sfm_danpipeline_tpu")))
        """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False []"


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
