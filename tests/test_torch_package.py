"""The port's package boundary: what it imports, where it runs, and that a
CPU tensor takes a kernel's plain version without counting a launch."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import openmvs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(openmvs_tpu_torch.__path__,
                                               "openmvs_tpu_torch.")]
# the file-loading slice (scenes, images, importers, the CLI), the
# real-SfM-input slice (undistortion, the other importers, the geometry of
# the scene transforms, splitting, evaluation), the project archives,
# logging and safety hooks and viewers, the multi-device paths, the
# sweep runner, and the ordered segment sums of refine's iteration
need = {"openmvs_tpu_torch." + n for n in (
    "__main__", "apps", "tower", "interfaces", "interfaces.colmap",
    "interfaces.openmvg", "io.mvs", "io.images", "io.png", "io.gltf", "io.sml",
    "interfaces.undistort", "interfaces.visualsfm", "interfaces.metashape",
    "interfaces.polycam", "interfaces.mvsnet", "geometry.robust", "geometry.lm",
    "geometry.similarity", "utils.octree", "split", "eval", "datasets",
    "io.boost_archive", "utils.log", "utils.safety", "viewer", "viewer_web",
    "parallel", "parallel.mesh", "parallel.sharded", "parallel.sharded_filter",
    "ops.graphs", "ops.segment", "ops.sgm", "refine")}
for n in names:
    importlib.import_module(n)
bad = [k for k in ("jax", "cv2", "PIL", "openmvs_tpu") if k in sys.modules]
bad += [k for k in sys.modules if k.startswith(("jax.", "cv2.", "PIL.", "openmvs_tpu."))]
print(len(names), bad, sorted(need - set(names)))
sys.exit(1 if bad or len(names) < 64 or need - set(names) else 0)
"""


def test_port_imports_no_jax_cv2_or_reference_package():
    """Every module of the port, the meshing, mesh operations and mesh
    formats, the scene and image loaders, the project archives, the
    importers with the image undistortion, the transforms, splitting,
    evaluation, the viewers, the CLI, the multi-device paths, the sweep
    runner and the segment sums included,
    imports neither jax, OpenCV, PIL nor the JAX package (PIL
    only when a file other than PNG or SCI is read or written,
    tests/test_torch_image_load.py)."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_a_card():
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.utils import device

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve("cuda")
    scene, _, _ = build_gt_scene(n_views=2, W=48, H=32)
    with pytest.raises(RuntimeError, match="cuda"):
        densify.dense_reconstruction(scene, DenseOptions())


def test_scene_methods_default_to_the_card():
    """The Scene methods of the stages that run on a device default to the
    card and raise without one; meshing and cleaning are host code."""
    from openmvs_tpu_torch.synthetic import build_gt_scene, height_field_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    scene, _, _ = build_gt_scene(n_views=2, W=48, H=32, color=True)
    with pytest.raises(RuntimeError, match="cuda"):
        scene.dense_reconstruction()
    scene.mesh = height_field_mesh(8)
    with pytest.raises(RuntimeError, match="cuda"):
        scene.refine_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        scene.texture_mesh()


def _tiny_scorer_args(C=2, H=24, W=32):
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import patchmatch as tpm

    r = np.random.default_rng(0)
    opts = DenseOptions()
    K = np.array([[28.0, 0, W / 2], [0, 28.0, H / 2], [0, 0, 1]])
    Kinv = np.linalg.inv(K)
    offs = tpm.texel_offsets(opts)
    goff = np.concatenate([offs, np.zeros((len(offs), 1), np.float32)], -1) @ Kinv.T
    data = tpm.pack_pm_data(
        opts, r.uniform(0, 1, (H, W)), r.uniform(0, 1, (1, H, W)), [[H, W]],
        K[None], [[2.0, 0.0, 0.0]], np.zeros((1, H, W)), np.zeros((1, 3, 3)),
        np.zeros((1, 3)), np.zeros((1, 3, 3)), np.zeros((1, 3)),
        Kinv.T.astype(np.float32), goff, 2.0, 10.0, np.zeros((H, W)),
        np.ones((H, W), bool), device="cpu")
    depth = torch.full((C, H, W), 5.0)
    normal = torch.zeros(C, H, W, 3)
    normal[..., 2] = -1.0
    inv_nd = 1.0 / (tpm._dot3(normal, data.X0[None]) * depth)
    v = data.views
    return data, (v.image[0], v.size[0], v.Hl[0], v.Hm[0], depth, normal,
                  inv_nd, data.X0, data.goff, data.w, data.wtm, data.sum_w,
                  data.norm_sq0)


def test_cpu_tensor_takes_plain_path_without_a_launch():
    from openmvs_tpu_torch.ops import pm_kernel

    data, args = _tiny_scorer_args()
    pm_kernel.reset_launches()
    s = pm_kernel.score_view(*args, th_robust=1.2)
    s2, cons = pm_kernel.score_view_geom(
        *args[:4], data.views.Tr[0], data.views.Tn[0], data.views.depth[0],
        *args[4:8], data.uv, *args[8:], th_robust=1.2, nearest=True)
    v = data.views
    cons3 = pm_kernel.geom_term(v.depth[0], v.size[0], v.Tl[0], v.Tm[0],
                                v.Tr[0], v.Tn[0], args[4], data.X0, data.uv)
    s_v2 = pm_kernel.score_view_v2(*args, th_robust=1.2)
    assert all(n == 0 for n in pm_kernel.LAUNCHES.values())
    assert torch.equal(cons3, cons) and torch.equal(s_v2, s)
    plain, _ = pm_kernel.score_view_plain(*args, th_robust=1.2)
    assert torch.equal(s, plain)
    assert s.shape == cons.shape == (2, 24, 32) and torch.isfinite(s).all()
    # no neighbour depth: every candidate is geometrically inconsistent
    assert torch.equal(cons, torch.full_like(cons, 4.0))


def test_kernel_build_needs_the_cuda_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises a clear error (it never falls back)."""
    from openmvs_tpu_torch.ops import _build

    if _build.shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
