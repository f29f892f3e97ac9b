"""The port's SfM importers and exporter (``openmvs_tpu_torch/interfaces/``)
against the JAX package's, on the CPU.

- COLMAP models, text and binary, with several cameras (pinhole models,
  and radial ones whose coefficients are 0): the port's import equals the
  JAX package's; the port's export writes the JAX package's bytes, and an
  export reads back to the same interface.
- OpenMVG ``sfm_data.json`` and ``sfm_data.bin``: import equal to the JAX
  package's.
- A distorted camera (nonzero coefficients): both packages undistort the
  images on import (the port's ``interfaces/undistort.py``, OpenCV's
  ``cv2.undistort`` rebuilt) and write the same files.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from openmvs_tpu.interfaces import colmap as jcolmap  # noqa: E402
from openmvs_tpu.interfaces import openmvg as jopenmvg  # noqa: E402
from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu_torch.interfaces import colmap, openmvg  # noqa: E402
from openmvs_tpu_torch.io import mvs as pmvs  # noqa: E402
from test_interfaces import _make_sfm_data_bin  # noqa: E402
from test_torch_mvs_io import _assert_equal  # noqa: E402

torch.set_num_threads(1)


def _model(folder, cameras, binary):
    """A COLMAP model with the given (model, params) cameras, 6 images over
    them with random poses, and 80 points, written by the JAX package's
    exporter's formats (text) or by hand (binary)."""
    import struct

    r = np.random.default_rng(len(cameras) + binary)
    os.makedirs(folder, exist_ok=True)
    imgs = []
    for i in range(6):
        q = r.normal(size=4)
        q /= np.linalg.norm(q)
        imgs.append((i + 1, q, r.normal(size=3), 1 + i % len(cameras), f"im{i}.jpg"))
    pts = [(k + 1, r.normal(size=3) + [0, 0, 5], r.integers(0, 256, 3),
            sorted(r.choice(6, 1 + k % 4, replace=False) + 1)) for k in range(80)]
    if not binary:
        with open(os.path.join(folder, "cameras.txt"), "w") as f:
            f.write("# cameras\n")
            for cid, (name, params) in enumerate(cameras, 1):
                f.write(f"{cid} {name} 640 480 " + " ".join(map(str, params)) + "\n")
        with open(os.path.join(folder, "images.txt"), "w") as f:
            f.write("# images\n")
            for iid, q, t, cid, name in imgs:
                f.write(f"{iid} {' '.join(map(str, q))} {' '.join(map(str, t))} {cid} {name}\n")
                f.write("1.0 2.0 -1\n" if iid % 2 else "\n")
        with open(os.path.join(folder, "points3D.txt"), "w") as f:
            f.write("# points\n")
            for pid, X, rgb, track in pts:
                tr = " ".join(f"{t} 0" for t in track)
                f.write(f"{pid} {X[0]} {X[1]} {X[2]} {rgb[0]} {rgb[1]} {rgb[2]} 0.5 {tr}\n")
        return
    with open(os.path.join(folder, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, (name, params) in enumerate(cameras, 1):
            f.write(struct.pack("<iiQQ", cid, jcolmap.NAME_TO_ID[name], 640, 480))
            f.write(np.asarray(params, np.float64).tobytes())
    with open(os.path.join(folder, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, q, t, cid, name in imgs:
            f.write(struct.pack("<i", iid) + q.tobytes() + t.tobytes())
            f.write(struct.pack("<i", cid) + name.encode() + b"\x00")
            f.write(struct.pack("<Q", 1) + struct.pack("<ddq", 1.0, 2.0, -1))
    with open(os.path.join(folder, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, X, rgb, track in pts:
            f.write(struct.pack("<Q", pid) + np.asarray(X, np.float64).tobytes())
            f.write(bytes(rgb.astype(np.uint8)) + struct.pack("<dQ", 0.5, len(track)))
            for t in track:
                f.write(struct.pack("<ii", t, 0))


_CAMERAS = [("PINHOLE", [600, 610, 320, 240]), ("SIMPLE_PINHOLE", [590, 321, 239]),
            ("SIMPLE_RADIAL", [580, 319, 241, 0.0]), ("OPENCV", [600, 600, 320, 240, 0, 0, 0, 0])]


@pytest.mark.parametrize("binary", [False, True])
def test_colmap_import_and_export_equal_jax(tmp_path, binary):
    folder = str(tmp_path / "sparse")
    _model(folder, _CAMERAS, binary)
    itf = colmap.import_colmap(folder, "images")
    _assert_equal(itf, jcolmap.import_colmap(folder, "images"))
    assert len(itf.images) == 6 and 0 < len(itf.points) <= 80
    # export both ways, text and binary, and read the port's back
    for out_binary in (False, True):
        po, jo = str(tmp_path / f"p{out_binary}"), str(tmp_path / f"j{out_binary}")
        colmap.export_colmap(itf, po, binary=out_binary)
        jcolmap.export_colmap(jcolmap.import_colmap(folder, "images"), jo, binary=out_binary)
        for name in sorted(os.listdir(jo)):
            with open(os.path.join(po, name), "rb") as a, open(os.path.join(jo, name), "rb") as b:
                assert a.read() == b.read(), name
        _assert_equal(colmap.import_colmap(po), jcolmap.import_colmap(po))


def test_colmap_quaternions_equal_jax():
    r = np.random.default_rng(7)
    for _ in range(50):
        q = r.normal(size=4)
        q /= np.linalg.norm(q)
        R = colmap.qvec_to_R(q)
        assert np.array_equal(R, jcolmap.qvec_to_R(q))
        assert np.array_equal(colmap.R_to_qvec(R), jcolmap.R_to_qvec(R))


@pytest.mark.parametrize("model,params", [("SIMPLE_RADIAL", [580, 319, 241, 0.05]),
                                          ("OPENCV", [600, 600, 320, 240, -0.1, 0.01, 0, 0])])
def test_colmap_distorted_model_raises(tmp_path, model, params):
    """A distorted model's images are undistorted on import, as in the JAX
    package: the same interface (image names pointing at the undistorted
    copies) and the same files (JPEG bytes equal)."""
    folder = str(tmp_path / "sparse")
    _model(folder, [("PINHOLE", [600, 610, 320, 240]), (model, params)], False)
    _write_images(str(tmp_path / "images"), 6)
    port = colmap.import_colmap(folder, str(tmp_path / "images"),
                                undistort_dir=str(tmp_path / "port_und"))
    jax = jcolmap.import_colmap(folder, str(tmp_path / "images"),
                                undistort_dir=str(tmp_path / "jax_und"))
    for itf, und in ((port, "port_und"), (jax, "jax_und")):
        for m in itf.images:
            m.name = m.name.replace(und, "und")
    _assert_equal(port, jax)
    moved = sorted(os.listdir(tmp_path / "port_und"))
    assert moved == sorted(os.listdir(tmp_path / "jax_und")) == ["im1.jpg", "im3.jpg", "im5.jpg"]
    for name in moved:
        assert ((tmp_path / "port_und" / name).read_bytes()
                == (tmp_path / "jax_und" / name).read_bytes())


def _write_images(folder, n, w=640, h=480):
    """n smooth colour JPEGs im0.jpg ... (quality 95, PIL)."""
    from PIL import Image
    from scipy.ndimage import gaussian_filter

    os.makedirs(folder, exist_ok=True)
    r = np.random.default_rng(n)
    for i in range(n):
        img = gaussian_filter(r.uniform(0, 255, (h, w, 3)), (2, 2, 0))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"im{i}.jpg"), quality=95)


def test_colmap_unsupported_model_imports_its_pinhole_part(tmp_path):
    """A model the undistortion does not cover imports as in the JAX
    package: its pinhole part, with a warning."""
    folder = str(tmp_path / "sparse")
    _model(folder, [("OPENCV_FISHEYE", [600, 600, 320, 240, 0.1, 0, 0, 0])], False)
    _assert_equal(colmap.import_colmap(folder), jcolmap.import_colmap(folder))


def _sfm_json(path, intrinsic, root="/imgs"):
    doc = {
        "root_path": root,
        "views": [{"key": i, "value": {"ptr_wrapper": {"data": {
            "id_view": i, "id_intrinsic": i % 2, "id_pose": i if i < 4 else 99,
            "filename": f"im{i}.jpg"}}}} for i in range(5)],
        "intrinsics": [
            {"key": 0, "value": {"polymorphic_name": "pinhole", "ptr_wrapper": {"data": {
                "width": 640, "height": 480, "focal_length": 600.0,
                "principal_point": [320, 240]}}}},
            {"key": 1, "value": intrinsic}],
        "extrinsics": [{"key": i, "value": {
            "rotation": np.linalg.qr(np.random.default_rng(i).normal(size=(3, 3)))[0].tolist(),
            "center": [0.4 * i, 0.1, 0]}} for i in range(4)],
        "structure": [{"key": k, "value": {
            "X": [0.01 * k, 0, 5.0], "rgb": [k, 20, 30],
            "observations": [{"key": v} for v in range(k % 5)]}} for k in range(30)],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def test_openmvg_json_and_bin_equal_jax(tmp_path):
    p = str(tmp_path / "sfm_data.json")
    _sfm_json(p, {"polymorphic_name": "pinhole_radial_k3", "ptr_wrapper": {"data": {
        "width": 800, "height": 600, "focal_length": 700.0, "principal_point": [400, 300],
        "disto_k3": [0.0, 0.0, 0.0]}}})
    for images in ("", "/elsewhere"):
        _assert_equal(openmvg.import_openmvg(p, images), jopenmvg.import_openmvg(p, images))
    b = str(tmp_path / "sfm_data.bin")
    _make_sfm_data_bin(b)
    itf = openmvg.import_openmvg(b)
    _assert_equal(itf, jopenmvg.import_openmvg(b))
    assert len(itf.images) == 3 and len(itf.points) == 5
    assert openmvg._load_sfm_data_bin(b) == jopenmvg._load_sfm_data_bin(b)


def test_openmvg_distorted_raises(tmp_path):
    """A distorted intrinsic imports as in the JAX package: from JSON with
    its images present (undistorted into the same files), and from the
    cereal binary whose images are missing (each skipped with a warning)."""
    p = str(tmp_path / "sfm_data.json")
    _sfm_json(p, {"polymorphic_name": "pinhole_radial_k1", "ptr_wrapper": {"data": {
        "width": 800, "height": 600, "focal_length": 700.0, "principal_point": [400, 300],
        "disto_k1": [-0.1]}}}, root=str(tmp_path / "imgs"))
    _write_images(str(tmp_path / "imgs"), 5, 800, 600)
    port = openmvg.import_openmvg(p, undistort_dir=str(tmp_path / "und"))
    port_files = {n: (tmp_path / "und" / n).read_bytes()
                  for n in sorted(os.listdir(tmp_path / "und"))}
    _assert_equal(port, jopenmvg.import_openmvg(p, undistort_dir=str(tmp_path / "und")))
    assert sorted(port_files) == ["im1.jpg", "im3.jpg"]
    for name, data in port_files.items():
        assert (tmp_path / "und" / name).read_bytes() == data
    b = str(tmp_path / "sfm_data.bin")
    _make_sfm_data_bin(b, distorted=True)
    _assert_equal(openmvg.import_openmvg(b), jopenmvg.import_openmvg(b))


def test_cli_imports_write_the_jax_files(tmp_path):
    """import-colmap, import-openmvg and export-colmap through both CLIs."""
    from openmvs_tpu.__main__ import main as jax_main

    from openmvs_tpu_torch.__main__ import main

    folder = str(tmp_path / "sparse")
    _model(folder, _CAMERAS[:2], False)
    p = str(tmp_path / "sfm_data.json")
    _sfm_json(p, {"polymorphic_name": "pinhole", "ptr_wrapper": {"data": {
        "width": 800, "height": 600, "focal_length": 700.0, "principal_point": [400, 300]}}})
    for name, args in (("colmap", ["import-colmap", folder, "-i", "imgs"]),
                       ("openmvg", ["import-openmvg", p])):
        main(args + ["-o", str(tmp_path / f"p_{name}.mvs")])
        jax_main(args + ["-o", str(tmp_path / f"j_{name}.mvs")])
        assert ((tmp_path / f"p_{name}.mvs").read_bytes()
                == (tmp_path / f"j_{name}.mvs").read_bytes())
    main(["export-colmap", str(tmp_path / "p_colmap.mvs"), "-o", str(tmp_path / "pe"),
          "--binary"])
    jax_main(["export-colmap", str(tmp_path / "p_colmap.mvs"), "-o", str(tmp_path / "je"),
              "--binary"])
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "pe" / name).read_bytes() == (tmp_path / "je" / name).read_bytes()
    _assert_equal(pmvs.load(str(tmp_path / "p_colmap.mvs")),
                  jmvs.load(str(tmp_path / "j_colmap.mvs")))
