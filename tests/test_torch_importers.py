"""Every importer of the port against the JAX package's on the CPU: the
inputs ``tests/test_interfaces.py`` builds (COLMAP text, OpenMVG JSON and
cereal binary, VisualSFM NVM, Bundler, Metashape, BlocksExchange, Polycam,
MVSNet), and the same layouts with distorted cameras and images on disk,
which both packages undistort on import. The saved ``.mvs`` files are
byte-equal, and so are the undistorted images (the two JPEG and PNG
encoders write the same bytes here: PIL and OpenCV's libjpeg-turbo at
quality 95; the port's zlib PNG against OpenCV's is held by decoded pixels).
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu_torch.io import mvs as pmvs  # noqa: E402
from test_interfaces import _make_colmap_text_model, _make_sfm_data_bin  # noqa: E402

torch.set_num_threads(1)


def _image(path, w, h, seed):
    """A smooth colour image file (PNG or JPEG by extension) through cv2."""
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(seed)
    img = gaussian_filter(r.uniform(0, 255, (h, w, 3)), (1.5, 1.5, 0))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, np.clip(img, 0, 255).astype(np.uint8))


def _nvm(root, distorted):
    nvm = ["NVM_V3", "", "3"]
    for i in range(3):
        r = -2e-7 if distorted and i != 1 else 0
        nvm.append(f"im{i}.jpg 60 1 0 0 0 {0.5 * i} 0 0 {r} 0")
        if distorted:
            _image(os.path.join(root, f"im{i}.jpg"), 64, 48, i)
    nvm += ["", "3"]
    nvm.append("0 0 5 100 110 120 2 0 0 10 10 1 0 20 20")
    nvm.append("1 0 5 100 110 120 3 0 1 10 10 1 1 20 20 2 4 1 1")
    nvm.append("1 1 5 100 110 120 1 0 1 10 10")
    p = os.path.join(root, "model.nvm")
    with open(p, "w") as f:
        f.write("\n".join(nvm))
    return p


def _bundler(root, distorted):
    for i in range(3):
        _image(os.path.join(root, f"im{i}.jpg"), 64, 48, 10 + i)
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("im0.jpg\nim1.jpg\nim2.jpg\n")
    out = ["# Bundle file v0.3", "3 2"]
    for i in range(3):
        k = "-0.05 0.01" if distorted and i != 2 else "0 0"
        focal = 0 if i == 1 else 70
        out += [f"{focal} {k}", "1 0 0", "0 1 0", "0 0 1", f"{-0.4 * i} 0 0"]
    out += ["0 0 -5", "10 20 30", "2 0 0 0 0 2 0 0 0"]
    out += ["0.1 0 -5", "10 20 30", "3 0 0 0 0 1 0 0 0 2 1 1 1"]
    p = os.path.join(root, "bundle.out")
    with open(p, "w") as f:
        f.write("\n".join(out) + "\n")
    return p


def _metashape(root, distorted):
    dist = "<k1>-0.08</k1><k2>0.02</k2><p1>0.001</p1>" if distorted else ""
    xml = f"""<document><chunk>
      <sensors><sensor id="0" type="frame">
        <resolution width="64" height="48"/>
        <calibration type="frame" class="adjusted">
          <resolution width="64" height="48"/>
          <f>60</f><cx>1.5</cx><cy>-2.0</cy>{dist}
        </calibration></sensor></sensors>
      <transform><rotation>1 0 0 0 1 0 0 0 1</rotation>
        <translation>0.1 0 0</translation><scale>2</scale></transform>
      <cameras>
        <camera id="0" sensor_id="0" label="im0">
          <transform>1 0 0 0  0 1 0 0  0 0 1 0  0 0 0 1</transform>
        </camera>
        <camera id="1" sensor_id="0" label="im1">
          <transform>1 0 0 0.5  0 1 0 0  0 0 1 0  0 0 0 1</transform>
        </camera>
        <camera id="2" sensor_id="0" label="im2" enabled="false">
          <transform>1 0 0 0.9  0 1 0 0  0 0 1 0  0 0 0 1</transform>
        </camera>
      </cameras></chunk></document>"""
    for i in range(3):
        _image(os.path.join(root, f"im{i}.jpg"), 64, 48, 20 + i)
    p = os.path.join(root, "doc.xml")
    with open(p, "w") as f:
        f.write(xml)
    return p


def _blocks(root, distorted):
    photos = "\n".join(f"""
      <Photo><Id>{i}</Id><ImagePath>im{i}.png</ImagePath>
        <Pose>
          <Rotation><M_00>1</M_00><M_01>0</M_01><M_02>0</M_02>
                    <M_10>0</M_10><M_11>1</M_11><M_12>0</M_12>
                    <M_20>0</M_20><M_21>0</M_21><M_22>1</M_22></Rotation>
          <Center><x>{0.3 * i}</x><y>0</y><z>0</z></Center>
        </Pose></Photo>""" for i in range(3))
    dist = ("<Distortion><K1>-0.1</K1><K2>0.02</K2><P1>0.001</P1><P2>-0.002</P2>"
            "</Distortion>" if distorted else "")
    xml = f"""<?xml version="1.0"?>
    <BlocksExchange version="2.1">
     <Block><Name>b</Name><SRSId>0</SRSId>
      <Photogroups>
       <Photogroup>
        <Name>g0</Name>
        <CameraModelType>Perspective</CameraModelType>
        <ImageDimensions><Width>64</Width><Height>48</Height></ImageDimensions>
        <FocalLengthPixels>60</FocalLengthPixels>
        <PrincipalPoint><x>32.5</x><y>23</y></PrincipalPoint>
        {dist}
        {photos}
       </Photogroup>
      </Photogroups>
      <TiePoints>
       <TiePoint>
        <Position><x>0</x><y>0</y><z>5</z></Position>
        <Color><Red>0.5</Red><Green>0.25</Green><Blue>1.0</Blue></Color>
        <Measurement><PhotoId>0</PhotoId><x>1</x><y>2</y></Measurement>
        <Measurement><PhotoId>2</PhotoId><x>3</x><y>4</y></Measurement>
       </TiePoint>
      </TiePoints>
     </Block>
    </BlocksExchange>"""
    for i in range(3):
        _image(os.path.join(root, f"im{i}.png"), 64, 48, 30 + i)
    p = os.path.join(root, "block.xml")
    with open(p, "w") as f:
        f.write(xml)
    return p


def _openmvg_json(root, distorted):
    intr = {"polymorphic_name": "pinhole", "ptr_wrapper": {"data": {
        "width": 64, "height": 48, "focal_length": 60.0, "principal_point": [32, 24]}}}
    if distorted:
        intr = {"polymorphic_name": "pinhole_brown_t2", "ptr_wrapper": {"data": {
            "width": 64, "height": 48, "focal_length": 60.0, "principal_point": [32, 24],
            "disto_t2": [-0.1, 0.02, 0.003, 0.001, -0.002]}}}
    doc = {
        "root_path": os.path.join(root, "imgs"),
        "views": [{"key": i, "value": {"ptr_wrapper": {"data": {
            "id_view": i, "id_intrinsic": 0, "id_pose": i, "filename": f"im{i}.png"}}}}
            for i in range(3)],
        "intrinsics": [{"key": 0, "value": intr}],
        "extrinsics": [{"key": i, "value": {"rotation": np.eye(3).tolist(),
                                            "center": [0.4 * i, 0, 0]}} for i in range(3)],
        "structure": [{"key": k, "value": {"X": [0, 0, 5.0 + 0.01 * k], "rgb": [10, 20, 30],
                                           "observations": [{"key": 0}, {"key": 1}]}}
                      for k in range(10)],
    }
    for i in range(3):
        _image(os.path.join(root, "imgs", f"im{i}.png"), 64, 48, 40 + i)
    p = os.path.join(root, "sfm_data.json")
    with open(p, "w") as f:
        json.dump(doc, f)
    return p


def _openmvg_bin(root, distorted):
    p = os.path.join(root, "sfm_data.bin")
    _make_sfm_data_bin(p, distorted=distorted)
    return p


def _colmap(root, distorted):
    folder = os.path.join(root, "sparse")
    _make_colmap_text_model(folder)
    if distorted:
        with open(os.path.join(folder, "cameras.txt"), "w") as f:
            f.write("1 SIMPLE_RADIAL 64 48 60 32 24 -0.1\n")
        for i in range(3):
            _image(os.path.join(root, f"im{i}.jpg"), 64, 48, 50 + i)
    return folder


def _polycam(root, distorted):
    from PIL import Image

    kf = os.path.join(root, "keyframes")
    os.makedirs(os.path.join(kf, "corrected_cameras"))
    os.makedirs(os.path.join(kf, "images"))
    for i, ts in enumerate(("100", "200", "300")):
        cam = {"fx": 600.0, "fy": 610.0, "cx": 320.0, "cy": 240.0, "width": 640, "height": 480,
               "t_00": 1, "t_01": 0, "t_02": 0, "t_03": 0.3 * i,
               "t_10": 0, "t_11": 0.8, "t_12": -0.6, "t_13": 0,
               "t_20": 0, "t_21": 0.6, "t_22": 0.8, "t_23": 0.1}
        with open(os.path.join(kf, "corrected_cameras", f"{ts}.json"), "w") as f:
            json.dump(cam, f)
        if ts != "300":
            Image.new("RGB", (640, 480)).save(os.path.join(kf, "images", f"{ts}.jpg"))
    return root


def _mvsnet(root, distorted):
    from PIL import Image

    os.makedirs(os.path.join(root, "cams"))
    os.makedirs(os.path.join(root, "images"))
    cam_txt = ("extrinsic\n1 0 0 0\n0 1 0 {ty}\n0 0 1 0\n0 0 0 1\n\n"
               "intrinsic\n100 0 32\n0 100 24\n0 0 1\n\n{depth}\n")
    for i in range(3):
        depth = "2.5 0.01 192 4.42" if i == 0 else "1.0 0.1"
        with open(os.path.join(root, "cams", f"{i:08d}_cam.txt"), "w") as f:
            f.write(cam_txt.format(ty=0.1 * i, depth=depth))
        if i != 1:
            Image.new("L", (64, 48)).save(os.path.join(root, "images", f"{i:08d}.jpg"))
    with open(os.path.join(root, "pair.txt"), "w") as f:
        f.write("2\n0\n2 2 10.0 1 5.0\n2\n1 0 8.0\n")
    return root


def _import(which, pkg, path):
    """The interface ``pkg`` ("port" or "jax") imports from ``path``."""
    import importlib

    base = "openmvs_tpu_torch" if pkg == "port" else "openmvs_tpu"
    mod, fn = {"colmap": ("colmap", "import_colmap"), "openmvg_json": ("openmvg", "import_openmvg"),
               "openmvg_bin": ("openmvg", "import_openmvg"), "nvm": ("visualsfm", "import_nvm"),
               "bundler": ("visualsfm", "import_bundler"),
               "metashape": ("metashape", "import_metashape"),
               "blocks": ("metashape", "import_metashape"),
               "polycam": ("polycam", "import_polycam"),
               "mvsnet": ("mvsnet", "import_mvsnet")}[which]
    f = getattr(importlib.import_module(f"{base}.interfaces.{mod}"), fn)
    if which == "colmap":
        return f(path, os.path.dirname(path))
    return f(path)


BUILDERS = {"colmap": _colmap, "openmvg_json": _openmvg_json, "openmvg_bin": _openmvg_bin,
            "nvm": _nvm, "bundler": _bundler, "metashape": _metashape, "blocks": _blocks,
            "polycam": _polycam, "mvsnet": _mvsnet}
# the layouts with a distorted variant (sfm_data.bin's distorted intrinsic
# names images that do not exist: nothing to undistort, a warning each)
DISTORTED = ("blocks", "bundler", "colmap", "metashape", "nvm", "openmvg_bin", "openmvg_json")
CASES = ([(w, False) for w in sorted(BUILDERS)] + [(w, True) for w in DISTORTED])


def _undistorted_files(itf):
    return {m.name: open(m.name, "rb").read() for m in itf.images
            if "undistorted" in m.name and os.path.exists(m.name)}


@pytest.mark.parametrize("which,distorted", CASES,
                         ids=[f"{w}-{'distorted' if d else 'pinhole'}" for w, d in CASES])
def test_importer_saves_the_jax_bytes(tmp_path, which, distorted):
    root = str(tmp_path / which)
    os.makedirs(root)
    path = BUILDERS[which](root, distorted)
    port = _import(which, "port", path)
    port_files = _undistorted_files(port)
    jax = _import(which, "jax", path)
    jax_files = _undistorted_files(jax)
    pmvs.save(port, str(tmp_path / "port.mvs"))
    jmvs.save(jax, str(tmp_path / "jax.mvs"))
    assert (tmp_path / "port.mvs").read_bytes() == (tmp_path / "jax.mvs").read_bytes()
    assert len(port.images) >= 1
    if distorted:
        # both wrote the same paths; the JAX package's files replaced the port's
        assert sorted(port_files) == sorted(jax_files)
        assert bool(port_files) == (which != "openmvg_bin")
        for name, data in port_files.items():
            if name.endswith(".png"):
                a = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
                b = cv2.imdecode(np.frombuffer(jax_files[name], np.uint8),
                                 cv2.IMREAD_UNCHANGED)
                assert np.array_equal(a, b), name
            else:
                assert data == jax_files[name], name
