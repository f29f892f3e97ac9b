"""The port's ``.mvs`` codec (``openmvs_tpu_torch/io/mvs.py``) against the
JAX package's, on interfaces made with numpy from a seed: several
platforms with several cameras and poses each, normalised and pixel K,
view scores, ragged point views and weights, normals, colours, lines, the
transform and the OBB. Each package reads the other's file to equal
fields, and the two writers give equal bytes."""

import numpy as np
import pytest

pytest.importorskip("jax")

from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu_torch.io import mvs as pmvs  # noqa: E402


def _f32(x) -> float:
    """x as the float32 the stream stores."""
    return float(np.float32(x))


def _interface(mod, seed, n_points=300, lines=True):
    r = np.random.default_rng(seed)
    itf = mod.Interface()
    for p in range(3):
        plat = mod.Platform(name=f"platform{p}")
        for c in range(2):
            normalised = (p + c) % 2 == 0
            K = np.array([[r.uniform(0.7, 1.2), 0, r.uniform(0.4, 0.6)],
                          [0, r.uniform(0.7, 1.2), r.uniform(0.3, 0.5)], [0, 0, 1]])
            w, h = (0, 0) if normalised else (640 + 2 * c, 480 + p)
            if not normalised:
                K[:2] *= 640
            plat.cameras.append(mod.CameraRig(
                name=f"cam{p}{c}", band_name="rgb" if c else "", width=w, height=h,
                K=K, R=np.linalg.qr(r.normal(size=(3, 3)))[0], C=r.normal(size=3)))
        for _ in range(2 + p):
            plat.poses.append(mod.Pose(R=np.linalg.qr(r.normal(size=(3, 3)))[0],
                                       C=r.normal(size=3)))
        itf.platforms.append(plat)
    for i in range(7):
        p = i % 3
        meta = mod.ImageMeta(
            name=f"images/im{i}.jpg", mask_name=f"masks/im{i}.png" if i % 2 else "",
            platform_id=p, camera_id=i % 2, pose_id=i % (2 + p), id=i * 3,
            min_depth=_f32(r.uniform(1, 2)), avg_depth=_f32(r.uniform(2, 3)),
            max_depth=_f32(r.uniform(3, 4)))
        for j in range(i % 4):
            meta.view_scores.append(mod.ViewScore(
                int(r.integers(0, 21)), int(r.integers(0, 999)), *map(_f32, r.uniform(0, 1, 4))))
        itf.images.append(meta)
    itf.points = r.normal(size=(n_points, 3)).astype(np.float32)
    counts = r.integers(0, 6, n_points)
    itf.point_views = [np.sort(r.choice(21, k, replace=False)).astype(np.uint32) for k in counts]
    itf.point_confidences = [r.uniform(0, 1, k).astype(np.float32) for k in counts]
    itf.normals = r.normal(size=(n_points, 3)).astype(np.float32)
    itf.colors = r.integers(0, 256, (n_points, 3)).astype(np.uint8)
    if lines:
        for k in range(4):
            itf.lines.append((tuple(map(float, r.normal(size=3).astype(np.float32))),
                              tuple(map(float, r.normal(size=3).astype(np.float32))),
                              np.arange(k, dtype=np.uint32),
                              r.uniform(0, 1, k).astype(np.float32)))
        itf.line_normals = r.normal(size=(4, 3)).astype(np.float32)
        itf.line_colors = r.integers(0, 256, (4, 3)).astype(np.uint8)
    itf.transform = np.eye(4)
    itf.transform[:3] = r.normal(size=(3, 4))
    itf.obb_rot = np.linalg.qr(r.normal(size=(3, 3)))[0]
    itf.obb_min = -r.uniform(1, 2, 3)
    itf.obb_max = r.uniform(1, 2, 3)
    return itf


def _assert_equal(a, b):
    assert len(a.platforms) == len(b.platforms)
    for pa, pb in zip(a.platforms, b.platforms):
        assert pa.name == pb.name and len(pa.cameras) == len(pb.cameras)
        for ca, cb in zip(pa.cameras, pb.cameras):
            assert (ca.name, ca.band_name, ca.width, ca.height) == (
                cb.name, cb.band_name, cb.width, cb.height)
            for k in ("K", "R", "C"):
                assert np.array_equal(getattr(ca, k), getattr(cb, k))
        assert len(pa.poses) == len(pb.poses)
        for qa, qb in zip(pa.poses, pb.poses):
            assert np.array_equal(qa.R, qb.R) and np.array_equal(qa.C, qb.C)
    assert len(a.images) == len(b.images)
    for ia, ib in zip(a.images, b.images):
        for k in ("name", "mask_name", "platform_id", "camera_id", "pose_id", "id",
                  "min_depth", "avg_depth", "max_depth"):
            assert getattr(ia, k) == getattr(ib, k), k
        assert [vars(v) for v in ia.view_scores] == [vars(v) for v in ib.view_scores]
    assert np.array_equal(a.points, b.points)
    assert len(a.point_views) == len(b.point_views)
    for x, y in zip(a.point_views, b.point_views):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(a.point_confidences, b.point_confidences):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for k in ("normals", "colors", "line_normals", "line_colors", "transform",
              "obb_rot", "obb_min", "obb_max"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert len(a.lines) == len(b.lines)
    for la, lb in zip(a.lines, b.lines):
        assert la[0] == lb[0] and la[1] == lb[1]
        assert np.array_equal(la[2], lb[2]) and np.array_equal(la[3], lb[3])
    assert a.version == b.version


@pytest.mark.parametrize("seed,n_points,lines", [(0, 300, True), (1, 0, False), (2, 1, True)])
def test_mvs_both_ways_and_equal_bytes(tmp_path, seed, n_points, lines):
    jp, pp = str(tmp_path / "jax.mvs"), str(tmp_path / "port.mvs")
    jmvs.save(_interface(jmvs, seed, n_points, lines), jp)
    pmvs.save(_interface(pmvs, seed, n_points, lines), pp)
    assert (tmp_path / "jax.mvs").read_bytes() == (tmp_path / "port.mvs").read_bytes()
    _assert_equal(pmvs.load(jp), jmvs.load(jp))
    _assert_equal(jmvs.load(pp), pmvs.load(pp))
    _assert_equal(pmvs.load(pp), _interface(pmvs, seed, n_points, lines))


def test_mvs_older_version_and_errors(tmp_path):
    """A version-3 stream (no band names, masks, depths, view scores or OBB)
    reads the same in both packages; a newer version and a foreign magic
    raise."""
    blob = bytearray()
    blob += b"MVSI" + (3).to_bytes(4, "little") + bytes(4)
    blob += (1).to_bytes(8, "little") + (2).to_bytes(8, "little") + b"p0"
    blob += (1).to_bytes(8, "little") + (1).to_bytes(8, "little") + b"c"
    blob += (64).to_bytes(4, "little") + (48).to_bytes(4, "little")
    blob += np.arange(21, dtype=np.float64).tobytes()
    blob += (1).to_bytes(8, "little") + np.arange(12, dtype=np.float64).tobytes()
    blob += (1).to_bytes(8, "little") + (5).to_bytes(8, "little") + b"a.jpg"
    blob += bytes(12) + (9).to_bytes(4, "little")
    blob += (1).to_bytes(8, "little") + np.ones(3, np.float32).tobytes()
    blob += (1).to_bytes(8, "little") + (0).to_bytes(4, "little") + np.float32(0.5).tobytes()
    blob += (0).to_bytes(8, "little") * 2
    blob += (0).to_bytes(8, "little") * 3 + np.eye(4).tobytes()
    (tmp_path / "v3.mvs").write_bytes(bytes(blob))
    _assert_equal(pmvs.load(str(tmp_path / "v3.mvs")), jmvs.load(str(tmp_path / "v3.mvs")))
    blob[4:8] = (8).to_bytes(4, "little")
    (tmp_path / "v8.mvs").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="version"):
        pmvs.load(str(tmp_path / "v8.mvs"))
    (tmp_path / "x.mvs").write_bytes(b"MVS\x00" + bytes(16))
    with pytest.raises(ValueError, match="MVSI"):
        pmvs.load(str(tmp_path / "x.mvs"))
