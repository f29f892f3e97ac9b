"""The mesh formats against the JAX package and PIL, on the CPU.

- PLY (``io/ply``): point clouds and meshes written by one package and read
  by the other, binary and ASCII, polygons fan-triangulated: arrays equal,
  and the two writers' bytes equal.
- OBJ (``io/obj``) with multi-page atlases and their MTL: written by one
  package and read by the other, vertices, faces, texcoords and the atlas
  pixels equal.
- PNG (``io/png``, which stands in for PIL in the OBJ codec): PIL decodes
  the port's gray, RGB and RGBA files to the same pixels, and the port
  decodes PIL's (gray, gray+alpha, RGB, RGBA, at several compression
  settings) and files that use each of the five row filters to the same
  pixels. Bytes may differ: the compression settings do.
- PFM (``io/images.save_pfm``/``load_pfm``) both ways.
"""

import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from openmvs_tpu.io import images as jimages  # noqa: E402
from openmvs_tpu.io import obj as jobj  # noqa: E402
from openmvs_tpu.io import ply as jply  # noqa: E402
from openmvs_tpu.scene import Mesh as JaxMesh  # noqa: E402
from openmvs_tpu.scene import PointCloud as JaxPointCloud  # noqa: E402
from openmvs_tpu_torch import convert  # noqa: E402
from openmvs_tpu_torch.io import images as pimages  # noqa: E402
from openmvs_tpu_torch.io import obj as pobj  # noqa: E402
from openmvs_tpu_torch.io import ply as pply  # noqa: E402
from openmvs_tpu_torch.io import png  # noqa: E402
from openmvs_tpu_torch.scene import Scene  # noqa: E402
from openmvs_tpu_torch.synthetic import height_field_mesh  # noqa: E402


def _cloud(n=500, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 5, n)
    return dict(points=rng.normal(size=(n, 3)).astype(np.float32),
                views=[rng.choice(8, c, replace=False).astype(np.uint32) for c in counts],
                weights=[rng.uniform(0, 1, c).astype(np.float32) for c in counts],
                normals=rng.normal(size=(n, 3)).astype(np.float32),
                colors=rng.integers(0, 256, (n, 3), dtype=np.uint8))


def _image(shape, seed=0):
    """A smooth ramp plus noise, so an adaptive PNG encoder picks varied
    row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = 128 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
    if len(shape) == 3:
        base = base[..., None] + 20 * np.arange(shape[2])
    return np.clip(base + rng.integers(0, 24, shape), 0, 255).astype(np.uint8)


def test_pointcloud_carries_both_ways():
    d = _cloud()
    pc = convert.pointcloud_from_numpy(**d)
    back = convert.pointcloud_to_numpy(pc)
    jpc = JaxPointCloud(**back)
    assert jpc.has_normals and jpc.has_colors and len(jpc) == len(d["points"])
    for k in ("points", "normals", "colors"):
        assert back[k].dtype == d[k].dtype and np.array_equal(back[k], d[k])
    for k in ("views", "weights"):
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(back[k], d[k]))


@pytest.mark.parametrize("extras", [False, True])
def test_point_cloud_ply_both_ways(tmp_path, extras):
    d = _cloud()
    kw = dict(normals=d["normals"], colors=d["colors"]) if extras else {}
    port_pc = convert.pointcloud_from_numpy(d["points"], d["views"], d["weights"], **kw)
    jax_pc = JaxPointCloud(points=d["points"], views=d["views"], weights=d["weights"],
                           **kw)
    port_pc.save_ply(str(tmp_path / "p.ply"))
    jax_pc.save_ply(str(tmp_path / "j.ply"))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for reader, path in ((jply.load, "p.ply"), (pply.load, "j.ply")):
        data = reader(str(tmp_path / path))
        assert np.array_equal(data.vertices, d["points"])
        v = data.elements["vertex"]
        if extras:
            assert np.array_equal(np.stack([v["nx"], v["ny"], v["nz"]], -1), d["normals"])
            assert np.array_equal(np.stack([v["red"], v["green"], v["blue"]], -1),
                                  d["colors"])
        else:
            assert set(v) == {"x", "y", "z"}


def test_mesh_ply_both_ways(tmp_path):
    g = height_field_mesh(30)
    scene = Scene()
    scene.mesh = convert.mesh_from_numpy(g.vertices, g.faces)
    scene.save_mesh(str(tmp_path / "p.ply"))
    JaxMesh(vertices=g.vertices, faces=g.faces).save_ply(str(tmp_path / "j.ply"))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    jd = jply.load(str(tmp_path / "p.ply"))
    assert np.array_equal(jd.vertices, g.vertices) and np.array_equal(jd.faces, g.faces)
    loaded = Scene()
    loaded.load_mesh(str(tmp_path / "j.ply"))
    assert loaded.mesh.vertices.dtype == np.float32 and loaded.mesh.faces.dtype == np.int32
    assert np.array_equal(loaded.mesh.vertices, g.vertices)
    assert np.array_equal(loaded.mesh.faces, g.faces)


@pytest.mark.parametrize("ext", [".PLY", ".gltf"])
def test_save_mesh_writes_ply_as_jax(tmp_path, ext):
    """Scene.save_mesh writes every extension but .obj and .glb as PLY, as
    the JAX package's does."""
    from openmvs_tpu.scene import Scene as JaxScene

    g = height_field_mesh(12)
    scene, jscene = Scene(), JaxScene()
    scene.mesh = convert.mesh_from_numpy(g.vertices, g.faces)
    jscene.mesh = JaxMesh(vertices=g.vertices, faces=g.faces)
    scene.save_mesh(str(tmp_path / f"p{ext}"))
    jscene.save_mesh(str(tmp_path / f"j{ext}"))
    assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    assert np.array_equal(jply.load(str(tmp_path / f"p{ext}")).faces, g.faces)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_polygon_ply_reads_as_jax(tmp_path, fmt):
    """A quad, a pentagon and triangles: both loaders fan-triangulate them
    alike."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(9, 3)).astype(np.float32)
    polys = [[0, 1, 2, 3], [3, 4, 5], [4, 5, 6, 7, 8], [1, 2, 8]]
    e = "<" if "little" in fmt else ">"
    head = ["ply", f"format {fmt} 1.0", "element vertex 9", "property float x",
            "property float y", "property float z", f"element face {len(polys)}",
            "property list uchar int vertex_indices", "end_header"]
    with open(tmp_path / "m.ply", "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if fmt == "ascii":
            f.write("".join(f"{a} {b} {c}\n" for a, b, c in v).encode())
            f.write("".join(f"{len(p)} {' '.join(map(str, p))}\n" for p in polys).encode())
        else:
            f.write(v.astype(e + "f4").tobytes())
            for p in polys:
                f.write(struct.pack(e + "B" + "i" * len(p), len(p), *p))
    a, b = pply.load(str(tmp_path / "m.ply")), jply.load(str(tmp_path / "m.ply"))
    assert np.array_equal(a.vertices, b.vertices) and np.array_equal(a.faces, b.faces)
    assert a.faces.shape == (2 + 1 + 3 + 1, 3)


def _textured_mesh(pages):
    rng = np.random.default_rng(pages)
    g = height_field_mesh(16)
    nf = len(g.faces)
    tc = rng.uniform(0, 1, (nf, 3, 2)).astype(np.float32)
    tex = [_image((40 + 8 * p, 64, 3), seed=p) for p in range(pages)]
    fp = rng.integers(0, pages, nf).astype(np.int32) if pages > 1 else None
    return g.vertices, g.faces, tc, tex, fp


@pytest.mark.parametrize("pages", [1, 3])
def test_obj_port_to_jax(tmp_path, pages):
    v, f, tc, tex, fp = _textured_mesh(pages)
    pobj.save_mesh_obj(str(tmp_path / "m.obj"), v, f, tc, tex[0],
                       textures=tex if pages > 1 else None, face_page=fp)
    for pg in range(pages):
        name = "m.png" if pg == 0 else f"m_{pg}.png"
        assert np.array_equal(np.asarray(Image.open(tmp_path / name)), tex[pg])
    jv, jf, jtc, jtex = jobj.load_mesh_obj(str(tmp_path / "m.obj"))
    order = np.argsort(fp, kind="stable") if fp is not None else np.arange(len(f))
    # the OBJ text holds 6 decimals
    assert np.abs(jv - v).max() <= 1e-6
    assert np.array_equal(jf, f[order])
    assert np.abs(jtc - tc[order]).max() <= 1e-6
    # the loader keeps the last page the MTL names
    assert np.array_equal(jtex, tex[-1])
    pv, pf, ptc, ptex = pobj.load_mesh_obj(str(tmp_path / "m.obj"))
    assert np.array_equal(pv, jv) and np.array_equal(pf, jf)
    assert np.array_equal(ptc, jtc) and np.array_equal(ptex, jtex)


@pytest.mark.parametrize("pages", [1, 3])
def test_obj_jax_to_port(tmp_path, pages):
    v, f, tc, tex, fp = _textured_mesh(pages)
    for d, save in (("j", jobj.save_mesh_obj), ("p", pobj.save_mesh_obj)):
        (tmp_path / d).mkdir()
        save(str(tmp_path / d / "m.obj"), v, f, tc, tex[0],
             textures=tex if pages > 1 else None, face_page=fp)
    for name in ("m.obj", "m.mtl"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()
    pv, pf, ptc, ptex = pobj.load_mesh_obj(str(tmp_path / "j" / "m.obj"))
    jv, jf, jtc, jtex = jobj.load_mesh_obj(str(tmp_path / "j" / "m.obj"))
    for a, b in ((pv, jv), (pf, jf), (ptc, jtc), (ptex, jtex)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ptex, tex[-1])


def test_obj_untextured_both_ways(tmp_path):
    g = height_field_mesh(10)
    pobj.save_mesh_obj(str(tmp_path / "p.obj"), g.vertices, g.faces)
    jv, jf, jtc, jtex = jobj.load_mesh_obj(str(tmp_path / "p.obj"))
    pv, pf, ptc, ptex = pobj.load_mesh_obj(str(tmp_path / "p.obj"))
    assert np.array_equal(pv, jv) and np.array_equal(pf, jf) and np.array_equal(pf, g.faces)
    assert ptc is None and jtc is None and ptex is None and jtex is None


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4), (1, 1, 3),
                                   (200, 300, 3)])
def test_png_port_file_decodes_in_pil(tmp_path, shape):
    img = _image(shape)
    png.write(str(tmp_path / "a.png"), img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    assert np.array_equal(png.read(str(tmp_path / "a.png")), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("save", [{}, {"optimize": True}, {"compress_level": 0}])
def test_png_pil_file_decodes_in_port(tmp_path, mode, save):
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    img = _image((45, 61, ch) if ch > 1 else (45, 61), seed=ch)
    Image.fromarray(img, mode).save(tmp_path / "a.png", **save)
    got = png.read(str(tmp_path / "a.png"))
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    rgb = np.asarray(Image.open(tmp_path / "a.png").convert("RGB"))
    assert np.array_equal(png.to_rgb(got), rgb)


def _encode_with_filters(img, filters):
    """A PNG whose row r uses filter ``filters[r % len(filters)]``, filtered
    here pixel by pixel as the PNG spec writes it."""
    h, w, c = img.shape
    x = img.astype(np.int64)
    out = bytearray()
    for r in range(h):
        ft = filters[r % len(filters)]
        out.append(ft)
        for i in range(w):
            for k in range(c):
                a = x[r, i - 1, k] if i else 0
                b = x[r - 1, i, k] if r else 0
                cc = x[r - 1, i - 1, k] if r and i else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                pred = (0, a, b, (a + b) // 2, paeth)[ft]
                out.append((x[r, i, k] - pred) % 256)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4),
                                     (4, 2, 3, 1)])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_row_filters(tmp_path, filters, ch):
    img = _image((13, 17, ch), seed=len(filters) + ch)
    (tmp_path / "f.png").write_bytes(_encode_with_filters(img, filters))
    want = img[..., 0] if ch == 1 else img
    assert np.array_equal(np.asarray(Image.open(tmp_path / "f.png")), want)
    assert np.array_equal(png.read(str(tmp_path / "f.png")), want)


@pytest.mark.parametrize("field,value", [("interlace", 1), ("depth", 16), ("ctype", 3)])
def test_png_unsupported_raises(tmp_path, field, value):
    """A header that promises interlacing, 16 bits or a palette the file
    does not hold (the data of an 8-bit RGB image, no PLTE) raises instead
    of decoding wrongly; the decoder reads all three when they are there
    (tests/test_torch_image_load.py)."""
    png.write(str(tmp_path / "a.png"), _image((8, 8, 3)))
    blob = bytearray((tmp_path / "a.png").read_bytes())
    hdr = dict(zip(("w", "h", "depth", "ctype", "comp", "filt", "interlace"),
                   struct.unpack(">IIBBBBB", blob[16:29])))
    hdr[field] = value
    blob[16:29] = struct.pack(">IIBBBBB", *hdr.values())
    (tmp_path / "b.png").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="image data|PLTE|row filter"):
        png.read(str(tmp_path / "b.png"))


def test_pfm_both_ways(tmp_path):
    d = np.random.default_rng(1).uniform(0, 9, (23, 31)).astype(np.float32)
    pimages.save_pfm(str(tmp_path / "p.pfm"), d)
    jimages.save_pfm(str(tmp_path / "j.pfm"), d)
    assert (tmp_path / "p.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    assert np.array_equal(jimages.load_pfm(str(tmp_path / "p.pfm")), d)
    assert np.array_equal(pimages.load_pfm(str(tmp_path / "j.pfm")), d)


def test_unported_mesh_formats_raise(tmp_path):
    """glTF and OBJ pages other than PNG, once unported, now cross between
    the packages: a .glb the port writes reads back in both packages to the
    same geometry, and an OBJ whose page is a JPEG loads it as the JAX
    package does (through PIL)."""
    from openmvs_tpu.io import gltf as jgltf

    scene = Scene()
    g = height_field_mesh(4)
    scene.mesh = convert.mesh_from_numpy(g.vertices, g.faces)
    scene.save_mesh(str(tmp_path / "m.glb"))
    back = Scene()
    back.load_mesh(str(tmp_path / "m.glb"))
    jv, jf = jgltf.load_mesh_glb(str(tmp_path / "m.glb"))
    assert np.array_equal(back.mesh.vertices, g.vertices) and np.array_equal(jv, g.vertices)
    assert np.array_equal(back.mesh.faces, g.faces) and np.array_equal(jf, g.faces)
    page = _image((6, 5, 3))
    Image.fromarray(page).save(tmp_path / "m.jpg", quality=95)
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd m.jpg\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    tex = pobj.load_mesh_obj(str(tmp_path / "m.obj"))[3]
    assert np.array_equal(tex, jobj.load_mesh_obj(str(tmp_path / "m.obj"))[3])