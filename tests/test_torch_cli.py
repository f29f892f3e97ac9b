"""The port's CLI (``python -m openmvs_tpu_torch``) on a scene from files,
against the JAX package's CLI on the same files, on the CPU.

The synthetic colored scene (3 views of 120x160) is written as the user
hands a scene over: JPEG images (PIL) and ``scene.mvs``
(``synthetic.write_scene_files``). ``densify`` runs through both CLIs with
the slice tests' reduced schedule (one sub-resolution level, 4 iterations,
one geometric pass); the port runs with ``--device cpu``. The final depth
maps agree on more than 98.5% of the pixels valid in both, pooled, and
their masks on more than 99% (the floor of tests/test_torch_densify.py,
from the JAX package's own agreement under a one-ulp change,
tests/_torch_parity_floor.py). Then ``mesh``, ``refine`` and ``texture``
run through the port's CLI on the CPU, and every file they write reads
back. Without a card the default ``--device cuda`` raises. ``view``, the
importers, ``transform``, ``eval`` and ``densify --split-max-points``
write the JAX CLI's files.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("PIL")

from _torch_helpers import SLICE_VIEWS, depth_agreement  # noqa: E402

from openmvs_tpu.__main__ import main as jax_main  # noqa: E402
from openmvs_tpu_torch.__main__ import main  # noqa: E402
from openmvs_tpu_torch.io import dmap  # noqa: E402
from openmvs_tpu_torch.synthetic import write_scene_files  # noqa: E402

torch.set_num_threads(1)

SLICE_ARGS = ["--sub-resolution-levels", "1", "--estimation-iters", "4",
              "--estimation-geometric-iters", "1"]


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """The scene files, and densify's outputs from both CLIs."""
    folder = tmp_path_factory.mktemp("cli")
    mvs, _, _, _ = write_scene_files(str(folder), SLICE_VIEWS, 160, 120)
    main(["densify", mvs, "-o", str(folder / "port_dense.mvs"), "--device", "cpu",
          "--dmaps-folder", str(folder / "port_dmaps")] + SLICE_ARGS)
    jax_main(["densify", mvs, "-o", str(folder / "jax_dense.mvs"),
              "--dmaps-folder", str(folder / "jax_dmaps")] + SLICE_ARGS)
    return folder, mvs


def test_cli_densify_matches_jax(dense):
    from openmvs_tpu.scene import Scene as JaxScene

    from openmvs_tpu_torch.scene import Scene

    folder, _ = dense
    maps = [[dmap.load(str(folder / f"{who}_dmaps" / f"depth{i:04d}.dmap")).depth
             for i in range(SLICE_VIEWS)] for who in ("port", "jax")]
    masks, pooled, per_view = depth_agreement(*maps)
    port = Scene.load(str(folder / "port_dense.mvs"))
    jax = JaxScene.load(str(folder / "jax_dense.mvs"))
    msg = (f"points {len(port.pointcloud)} vs {len(jax.pointcloud)}, mask agreement "
           f"{masks}, depth agreement {pooled} (per view {per_view})")
    assert min(masks) > 0.99, msg
    assert pooled > 0.985, msg
    assert abs(len(port.pointcloud) - len(jax.pointcloud)) <= 0.02 * len(jax.pointcloud), msg
    assert len(port.pointcloud) > 5000 and np.isfinite(port.pointcloud.points).all()
    # the saved scene keeps the cameras and image paths it was loaded with
    assert [im.path for im in port.images] == [im.path for im in jax.images]
    assert all(np.array_equal(a.camera.K, b.camera.K) for a, b in zip(port.images, jax.images))
    assert os.path.getsize(folder / "port_dense.ply") > 0


def test_cli_mesh_refine_texture_files_read_back(dense):
    from openmvs_tpu_torch.io import obj, ply, png

    folder, _ = dense
    scene = str(folder / "port_dense.mvs")
    main(["mesh", scene, "--decimate", "0.5", "-o", str(folder / "mesh.ply")])
    main(["refine", scene, "-m", str(folder / "mesh.ply"), "--scales", "1", "--iters", "4",
          "--device", "cpu", "-o", str(folder / "refined.ply")])
    main(["texture", scene, "-m", str(folder / "refined.ply"), "--device", "cpu",
          "-o", str(folder / "textured.obj")])
    mesh = ply.load(str(folder / "mesh.ply"))
    refined = ply.load(str(folder / "refined.ply"))
    assert len(mesh.faces) > 1000 and np.isfinite(mesh.vertices).all()
    assert len(refined.faces) > 1000 and np.isfinite(refined.vertices).all()
    assert not np.array_equal(refined.vertices[:len(mesh.vertices)], mesh.vertices)
    v, f, tc, tex = obj.load_mesh_obj(str(folder / "textured.obj"))
    assert len(f) == len(refined.faces) and tc.shape == (len(f), 3, 2)
    assert tex.ndim == 3 and tex.shape[2] == 3
    assert np.array_equal(png.to_rgb(png.read(str(folder / "textured.png"))), tex)


def test_cli_default_device_raises_without_a_card(dense):
    folder, mvs = dense
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for args in (["densify", mvs], ["refine", mvs, "-m", "x.ply"],
                 ["texture", mvs, "-m", "x.ply"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(args)


@pytest.mark.parametrize("args", [
    ["view", "{dense}", "-o", "{out}.html"],
    ["transform", "{dense}", "--matrix", "{matrix}", "-o", "{out}.mvs"],
    ["eval", "--dataset", "eth3d", "--scene", "{eth3d}", "--est", "{dense_ply}",
     "-o", "{out}.json"],
    ["import-nvm", "{inputs}/nvm/model.nvm", "-o", "{out}.mvs"],
    ["import-bundler", "{inputs}/bundler/bundle.out", "-o", "{out}.mvs"],
    ["import-metashape", "{inputs}/metashape/doc.xml", "-o", "{out}.mvs"],
    ["import-polycam", "{inputs}/polycam", "-o", "{out}.mvs"],
    ["import-mvsnet", "{inputs}/mvsnet", "-o", "{out}.mvs"],
    ["densify", "{dense}", "--split-max-points", "3000", "-o", "{out}/chunk.mvs"]])
def test_cli_unported_parts_raise(dense, tmp_path, capsys, args):
    """Each command that a slice ported after the first CLI (``view`` the
    last) runs in both CLIs on the same inputs and writes the same files
    and lines (the importers' inputs are tests/test_torch_importers.py's,
    distorted where the format has it)."""
    import test_torch_importers as imp
    from openmvs_tpu_torch.synthetic import write_eth3d_files

    folder, _ = dense
    inputs = tmp_path / "inputs"
    for name, build in (("nvm", imp._nvm), ("bundler", imp._bundler),
                        ("metashape", imp._metashape), ("polycam", imp._polycam),
                        ("mvsnet", imp._mvsnet)):
        os.makedirs(inputs / name)
        build(str(inputs / name), name != "polycam" and name != "mvsnet")
    np.savetxt(tmp_path / "m.txt", [[0.9, -0.1, 0.0, 0.3], [0.1, 0.9, 0.0, -0.2],
                                    [0.0, 0.0, 1.1, 0.5]])
    write_eth3d_files(str(tmp_path / "eth3d"), 2, 80, 60, gt_grid=60)
    fill = {"dense": str(folder / "port_dense.mvs"), "dense_ply": str(folder / "port_dense.ply"),
            "matrix": str(tmp_path / "m.txt"), "eth3d": str(tmp_path / "eth3d"),
            "inputs": str(inputs)}
    outputs = []
    # "p" and "j": output paths of the same length, so the files compare
    for who, run in (("p", main), ("j", jax_main)):
        os.makedirs(tmp_path / who)
        argv = [a.format(out=str(tmp_path / who / "out"), **fill) for a in args]
        if args[0] == "densify":
            os.makedirs(tmp_path / who / "out")
            argv += ["--device", "cpu"] if who == "p" else []
        run(argv)
        printed = capsys.readouterr().out.replace(str(tmp_path / who), "OUT")
        files = {}
        for root, _, names in os.walk(tmp_path / who):
            for n in names:
                with open(os.path.join(root, n), "rb") as f:
                    data = f.read()
                # paths written into the files differ by the output folder;
                # a viewer page holds no path, but its base64 may hold "/p/"
                if not n.endswith(".html"):
                    data = data.replace(f"/{who}/".encode(), b"/x/")
                files[os.path.relpath(os.path.join(root, n), tmp_path / who)] = data
        outputs.append((printed, files))
    assert outputs[0] == outputs[1]
    assert outputs[0][1], "no file written"


def test_cli_dump_prints_the_jax_summary(dense, capsys):
    folder, mvs = dense
    files = [mvs, str(folder / "port_dmaps" / "depth0000.dmap")]
    main(["dump"] + files)
    port = capsys.readouterr().out
    jax_main(["dump"] + files)
    assert port == capsys.readouterr().out and "3 images" in port


def _scripts():
    """``[project.scripts]`` of pyproject.toml as {name: (module, function)}."""
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {name: tuple(target.split(":")) for name, target in scripts.items()}


def test_console_entry_points_match_jax(monkeypatch):
    """Each ``omvs-*`` script of the JAX package has an ``omvs-torch-*``
    twin naming the same function of ``openmvs_tpu_torch.apps``, the two
    ``apps`` modules define the same entry points, and each pair hands its
    CLI the same argument list."""
    import importlib

    import openmvs_tpu.__main__ as jax_cli
    import openmvs_tpu_torch.__main__ as port_cli
    from openmvs_tpu import apps as jax_apps
    from openmvs_tpu.io import images as jax_images
    from openmvs_tpu_torch import apps
    from openmvs_tpu_torch.io import images

    scripts = _scripts()
    jax_scripts = {n: t for n, t in scripts.items() if t[0] == "openmvs_tpu.apps"}
    port_scripts = {n: t for n, t in scripts.items() if t[0] == "openmvs_tpu_torch.apps"}
    assert len(jax_scripts) == 6
    assert {n.replace("omvs-", "omvs-torch-", 1): f for n, (_, f) in jax_scripts.items()} \
        == {n: f for n, (_, f) in port_scripts.items()}

    def entry_points(mod):
        return sorted(n for n, v in vars(mod).items()
                      if callable(v) and not n.startswith("_") and v.__module__ == mod.__name__)

    assert entry_points(apps) == entry_points(jax_apps)
    monkeypatch.setattr("sys.argv", ["prog", "scene.mvs", "-o", "out.mvs"])
    for _, (mod, fn) in port_scripts.items():
        got = {}
        for cli, package in ((port_cli, apps), (jax_cli, jax_apps)):
            monkeypatch.setattr(cli, "main", lambda argv, c=cli: got.__setitem__(c, argv))
            getattr(importlib.import_module(package.__name__), fn)()
        assert got[port_cli] == got[jax_cli] and got[port_cli][1:] == ["scene.mvs", "-o", "out.mvs"]
    for w, h, m in ((640, 480, 320), (1000, 1500, 777), (7, 3, 5)):
        assert images.scale_for_max_dim(w, h, m) == jax_images.scale_for_max_dim(w, h, m)
