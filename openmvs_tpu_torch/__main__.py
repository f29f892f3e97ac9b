"""Command-line pipeline stages of the port.

The JAX package's CLI (``openmvs_tpu/__main__.py``) with the same
subcommands, options and outputs, running the port's stages:

  python -m openmvs_tpu_torch densify     scene.mvs  [-o out.mvs] [options]
  python -m openmvs_tpu_torch mesh        scene_dense.mvs [-o mesh.ply]
  python -m openmvs_tpu_torch refine      scene.mvs -m mesh.ply [-o refined.ply]
  python -m openmvs_tpu_torch texture     scene.mvs -m mesh.ply [-o textured.obj]
  python -m openmvs_tpu_torch import-colmap  sparse/ [-i images/] -o scene.mvs
  python -m openmvs_tpu_torch import-openmvg sfm_data.json [-i images/] -o scene.mvs
  python -m openmvs_tpu_torch import-nvm     model.nvm [-i images/] -o scene.mvs
  python -m openmvs_tpu_torch import-bundler bundle.out [--list list.txt] -o scene.mvs
  python -m openmvs_tpu_torch import-metashape cameras.xml [-i images/] -o scene.mvs
  python -m openmvs_tpu_torch import-polycam capture/ -o scene.mvs
  python -m openmvs_tpu_torch import-mvsnet  root/ -o scene.mvs
  python -m openmvs_tpu_torch export-colmap  scene.mvs -o colmap_model/ [--binary]
  python -m openmvs_tpu_torch transform   scene.mvs [--matrix m.txt | --align-file ref.mvs
                                          | --max-resolution N | --compute-volume] -o out.mvs
  python -m openmvs_tpu_torch eval        --dataset eth3d|dtu --scene DIR (--est cloud.ply | --run)
  python -m openmvs_tpu_torch view        scene.mvs [-m mesh.ply] [-o scene.html] [--serve 8080]
  python -m openmvs_tpu_torch dump        scene.mvs depth0000.dmap ... [-o out/]

One addition: ``densify``, ``refine``, ``texture`` and ``eval`` take
``--device`` (default ``cuda``, which raises without a card; ``cpu`` runs
every kernel's plain version). Every DenseOptions/MeshOptions/... field is
settable via --<kebab-name>, as in the reference apps
(DensifyPointCloud.cpp:94-205). The importers undistort the images of a
distorted camera (``interfaces/undistort.py``). Every command that loads
a scene reads ``.mvs`` interface files and the reference's boost "MVS
project" archives alike (``Scene.load``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def _add_dataclass_args(ap: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            ap.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                            default=None)
        elif f.type in ("int", int):
            ap.add_argument(name, type=int, default=None)
        elif f.type in ("float", float):
            ap.add_argument(name, type=float, default=None)
        elif f.type in ("str", str):
            ap.add_argument(name, type=str, default=None)


def _build_opts(cls, args) -> object:
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(args, f.name, None)
        if v is not None:
            kw[f.name] = v
    return cls(**kw)


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the stage runs: cuda (default; raises without a "
                         "card) or cpu (the kernels' plain versions)")


def _log_peak(dev) -> None:
    """Log the peak device memory of this process's stage on the card."""
    if dev.type == "cuda":
        import torch

        from openmvs_tpu_torch.utils.log import get_logger

        get_logger("cli").info("peak device memory %d bytes",
                               torch.cuda.max_memory_allocated(dev))


def _load_mesh_ply(path: str):
    from openmvs_tpu_torch.io import ply as plyio
    from openmvs_tpu_torch.scene import Mesh

    pd = plyio.load(path)
    return Mesh(vertices=pd.vertices.astype(np.float32),
                faces=pd.faces.astype(np.int32))


def _project_image_points(scene, points_file: str):
    """ReconstructMesh --image-points-file (ReconstructMesh.cpp:275-330):
    cast each listed pixel of the named image onto the scene mesh and write
    the 3D intersections to `<points_file>_3D`.  The ray cast is realized
    by rendering the mesh depth for that view (native z-buffer) and
    unprojecting the sampled depth — identical up to rasterization
    resolution."""
    from openmvs_tpu_torch import native
    from openmvs_tpu_torch.texture import _project

    if not len(scene.mesh.faces):
        raise SystemExit("--image-points-file requires a scene with a mesh")
    img_name = None
    pts = []
    for line in open(points_file):
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        if img_name is None:
            img_name = t[0]
            continue
        if len(t) >= 2:
            pts.append((float(t[0]), float(t[1])))
    if img_name is None or not pts:
        raise SystemExit(f"no image name / points in {points_file}")
    img = None
    for im in scene.images:
        if os.path.basename(im.meta.name) == os.path.basename(img_name):
            img = im
            break
    if img is None:
        raise SystemExit(f"image named {img_name} not in the scene")
    cam = img.camera
    H, W = img.height, img.width
    if not (H and W):
        raise SystemExit(f"image {img_name} has no resolution metadata")
    proj = _project(cam, scene.mesh.vertices.astype(np.float64))
    fid, depth, _ = native.rasterize(proj, scene.mesh.faces, H, W,
                                     want_bary=False)
    depth = np.where(fid >= 0, depth, 0.0)
    base, ext = os.path.splitext(points_file)
    out_path = f"{base}_3D{ext}"
    n_out = 0
    with open(out_path, "w") as f:
        f.write(f"{img_name} {len(pts)}\n")
        for x, y in pts:
            xi, yi = int(round(x)), int(round(y))
            if 0 <= xi < W and 0 <= yi < H and depth[yi, xi] > 0:
                X = cam.unproject(np.array([[x, y]], np.float64),
                                  np.array([depth[yi, xi]], np.float64))[0]
                f.write(f"{X[0]:.7f} {X[1]:.7f} {X[2]:.7f}\n")
                n_out += 1
            else:
                f.write("-\n")
    return n_out, out_path


def _parser() -> argparse.ArgumentParser:
    from openmvs_tpu_torch.config import (DenseOptions, MeshOptions, RefineOptions,
                                          TextureOptions)

    ap = argparse.ArgumentParser(prog="openmvs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("densify", help="dense point-cloud reconstruction")
    p.add_argument("scene")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--dmaps-folder", default=None)
    p.add_argument("--tower-mode", type=int, default=4,
                   help="cylindrical-scene prior: 0 off, 1 replace cloud, "
                        "2 append, 3 select neighbors, 4 select+append, "
                        "negative to force; auto-detection no-ops on "
                        "non-tower scenes (DensifyPointCloud --tower-mode, "
                        "reference default 4)")
    p.add_argument("--estimate-roi", type=int, default=2,
                   help="0 off, 1 estimate unless already set, 2 estimate "
                        "and weight (Scene::EstimateROI; reference default 2)")
    p.add_argument("--crop-to-roi", action="store_true",
                   help="crop the fused cloud to the scene ROI "
                        "(DensifyPointCloud.cpp:273-432 behavior)")
    p.add_argument("--split-max-points", type=int, default=0,
                   help="split the scene into sub-scene chunk .mvs files of at "
                        "most this many points each and exit (Scene::Split)")
    p.add_argument("--filter-point-cloud", type=int, default=0,
                   help="<0: filter the dense cloud by ray visibility with "
                        "this threshold (Scene::PointCloudFilter)")
    p.add_argument("--fusion-mode", type=int, default=0,
                   help="0 estimate+fuse, 1 export depth maps only, "
                        "-1 export SGM disparity maps only, -2 fuse from "
                        "existing maps (DensifyPointCloud --fusion-mode)")
    p.add_argument("--view-neighbors-file", default="",
                   help="input list of views and their neighbors "
                        "(overrides automatic view selection)")
    p.add_argument("--output-view-neighbors-file", default="",
                   help="write the computed view-neighbor list and exit")
    p.add_argument("--mesh-file", default="",
                   help="mesh (.ply/.obj) to attach to the scene: seeds "
                        "estimation, or is rendered by "
                        "--export-depth-maps-name")
    p.add_argument("--export-roi-file", default="",
                   help="write the scene ROI (OBB text format) and exit")
    p.add_argument("--import-roi-file", default="",
                   help="read a ROI (OBB text format) into the scene before "
                        "densification")
    p.add_argument("--export-depth-maps-name", default="",
                   help="render the scene mesh into every view and save "
                        "depth maps to this base name (.dmap/.pfm/image), "
                        "then exit (Scene::ExportMeshToDepthMaps)")
    p.add_argument("--dense-config-file", default="",
                   help="reference-format OPTDENSE workspace file (SML text, "
                        "DensifyPointCloud --dense-config-file); explicit "
                        "CLI options override its values")
    _add_device(p)
    _add_dataclass_args(p, DenseOptions)

    p = sub.add_parser("mesh", help="graph-cut mesh reconstruction")
    p.add_argument("scene")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--split-max-faces", type=int, default=0,
                   help="if >0, also save the mesh as spatial chunks of at "
                        "most this many faces (ReconstructMesh mesh-split)")
    p.add_argument("--image-points-file", default="",
                   help="text file: first non-comment line an image name, "
                        "then 'x y' pixel coords; projects each onto the "
                        "scene mesh and writes the 3D hits next to the "
                        "input as *_3D (ReconstructMesh "
                        "--image-points-file)")
    p.add_argument("--chunk-max-points", type=int, default=0,
                   help="if >0, reconstruct in spatial chunks of at most "
                        "this many points each (overlap band + automatic "
                        "seam stitching) — bounds peak memory on very "
                        "large clouds")
    _add_dataclass_args(p, MeshOptions)

    p = sub.add_parser("refine", help="photometric mesh refinement")
    p.add_argument("scene")
    p.add_argument("-m", "--mesh", required=True)
    p.add_argument("-o", "--output", default=None)
    _add_device(p)
    _add_dataclass_args(p, RefineOptions)

    p = sub.add_parser("texture", help="mesh texturing")
    p.add_argument("scene")
    p.add_argument("-m", "--mesh", required=True)
    p.add_argument("-o", "--output", default=None)
    _add_device(p)
    _add_dataclass_args(p, TextureOptions)

    p = sub.add_parser("view", help="export an interactive WebGL viewer page")
    p.add_argument("scene", help=".mvs/.ply/.obj scene")
    p.add_argument("-m", "--mesh", default="", help="extra mesh ply/obj to show")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--serve", type=int, default=0, help="serve on this port")
    p.add_argument("--max-points", type=int, default=1_500_000)

    p = sub.add_parser("transform", help="transform/align a scene "
                                         "(TransformScene role)")
    p.add_argument("scene")
    p.add_argument("--matrix", default="", help="text file with 12 or 16 "
                                                "numbers (row-major 3x4/4x4)")
    p.add_argument("--align-file", default="",
                   help="scene to which this scene's cameras are aligned "
                        "(Scene::AlignTo similarity)")
    p.add_argument("--transfer-texture-file", default="",
                   help="mesh (.ply/.obj) that receives the scene mesh's "
                        "texture; written next to it as *_textured.obj")
    p.add_argument("--mesh-file", default="",
                   help="mesh to attach to the scene before transforming")
    p.add_argument("--compute-volume", action="store_true",
                   help="compute the (ground-leveled) mesh volume "
                        "(TransformScene --compute-volume)")
    p.add_argument("--plane-threshold", type=float, default=20.0,
                   help="ground-plane RANSAC threshold (0 auto, <0 skip "
                        "leveling and assume watertight)")
    p.add_argument("--sample-mesh", type=float, default=-100000,
                   help="mesh sampling for plane estimation (<0 point count)")
    p.add_argument("--up-axis", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--max-resolution", type=int, default=0,
                   help="rescale scene images to fit this resolution "
                        "(Scene::ScaleImages); resized files are written "
                        "next to the output scene")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("import-colmap")
    p.add_argument("sparse")
    p.add_argument("-i", "--images", default="")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("export-colmap")
    p.add_argument("scene")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--binary", action="store_true",
                   help="write the COLMAP .bin model instead of .txt")

    p = sub.add_parser("import-mvsnet")
    p.add_argument("root")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("import-openmvg")
    p.add_argument("sfm_data")
    p.add_argument("-i", "--images", default="")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("import-nvm")
    p.add_argument("nvm")
    p.add_argument("-i", "--images", default="")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("import-bundler")
    p.add_argument("out_file", help="bundle.out")
    p.add_argument("--list", dest="list_file", default="", help="image list.txt")
    p.add_argument("-i", "--images", default="")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("import-metashape")
    p.add_argument("xml")
    p.add_argument("-i", "--images", default="")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("import-polycam")
    p.add_argument("root")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser(
        "eval", help="evaluate a reconstruction against dataset ground truth "
        "(ETH3D F1 / DTU acc-comp protocols, datasets.py)")
    p.add_argument("--dataset", choices=("eth3d", "dtu"), required=True)
    p.add_argument("--scene", required=True,
                   help="ETH3D scene folder, or the DTU 'MVS Data' root")
    p.add_argument("--est", default="", help="reconstruction PLY to score")
    p.add_argument("--run", action="store_true",
                   help="densify first and score the fused cloud")
    p.add_argument("--scan", type=int, default=0, help="DTU scan number")
    p.add_argument("--lighting", default="max", help="DTU lighting tag")
    p.add_argument("--sparse-dir", default="",
                   help="COLMAP model supplying DTU seed points")
    p.add_argument("--max-points", type=int, default=500_000)
    p.add_argument("-o", "--output", default="", help="write results JSON")
    _add_device(p)

    p = sub.add_parser(
        "dump", help="inspect .mvs / .dmap / .dimap files "
        "(scripts/python/MvsReadMVS.py + MvsReadDMAP.py roles)")
    p.add_argument("inputs", nargs="+",
                   help=".mvs archive, .dmap depth map, or .dimap disparity")
    p.add_argument("-o", "--output",
                   help=".mvs: write the scene as json; .dmap: write "
                        "depth/normal/confidence visualizations into this folder")

    return ap


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args = _parser().parse_args(argv)

    from openmvs_tpu_torch.config import (DenseOptions, MeshOptions, RefineOptions,
                                          TextureOptions)
    from openmvs_tpu_torch.io import mvs as mvsio
    from openmvs_tpu_torch.scene import Scene
    from openmvs_tpu_torch.utils import device as devmod

    if args.cmd == "densify":
        from openmvs_tpu_torch.densify import dense_reconstruction

        dev = devmod.resolve(args.device)
        scene = Scene.load(args.scene)
        opts = _build_opts(DenseOptions, args)
        if args.dense_config_file:
            from openmvs_tpu_torch.io.sml import dense_options_from_sml

            # SML first, explicit CLI flags on top (reference order:
            # oConfig.Load then program_options update, app:238-255)
            base = dense_options_from_sml(args.dense_config_file)
            cli_kw = {f.name: getattr(args, f.name)
                      for f in dataclasses.fields(DenseOptions)
                      if getattr(args, f.name, None) is not None}
            opts = base.replace(**cli_kw)
        if args.tower_mode != 0:
            from openmvs_tpu_torch.tower import init_tower_scene

            init_tower_scene(scene, args.tower_mode, opts)
        if args.import_roi_file:
            scene.load_roi(args.import_roi_file)
        elif args.estimate_roi > 0 and (args.estimate_roi > 1
                                        or not scene.is_bounded()):
            scene.estimate_roi(mode=args.estimate_roi)
        if args.export_roi_file:
            if not scene.is_bounded():
                print("error: scene has no ROI to export")
                return
            scene.save_roi(args.export_roi_file)
            print(f"ROI -> {args.export_roi_file}")
            return
        if args.mesh_file:
            scene.mesh = _load_mesh_ply(args.mesh_file)
        if args.export_depth_maps_name:
            from openmvs_tpu_torch.densify import export_mesh_to_depth_maps

            n = export_mesh_to_depth_maps(scene, args.export_depth_maps_name,
                                          opts)
            print(f"mesh rendered into {n} depth maps "
                  f"-> {args.export_depth_maps_name}")
            return
        if args.split_max_points > 0:
            from openmvs_tpu_torch.split import export_chunks, split_scene

            chunks = split_scene(scene, max_points=args.split_max_points)
            folder = os.path.dirname(os.path.abspath(
                args.output or args.scene)) or "."
            stem = os.path.splitext(os.path.basename(
                args.output or args.scene))[0]
            paths = export_chunks(scene, chunks, folder, prefix=stem)
            for cp in paths:
                print(f"  chunk -> {cp}")
            print(f"scene split into {len(paths)} sub-scenes")
            return
        if args.view_neighbors_file:
            scene.load_view_neighbors(args.view_neighbors_file)
        if args.output_view_neighbors_file:
            from openmvs_tpu_torch.view_selection import select_views_for_scene

            for img in scene.images:
                if img.gray is None:
                    img.load()
            select_views_for_scene(scene, opts, respect_existing=True)
            scene.save_view_neighbors(args.output_view_neighbors_file)
            print(f"view neighbors -> {args.output_view_neighbors_file}")
            return
        dmaps = args.dmaps_folder
        if abs(args.fusion_mode) in (1, 2) and not dmaps:
            # -2 (fuse FROM existing maps) needs the same default folder the
            # export modes write to, or it would silently re-estimate all
            dmaps = (args.output or args.scene).replace(".mvs", "_dmaps")
        pc = dense_reconstruction(scene, opts, save_dmaps_to=dmaps,
                                  fusion_mode=args.fusion_mode,
                                  respect_neighbors=bool(args.view_neighbors_file),
                                  device=dev)
        _log_peak(dev)
        if abs(args.fusion_mode) == 1:
            print(f"fusion-mode {args.fusion_mode}: maps exported to {dmaps}")
            return
        scene.pointcloud = pc
        if args.crop_to_roi and scene.is_bounded():
            removed = scene.crop_to_roi()
            print(f"ROI crop: removed {removed} points")
        if args.filter_point_cloud < 0:
            removed = scene.point_cloud_filter(args.filter_point_cloud)
            print(f"visibility filter: removed {removed} points")
        pc = scene.pointcloud
        out = args.output or args.scene.replace(".mvs", "_dense.mvs")
        scene.save(out)
        pc.save_ply(out.replace(".mvs", ".ply"))
        print(f"dense cloud: {len(pc)} points -> {out}")

    elif args.cmd == "mesh":
        from openmvs_tpu_torch import mesh_ops
        from openmvs_tpu_torch.reconstruct import reconstruct_mesh

        scene = Scene.load(args.scene)
        opts = _build_opts(MeshOptions, args)
        if args.image_points_file:
            n_out, out_path = _project_image_points(
                scene, args.image_points_file)
            print(f"{n_out} image points projected on the mesh -> {out_path}")
            return
        if args.chunk_max_points > 0:
            from openmvs_tpu_torch.reconstruct import reconstruct_mesh_chunked

            mesh = reconstruct_mesh_chunked(
                scene, opts, max_points=args.chunk_max_points)
        else:
            mesh = reconstruct_mesh(scene, opts)
        if opts.decimate < 1.0 or opts.remove_spurious > 0:
            mesh = mesh_ops.clean_mesh(
                mesh, decimate=opts.decimate,
                remove_spurious_percent=opts.remove_spurious,
                do_remove_spikes=opts.remove_spikes,
                close_holes_size=opts.close_holes,
                smooth_iters=opts.smooth_mesh,
            )
        out = args.output or args.scene.replace(".mvs", "_mesh.ply")
        mesh.save_ply(out)
        print(f"mesh: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces -> {out}")
        if args.split_max_faces > 0:
            base = out[:-4] if out.endswith(".ply") else out
            for ci, sub_mesh in enumerate(mesh_ops.split_mesh(mesh, args.split_max_faces)):
                cp = f"{base}_chunk{ci:03d}.ply"
                sub_mesh.save_ply(cp)
                print(f"  chunk {ci}: {len(sub_mesh.faces)} faces -> {cp}")

    elif args.cmd == "refine":
        from openmvs_tpu_torch.refine import refine_mesh

        dev = devmod.resolve(args.device)
        scene = Scene.load(args.scene)
        mesh = _load_mesh_ply(args.mesh)
        opts = _build_opts(RefineOptions, args)
        out_mesh = refine_mesh(scene, mesh, opts, device=dev)
        _log_peak(dev)
        out = args.output or args.mesh.replace(".ply", "_refine.ply")
        out_mesh.save_ply(out)
        print(f"refined mesh -> {out}")

    elif args.cmd == "texture":
        from openmvs_tpu_torch.io.obj import save_mesh_obj
        from openmvs_tpu_torch.texture import texture_mesh

        dev = devmod.resolve(args.device)
        scene = Scene.load(args.scene)
        mesh = _load_mesh_ply(args.mesh)
        opts = _build_opts(TextureOptions, args)
        tex = texture_mesh(scene, mesh, opts, device=dev)
        _log_peak(dev)
        out = args.output or args.mesh.replace(".ply", "_texture.obj")
        save_mesh_obj(out, tex.vertices, tex.faces, tex.face_tex_coords,
                      tex.texture, textures=tex.textures, face_page=tex.face_page)
        print(f"textured mesh -> {out}")

    elif args.cmd == "transform":
        scene = Scene.load(args.scene)
        if args.mesh_file:
            scene.mesh = _load_mesh_ply(args.mesh_file)
        if args.transfer_texture_file:
            from openmvs_tpu_torch import mesh_ops
            from openmvs_tpu_torch.io.obj import load_mesh_obj, save_mesh_obj
            from openmvs_tpu_torch.scene import Mesh

            if args.transfer_texture_file.lower().endswith(".obj"):
                ov, of = load_mesh_obj(args.transfer_texture_file)[:2]
                dst = Mesh(vertices=np.asarray(ov, np.float32),
                           faces=np.asarray(of, np.int32))
            else:
                dst = _load_mesh_ply(args.transfer_texture_file)
            out_mesh = mesh_ops.transfer_texture(scene.mesh, dst)
            base = args.transfer_texture_file.rsplit(".", 1)[0]
            save_mesh_obj(
                f"{base}_textured.obj", out_mesh.vertices, out_mesh.faces,
                face_tex_coords=out_mesh.face_tex_coords,
                texture=out_mesh.texture, textures=out_mesh.textures,
                face_page=out_mesh.face_page)
            print(f"texture transferred -> {base}_textured.obj")
            return
        if args.align_file:
            ref = Scene.load(args.align_file)
            T = scene.align_to(ref)
            print(f"aligned to {args.align_file}:\n{np.round(T, 6)}")
        if args.matrix:
            vals = [float(x) for x in open(args.matrix).read().split()]
            T = np.eye(4)
            T[: len(vals) // 4, :] = np.array(vals).reshape(-1, 4)
            scene.apply_transform(T)
        if args.max_resolution > 0:
            folder = os.path.join(
                os.path.dirname(os.path.abspath(args.output)), "images_scaled")
            n = scene.scale_images(max_resolution=args.max_resolution,
                                   folder=folder)
            print(f"rescaled {n} images -> {folder}")
        if args.compute_volume:
            if len(scene.mesh.faces) == 0:
                raise SystemExit("error: --compute-volume needs a mesh "
                                 "(use --mesh-file)")
            vol = scene.compute_leveled_volume(args.plane_threshold,
                                               args.sample_mesh, args.up_axis)
            print(f"mesh volume: {vol:g}")
        scene.save(args.output)
        print(f"transformed scene -> {args.output}")

    elif args.cmd == "import-colmap":
        from openmvs_tpu_torch.interfaces.colmap import import_colmap

        itf = import_colmap(args.sparse, args.images)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "export-colmap":
        from openmvs_tpu_torch.interfaces.colmap import export_colmap

        itf = mvsio.load(args.scene)
        export_colmap(itf, args.output, binary=args.binary)
        print(f"exported -> {args.output}")

    elif args.cmd == "import-mvsnet":
        from openmvs_tpu_torch.interfaces.mvsnet import import_mvsnet

        itf = import_mvsnet(args.root)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "view":
        from openmvs_tpu_torch.viewer_web import export_html, serve

        scene = Scene.load(args.scene)
        if args.mesh:
            ms = Scene.load(args.mesh)
            scene.mesh = ms.mesh
        out = args.output or (os.path.splitext(args.scene)[0] + "_viewer.html")
        export_html(scene, out, max_points=args.max_points)
        print(f"viewer page -> {out}")
        if args.serve:
            serve(out, args.serve)

    elif args.cmd == "import-openmvg":
        from openmvs_tpu_torch.interfaces.openmvg import import_openmvg

        itf = import_openmvg(args.sfm_data, args.images)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "import-nvm":
        from openmvs_tpu_torch.interfaces.visualsfm import import_nvm

        itf = import_nvm(args.nvm, args.images)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "import-bundler":
        from openmvs_tpu_torch.interfaces.visualsfm import import_bundler

        itf = import_bundler(args.out_file, args.list_file, args.images)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "import-metashape":
        from openmvs_tpu_torch.interfaces.metashape import import_metashape

        itf = import_metashape(args.xml, args.images)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "import-polycam":
        from openmvs_tpu_torch.interfaces.polycam import import_polycam

        itf = import_polycam(args.root)
        mvsio.save(itf, args.output)
        print(f"imported {len(itf.images)} views -> {args.output}")

    elif args.cmd == "eval":
        import json as _json

        from openmvs_tpu_torch import datasets

        res = datasets.run_eval(
            args.dataset, args.scene, est_ply=args.est, scan=args.scan,
            lighting=args.lighting, sparse_dir=args.sparse_dir,
            run_pipeline=args.run, out_json=args.output,
            max_points=args.max_points, device=args.device)
        print(_json.dumps(res, indent=1))

    elif args.cmd == "dump":
        _dump_files(args.inputs, args.output)


def _dump_files(inputs, output=None):
    """Inspect interchange artifacts (MvsReadMVS.py / MvsReadDMAP.py roles):
    .mvs -> camera summary lines + optional full-json export; .dmap/.dimap ->
    stats line. The JAX package's .dmap visualizations (``-o`` with a
    .dmap) are OpenCV colour maps and not ported."""
    import json

    from openmvs_tpu_torch.io import dmap as dmapio
    from openmvs_tpu_torch.io import mvs as mvsio

    for path in inputs:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".mvs":
            itf = mvsio.load(path)
            for p_i, plat in enumerate(itf.platforms):
                for c_i, cam in enumerate(plat.cameras):
                    m = max(cam.width, cam.height) or 1
                    print(f"Camera model loaded: platform {p_i}; camera {c_i};"
                          f" f {cam.K[0][0]/m:.3f}x{cam.K[1][1]/m:.3f};"
                          f" poses {len(plat.poses)}")
            print(f"{path}: {len(itf.images)} images, "
                  f"{len(itf.points)} vertices, "
                  f"{len(itf.normals)} normals, "
                  f"{len(itf.colors)} colors")
            if output:
                def _tolist(o):
                    if isinstance(o, np.ndarray):
                        return o.tolist()
                    raise TypeError(type(o).__name__)
                doc = {
                    "platforms": [{
                        "name": plat.name,
                        "cameras": [{
                            "width": cam.width, "height": cam.height,
                            "K": np.asarray(cam.K).tolist(),
                            "R": np.asarray(cam.R).tolist(),
                            "C": np.asarray(cam.C).tolist(),
                        } for cam in plat.cameras],
                        "poses": [{"R": np.asarray(p.R).tolist(),
                                   "C": np.asarray(p.C).tolist()}
                                  for p in plat.poses],
                    } for plat in itf.platforms],
                    "images": [{
                        "name": im.name, "platform_id": im.platform_id,
                        "camera_id": im.camera_id, "pose_id": im.pose_id,
                        "id": im.id,
                    } for im in itf.images],
                    "n_vertices": len(itf.points),
                }
                os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
                with open(output, "w") as f:
                    json.dump(doc, f, indent=1, default=_tolist)
                print(f"scene json -> {output}")
        elif ext in (".dmap", ".dimap"):
            if ext == ".dimap":
                from openmvs_tpu_torch.io import dimap as dimapio

                dd = dimapio.load(path)
                disp = np.asarray(dd.disparity)
                valid = np.isfinite(disp) & (disp != 0)
                print(f"{path}: disparity {disp.shape}, "
                      f"valid {valid.mean():.1%}")
                continue
            dd = dmapio.load(path)
            d = np.asarray(dd.depth)
            valid = d > 0
            print(f"{path}: {dd.file_name} depth {d.shape} "
                  f"range [{dd.depth_min:.3f}, {dd.depth_max:.3f}] "
                  f"valid {valid.mean():.1%}"
                  f"{' +normal' if dd.normal is not None else ''}"
                  f"{' +conf' if dd.conf is not None else ''}")
            if output:
                from openmvs_tpu_torch.utils import log as _log

                os.makedirs(output, exist_ok=True)
                vid = int(dd.view_ids[0]) if len(dd.view_ids) else 0
                old = os.environ.get("OMVS_VERBOSE")
                os.environ["OMVS_VERBOSE"] = "3"
                try:
                    _log.dump_depth_artifacts(output, vid, d, dd.normal, dd.conf)
                finally:
                    if old is None:
                        os.environ.pop("OMVS_VERBOSE", None)
                    else:
                        os.environ["OMVS_VERBOSE"] = old
                print(f"visualizations -> {output}")
        else:
            print(f"{path}: unsupported extension {ext}")


if __name__ == "__main__":
    main()
