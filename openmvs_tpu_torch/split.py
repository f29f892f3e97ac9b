"""Scene splitting into sub-scene chunks (scale-out).

Equivalent of Scene::Split + ExportChunks (libs/MVS/Scene.cpp:1121-1443,
driven by DensifyPointCloud --sub-scene-area and MvsScalablePipeline.py):
recursively split the point cloud's bounding volume until each chunk holds at
most `max_points` points (the reference splits by octree cell area — point
count is the equivalent budget for dense clouds), assign each chunk the
images that observe its points (plus an overlap margin), and write per-chunk
.mvs scenes.

Each chunk is a scene of its own, densified by its own process (the
reference launches them by hand).

A copy of ``openmvs_tpu/split.py`` (host code in both packages).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from openmvs_tpu_torch.scene import Scene
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("split")


@dataclass
class Chunk:
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    point_idx: np.ndarray     # indices into scene.pointcloud
    image_idx: np.ndarray     # indices into scene.images


def split_scene(
    scene: Scene,
    max_points: int = 500_000,
    overlap: float = 0.1,
    min_image_points: int = 50,
    method: str = "median",
) -> List[Chunk]:
    """Split the cloud until every chunk holds <= max_points points; chunk
    boxes are enlarged by `overlap` (fraction) before image assignment so
    neighboring chunks share boundary context (the reference enlarges chunk
    OBBs the same way, Scene.cpp:1248).

    method="median": recursive median splits along the widest axis
    (balanced chunk sizes).  method="octree": TOctree::SplitVolume cells
    (utils/octree.py) — axis-aligned power-of-two cells exactly as the
    reference's Scene::Split octree produces."""
    pts = np.asarray(scene.pointcloud.points, np.float64)
    if len(pts) == 0:
        raise ValueError("no points to split")

    chunks: List[Chunk] = []

    if method == "octree":
        from openmvs_tpu_torch.utils.octree import Octree

        tree = Octree.build(pts)
        for lo, hi, idx in tree.split_volume(max_points):
            if len(idx):
                p = pts[idx]
                chunks.append(Chunk(p.min(axis=0), p.max(axis=0),
                                    np.sort(idx), np.zeros(0, np.int64)))
    else:
        def recurse(idx: np.ndarray):
            p = pts[idx]
            lo, hi = p.min(axis=0), p.max(axis=0)
            if len(idx) <= max_points:
                chunks.append(Chunk(lo, hi, idx, np.zeros(0, np.int64)))
                return
            axis = int(np.argmax(hi - lo))
            med = np.median(p[:, axis])
            left = p[:, axis] <= med
            if left.all() or not left.any():
                chunks.append(Chunk(lo, hi, idx, np.zeros(0, np.int64)))
                return
            recurse(idx[left])
            recurse(idx[~left])

        recurse(np.arange(len(pts)))

    # assign images: an image belongs to every chunk where it observes enough
    # points (within the enlarged box)
    views = scene.pointcloud.views
    id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
    # flat (point, image-index) incidence built ONCE: per-chunk counting is
    # then a masked bincount instead of a Python loop over every in-box
    # point's view list repeated per chunk
    v_counts = np.fromiter((len(v) for v in views), np.int64, len(views))
    flat_pt = np.repeat(np.arange(len(views), dtype=np.int64), v_counts)
    flat_vid = (np.concatenate(views).astype(np.int64)
                if v_counts.sum() else np.zeros(0, np.int64))
    max_id = int(flat_vid.max()) + 1 if len(flat_vid) else 1
    vid_to_img = np.full(max_id, -1, np.int64)
    for b, j in id_to_idx.items():
        if 0 <= b < max_id:
            vid_to_img[b] = j
    flat_img = vid_to_img[flat_vid]
    known = flat_img >= 0
    flat_pt, flat_img = flat_pt[known], flat_img[known]
    for ch in chunks:
        ext = (ch.bbox_max - ch.bbox_min) * overlap * 0.5
        lo, hi = ch.bbox_min - ext, ch.bbox_max + ext
        inside = np.all((pts >= lo) & (pts <= hi), axis=1)
        counts = np.bincount(flat_img[inside[flat_pt]],
                             minlength=len(scene.images))
        ch.image_idx = np.nonzero(counts >= min_image_points)[0]
        # keep the enlarged box for the export filter
        ch.bbox_min, ch.bbox_max = lo, hi
    log.info("split into %d chunks (max %d points)", len(chunks), max_points)
    return chunks


def export_chunks(scene: Scene, chunks: List[Chunk], out_folder: str,
                  prefix: str = "chunk") -> List[str]:
    """Write one .mvs per chunk containing its images and in-box points
    (Scene::ExportChunks role)."""
    os.makedirs(out_folder, exist_ok=True)
    paths = []
    pts = np.asarray(scene.pointcloud.points, np.float64)
    for ci, ch in enumerate(chunks):
        sub = Scene()
        sub.platforms = scene.platforms
        sub.transform = scene.transform
        keep_imgs = [scene.images[i] for i in ch.image_idx]
        if not keep_imgs:
            continue
        sub.images = keep_imgs
        inside = np.all((pts >= ch.bbox_min) & (pts <= ch.bbox_max), axis=1)
        sel = np.nonzero(inside)[0]
        keep_ids = {im.meta.id for im in keep_imgs}
        from openmvs_tpu_torch.scene import PointCloud

        views = []
        weights = []
        kept = []
        pcv = scene.pointcloud.views
        pcw = scene.pointcloud.weights
        has_w = len(pcw) == len(pcv)
        for i in sel:
            v = np.asarray([x for x in pcv[i] if int(x) in keep_ids], np.uint32)
            if len(v) < 2:
                continue
            kept.append(i)
            views.append(v)
            if has_w:
                wmap = {int(x): w for x, w in zip(pcv[i], pcw[i])}
                weights.append(np.asarray([wmap[int(x)] for x in v], np.float32))
        kept = np.asarray(kept, np.int64)
        sub.pointcloud = PointCloud(
            points=scene.pointcloud.points[kept],
            views=views,
            weights=weights if has_w else [],
            normals=(scene.pointcloud.normals[kept]
                     if scene.pointcloud.has_normals else np.zeros((0, 3), np.float32)),
            colors=(scene.pointcloud.colors[kept]
                    if scene.pointcloud.has_colors else np.zeros((0, 3), np.uint8)),
        )
        path = os.path.join(out_folder, f"{prefix}{ci:04d}.mvs")
        sub.save(path)
        paths.append(path)
        log.info("chunk %d: %d images, %d points -> %s",
                 ci, len(keep_imgs), len(kept), path)
    return paths
